"""The row mesh and its collectives — counterpart of
``spblas_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs a distributed op as one ``shard_map`` program over a
1-D device mesh.  The port runs it as an SPMD program with one process a
rank, as ``torchrun`` users run it: each rank calls the same function on
its own slice, and the collectives of the ``shard_map`` body become the
methods of :class:`RowMesh`, with JAX's semantics:

* :meth:`RowMesh.ppermute` — ``dist.batch_isend_irecv``; a rank that no
  pair sends to receives zeros, as ``jax.lax.ppermute`` gives; a pair
  from a rank to itself is a local copy (p = 1 sends nothing);
* :meth:`RowMesh.all_gather` — ``dist.all_gather_into_tensor`` of equal
  shards, stacked on a new leading axis;
* :meth:`RowMesh.psum` — ``dist.all_reduce``.

Backends.  NCCL carries CUDA tensors only, and refuses two ranks on one
GPU ("Duplicate GPU detected"), so one card holds an NCCL world of one.
gloo carries CPU tensors; it has no send/recv of CUDA tensors and only
part of its collectives take them.  A mesh over CUDA tensors on gloo
must therefore be built with ``stage_through_host=True``: every
collective then copies its tensor to the host and back, explicitly, and
counts the bytes in ``staged_bytes``.  Without it a CUDA tensor on gloo
(or a CPU tensor on NCCL) raises.  The mesh never picks or switches a
backend itself.

Streams.  Kernels launch on torch's current stream; a collective waits
for its work (``Work.wait()``) before it returns the buffer, so a kernel
that reads the result is ordered after it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from spblas_tpu_torch import types as _t

ROW_AXIS = "rows"

# backend -> the device types its collectives carry
_CARRIES = {"nccl": ("cuda",), "gloo": ("cpu",)}


@dataclasses.dataclass
class RowMesh:
    """One rank's view of a 1-D row mesh: its process ``group`` (None:
    the default group), ``rank`` and ``size`` in it, the ``device`` its
    tensors live on and the group's ``backend``.  ``staged_bytes``
    counts the bytes copied through the host by collectives on a mesh
    built to stage (``stage_through_host``)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    stage_through_host: bool = False
    staged_bytes: int = 0

    # -------------------------------------------------------------- #
    # the collectives
    # -------------------------------------------------------------- #

    def check_carry(self, device: torch.device) -> None:
        """Raise unless this mesh's collectives can carry a tensor on
        ``device``: as it is, or through the host when the mesh stages."""
        if self.stage_through_host:
            return
        if device.type not in _CARRIES.get(self.backend, (device.type,)):
            raise RuntimeError(
                f"a {self.backend} mesh cannot carry {device.type} "
                f"tensors; build the mesh with stage_through_host=True to "
                f"copy them through the host")

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective hands it over: a host copy on a
        staging mesh (counted), else ``t`` itself."""
        self.check_carry(t.device)
        t = t.contiguous()
        if self.stage_through_host:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to("cpu", copy=True)
        return t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        if self.stage_through_host:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device)
        return t

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def ppermute(self, t: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                 async_op: bool = False):
        """``jax.lax.ppermute``: for each (src, dst) pair, rank dst gets
        src's ``t``; a rank that no pair sends to gets zeros.  Each rank
        sends and receives at most once.  With ``async_op`` the transfer
        is posted and a :class:`Pending` returned, whose ``wait()`` gives
        the result (the ring SpMV overlaps it with a block product)."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        dst = [d for s, d in pairs if s == self.rank]
        src = [s for s, d in pairs if d == self.rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"ppermute pairs {pairs} send or receive "
                             f"twice at rank {self.rank}")
        self.check_carry(t.device)
        if src and src[0] == self.rank:        # a pair to itself: a copy
            out = t.clone()
            return Pending(lambda: out) if async_op else out
        ops = []
        if dst and dst[0] != self.rank:
            ops.append(dist.P2POp(dist.isend, self._out(t),
                                  self._peer(dst[0]), self.group))
        recv = torch.zeros_like(t, device="cpu" if self.stage_through_host
                                else t.device)
        if src:
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(src[0]),
                                  self.group))
        works = dist.batch_isend_irecv(ops) if ops else []

        def finish():
            for w in works:
                w.wait()
            return self._back(recv) if src else torch.zeros_like(t)

        return Pending(finish) if async_op else finish()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``jax.lax.all_gather``: every rank's ``t`` (all of one shape),
        stacked on a new leading axis of length ``size``."""
        send = self._out(t)
        out = send.new_empty((self.size,) + tuple(send.shape))
        if self.size == 1:
            out[0] = send
        else:
            _all_gather_flat(out.view(-1), send.view(-1), group=self.group)
        return self._back(out)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``jax.lax.psum``: the sum of every rank's ``t``."""
        buf = self._out(t).clone()
        if self.size > 1:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return self._back(buf)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (``t`` gives the shape and
        type elsewhere)."""
        buf = self._out(t).clone()
        if self.size > 1:
            dist.broadcast(buf, self._peer(src), group=self.group)
        return self._back(buf)

    def reduce_ints(self, values: Sequence[int], op: str = "max") -> list:
        """Host integers combined over the ranks (``"max"`` or
        ``"sum"``): how the host inspectors agree on a common geometry
        when each builds only its own piece."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        if self.size > 1:
            buf = self._out(t).clone()
            dist.all_reduce(buf, group=self.group,
                            op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM)
            t = buf
        return [int(v) for v in t.tolist()]


# torch 2.13 renames all_gather_into_tensor (kept there, deprecated)
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Pending:
    """A collective in flight: ``wait()`` finishes it and returns its
    result."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self) -> torch.Tensor:
        return self._finish()


def make_row_mesh(group: Optional[dist.ProcessGroup] = None, device=None,
                  stage_through_host: bool = False) -> RowMesh:
    """The calling rank's :class:`RowMesh` over ``group`` (default: the
    world) of an initialised process group.  ``device`` defaults to the
    card (``cuda:<current>``), and raises without one unless the caller
    names the CPU; ``stage_through_host`` is the caller's choice for a
    backend that cannot carry the device's tensors (gloo with CUDA)."""
    if not dist.is_initialized():
        raise RuntimeError("make_row_mesh: no process group; call "
                           "init_distributed first")
    dev = _t.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = RowMesh(group=group, rank=dist.get_rank(group),
                   size=dist.get_world_size(group), device=dev,
                   backend=str(dist.get_backend(group)),
                   stage_through_host=bool(stage_through_host))
    mesh.check_carry(dev)
    return mesh


def mesh_size(mesh: RowMesh, axis_name: str = ROW_AXIS) -> int:
    """Ranks along the row axis."""
    return int(mesh.size)


def check_mesh_matches(p: int, mesh: RowMesh, what: str,
                       axis_name: str = ROW_AXIS, rank=None) -> None:
    """Every distributed executor calls this: a plan or container
    partitioned for p ranks run on a mesh of another size would hand
    each rank a slice of the wrong partition.  ``rank``, where given, is
    the rank the plan was built for, which must be the caller's."""
    ms = mesh_size(mesh, axis_name)
    if int(p) != ms:
        raise ValueError(
            f"{what}: partitioned for p={int(p)} devices but the mesh "
            f"has {ms}; re-partition on this mesh")
    if rank is not None and int(rank) != mesh.rank:
        raise ValueError(f"{what}: built for rank {int(rank)}, run on "
                         f"rank {mesh.rank}")


def ring_perm(p: int, shift: int = 1):
    """Permutation pairs (src, dst) rotating blocks by ``shift`` rank
    positions: after the permute, rank d holds what rank d+shift held."""
    return [(i, (i - shift) % p) for i in range(p)]


def init_distributed(backend: str, rank: Optional[int] = None,
                     world_size: Optional[int] = None, store=None,
                     init_method: Optional[str] = None, device=None,
                     timeout: Optional[float] = None) -> None:
    """Start this process's rank of the default process group, once per
    process, on the ``backend`` the caller names (``"nccl"`` or
    ``"gloo"``; never picked here).  With no ``rank``, ``world_size``,
    ``store`` or ``init_method`` the group reads torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  For
    NCCL the rank's card (``device``, default ``cuda:LOCAL_RANK``) is
    bound as ``device_id``.  ``timeout`` (seconds) bounds every
    collective.  No-op when the group is already up."""
    if dist.is_initialized():
        return
    kw = {}
    if backend == "nccl":
        dev = torch.device(device) if device is not None else torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if rank is not None:
        kw["rank"] = int(rank)
    if world_size is not None:
        kw["world_size"] = int(world_size)
    dist.init_process_group(backend=backend, store=store,
                            init_method=init_method, **kw)

"""Distributed SpMV and SpMM over a row-partitioned mesh — counterpart of
``spblas_tpu/parallel/spmv.py``.

**Entry point on the card: the chooser.**  :func:`partition_spmv` picks
the per-rank execution for the pattern (the band halo pipeline on the
band kernel, per-rank ROUTE2 plans on the ROUTE2 kernel, or the generic
gather blocks) and :func:`dist_plan_spmv` runs it; :func:`partition_spmm`
and :func:`dist_plan_spmm` do the same for a dense B (band, per-rank
SELL, generic blocks).  The raw :func:`dist_spmv` runs the generic
gather·mul·``index_add`` blocks as torch ops, the same as the single-card
base path; it warns on the card, where the chooser's kernels are the
fast path, and is the CPU default.

Two strategies for the generic blocks, as per-rank code:

* ``ring`` — x stays block-partitioned; at step s every rank multiplies
  its rotation-scheduled block s by the x chunk it holds while the next
  chunk travels one hop around the ring (``ppermute``, posted before the
  block product and waited after it: the overlap JAX gets from XLA).
  The rotation schedule is JAX's, so the blocks are summed in the same
  order;
* ``allgather`` — gather x whole, then one pass over the blocks.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.parallel.dist_csr import DistCSR, rank_rows
from spblas_tpu_torch.parallel.mesh import (RowMesh, check_mesh_matches,
                                            ring_perm)


def _block_contrib(values, rowloc, colloc, chunk, mloc):
    """One block's y contribution: gather·mul, then ``index_add`` into
    mloc + 1 rows (the sentinel row mloc takes the padding) — (mloc,) or
    (mloc, k) for an SpMM chunk (nloc, k)."""
    g = chunk.index_select(0, colloc)
    contrib = values[:, None] * g if chunk.dim() == 2 else values * g
    out = contrib.new_zeros((mloc + 1,) + tuple(chunk.shape[1:]))
    return out.index_add_(0, rowloc, contrib)[:mloc]


def _result_dtype(a: DistCSR, x: torch.Tensor):
    return torch.promote_types(a.dtype, x.dtype)


def _ring(a: DistCSR, x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    p, mloc = a.p, a.mloc
    dt = _result_dtype(a, x)
    acc = x.new_zeros((mloc,) + tuple(x.shape[1:]), dtype=dt)
    values, rowloc, colloc = a.values.to(dt), a.rowloc.long(), \
        a.colloc.long()
    chunk = x.to(dt)
    for s in range(p):
        # block s is pre-scheduled for the chunk held at step s; the next
        # chunk is in flight while it is multiplied
        nxt = mesh.ppermute(chunk, ring_perm(p), async_op=True) \
            if s + 1 < p else None
        acc = acc + _block_contrib(values[s], rowloc[s], colloc[s], chunk,
                                   mloc)
        if nxt is not None:
            chunk = nxt.wait()
    return acc


def _allgather(a: DistCSR, x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    p, mloc, d = a.p, a.mloc, mesh.rank
    dt = _result_dtype(a, x)
    xg = mesh.all_gather(x.to(dt))            # (p, nloc[, k])
    acc = x.new_zeros((mloc,) + tuple(x.shape[1:]), dtype=dt)
    values, rowloc, colloc = a.values.to(dt), a.rowloc.long(), \
        a.colloc.long()
    for s in range(p):
        # block s holds the columns of rank (d + s) % p
        acc = acc + _block_contrib(values[s], rowloc[s], colloc[s],
                                   xg[(d + s) % p], mloc)
    return acc


def _dist_apply(a: DistCSR, x: torch.Tensor, mesh: RowMesh, strategy):
    check_mesh_matches(a.p, mesh, "dist_spmv/dist_spmm", rank=a.rank)
    if x.shape[0] != a.nloc:
        raise ValueError(
            f"operand leading dim {x.shape[0]} != local n {a.nloc}; "
            "use partition_vector")
    if strategy == "ring":
        return _ring(a, x, mesh)
    if strategy == "allgather":
        return _allgather(a, x, mesh)
    raise ValueError(f"unknown strategy {strategy!r}")


def _warn_if_cuda(name: str, mesh: RowMesh) -> None:
    if mesh.device.type == "cuda":
        warnings.warn(
            f"{name}: the generic gather blocks run as torch ops; use "
            "partition_spmv(a, mesh) + dist_plan_spmv for the per-rank "
            "band and ROUTE2 kernels", stacklevel=3)


def dist_spmv(a: DistCSR, x: torch.Tensor, mesh: RowMesh,
              strategy: str = "ring") -> torch.Tensor:
    """y = A @ x, A row-partitioned, x this rank's (nloc,) chunk; returns
    this rank's (mloc,) piece of y (the generic gather blocks)."""
    _warn_if_cuda("dist_spmv", mesh)
    return _dist_apply(a, x, mesh, strategy)


def dist_spmm(a: DistCSR, b: torch.Tensor, mesh: RowMesh,
              strategy: str = "ring") -> torch.Tensor:
    """C = A @ B for dense B, this rank's (nloc, k) rows; returns its
    (mloc, k) rows of C (the generic gather blocks)."""
    _warn_if_cuda("dist_spmm", mesh)
    return _dist_apply(a, b, mesh, strategy)


# ------------------------------------------------------------------ #
# the choosers
# ------------------------------------------------------------------ #

def _banded_enough(a) -> bool:
    """The band gate of both choosers: band panels pay 2*bw+1 slots a
    row, worth it when the band is mostly dense."""
    m, n = a.shape
    if m != n:
        return False
    nnz = int(a.nnz)
    if nnz == 0:
        return False
    colind = _t.to_numpy(a.colind[:nnz]).astype(np.int64)
    rowptr = np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), nnz)
    rows = native.expand_rowptr(m, nnz, rowptr)
    bw = int(np.abs(colind - rows).max())
    band_fill = nnz / max(m * (2 * bw + 1), 1)
    return bw <= 512 and band_fill >= 0.25


def _choose(a, mesh: RowMesh, unstructured: str) -> str:
    """The chooser's kind on this mesh: the generic blocks off the card
    and for float64 or complex values (the band, ROUTE2 and SELL paths
    compute in f32), else the band or ``unstructured``."""
    if mesh.device.type != "cuda":
        return "csr"
    if a.dtype.is_complex or a.dtype == torch.float64:
        return "csr"
    return "band" if _banded_enough(a) else unstructured


def partition_spmv(a, mesh: RowMesh, prefer: str | None = None):
    """Distributed matvec chooser: ``(kind, plan)``, kind ``"band"``
    (the halo band pipeline), ``"route"`` (per-rank ROUTE2 plans) or
    ``"csr"`` (generic gather blocks); ``prefer`` forces a kind.  Run it
    with :func:`dist_plan_spmv`; partition x with
    :func:`partition_spmv_vector`."""
    a = to_csr(a)
    prefer = prefer or _choose(a, mesh, "route")
    if prefer == "band":
        from spblas_tpu_torch.parallel.banded import partition_band
        return "band", partition_band(a, mesh)
    if prefer == "route":
        from spblas_tpu_torch.parallel.route_spmv import partition_route
        return "route", partition_route(a, mesh)
    if prefer == "csr":
        from spblas_tpu_torch.parallel.dist_csr import partition_csr
        return "csr", partition_csr(a, mesh)
    raise ValueError(f"unknown kind {prefer!r}")


def _operand(kind_plan, x, mesh: RowMesh) -> torch.Tensor:
    kind, plan = kind_plan
    if kind == "band":
        from spblas_tpu_torch.parallel.banded import partition_band_vector
        return partition_band_vector(x, plan, mesh)
    return rank_rows(x, plan.p * plan.nloc, plan.nloc, mesh.rank,
                     mesh.device)


def partition_spmv_vector(kind_plan, x, mesh: RowMesh) -> torch.Tensor:
    """This rank's piece of the global x in the chosen kind's layout."""
    return _operand(kind_plan, x, mesh)


def dist_plan_spmv(kind_plan, x, mesh: RowMesh) -> torch.Tensor:
    """Run the matvec :func:`partition_spmv` picked; returns this rank's
    piece of y (rows past m on the last rank are padding)."""
    kind, plan = kind_plan
    if kind == "band":
        from spblas_tpu_torch.parallel.banded import dist_band_spmv
        return dist_band_spmv(plan, x, mesh)
    if kind == "route":
        from spblas_tpu_torch.parallel.route_spmv import dist_route_spmv
        return dist_route_spmv(plan, x, mesh)
    return _dist_apply(plan, x, mesh, "ring")


def partition_spmm(a, mesh: RowMesh, prefer: str | None = None):
    """Distributed matmul chooser: ``(kind, plan)``, kind ``"band"``,
    ``"sell"`` (per-rank SELL row gathers) or ``"csr"``.  Run with
    :func:`dist_plan_spmm`; partition B with
    :func:`partition_spmm_operand`."""
    a = to_csr(a)
    prefer = prefer or _choose(a, mesh, "sell")
    if prefer == "band":
        from spblas_tpu_torch.parallel.banded import partition_band
        return "band", partition_band(a, mesh)
    if prefer == "sell":
        from spblas_tpu_torch.parallel.route_spmv import partition_sell
        return "sell", partition_sell(a, mesh)
    if prefer == "csr":
        from spblas_tpu_torch.parallel.dist_csr import partition_csr
        return "csr", partition_csr(a, mesh)
    raise ValueError(f"unknown kind {prefer!r}")


def partition_spmm_operand(kind_plan, b, mesh: RowMesh) -> torch.Tensor:
    """This rank's rows of the dense B in the chosen kind's layout."""
    return _operand(kind_plan, b, mesh)


def dist_plan_spmm(kind_plan, b, mesh: RowMesh) -> torch.Tensor:
    """Run the matmul :func:`partition_spmm` picked; returns this rank's
    rows of C."""
    kind, plan = kind_plan
    if kind == "band":
        from spblas_tpu_torch.parallel.banded import dist_band_spmm
        return dist_band_spmm(plan, b, mesh)
    if kind == "sell":
        from spblas_tpu_torch.parallel.route_spmv import dist_sell_spmm
        return dist_sell_spmm(plan, b, mesh)
    return _dist_apply(plan, b, mesh, "ring")

"""A local world of n ranks, one process each, for the tests, the dry run
and ``chip_smoke.py``.

    with World(4, backend="gloo", device="cpu") as world:
        per_rank = world.run(fn, *args, timeout=60)

:class:`World` starts its ranks with the ``spawn`` start method (never
``fork``: the parent may have CUDA up), each joining one process group
through a ``FileStore`` in a temporary directory (no TCP port), with a
``timeout`` on every collective.  ``run`` hands every rank the same
task, ``fn(mesh, *args)``, and returns the results in rank order.  A
rank that raises, dies or passes the call's wall-clock limit fails the
call: every rank is killed and ``run`` raises.  ``fn`` must be a
module-level function of a module that the ranks can import (the ranks
import the port and that module, nothing else of the caller's).  Every
rank destroys its process group when the world closes.

Build the kernels before starting a world on the card
(``_build.build_all()``): every rank then loads the same libraries.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import multiprocessing as mp


class WorldError(RuntimeError):
    """A rank of a :class:`World` failed, died or hung."""


def _rank_device(rank: int, device):
    """The rank's device: ``device`` as named, else the card (one card a
    rank, round robin over the host's cards).  Raises through
    ``resolve_device`` when no device was named and there is no card."""
    import torch
    from spblas_tpu_torch import types as _t

    dev = _t.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, n: int, store_path: str, backend: str, device,
               stage: bool, threads: Optional[int], pg_timeout: float,
               tasks, results, parent: int) -> None:
    import torch
    import torch.distributed as dist
    from spblas_tpu_torch.parallel.mesh import make_row_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(rank, device)
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            if backend == "nccl":
                kw["device_id"] = dev
        dist.init_process_group(
            backend=backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=pg_timeout),
            **kw)
        mesh = make_row_mesh(device=dev, stage_through_host=stage)
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ready", None))
    try:
        while True:
            try:
                task = tasks.get(timeout=5.0)
            except queue.Empty:
                if os.getppid() != parent:      # the world's owner died
                    break
                continue
            if task is None:
                break
            fn, args = task
            try:
                out = ("ok", fn(mesh, *args))
            except BaseException:
                out = ("error", traceback.format_exc())
            results.put((rank,) + out)
    finally:
        dist.destroy_process_group()


class World:
    """n ranks of one process group on this host (see the module
    docstring).  ``device``: each rank's device; by default the card
    (rank r on ``cuda:r`` modulo the host's cards), raising when there is
    none; ``"cpu"`` runs the ranks on the CPU, ``"cuda:0"`` puts them all
    on one card.  ``stage_through_host``:
    the meshes' choice for gloo over CUDA tensors; ``threads``: torch's
    thread count in each rank; ``timeout``: each call's wall-clock limit
    in seconds, and every collective's."""

    def __init__(self, n: int, backend: str = "gloo", device=None,
                 stage_through_host: bool = False,
                 threads: Optional[int] = None, timeout: float = 60.0,
                 start_timeout: float = 120.0):
        self.n, self.backend, self.device = int(n), backend, device
        self.stage, self.threads = bool(stage_through_host), threads
        self.timeout, self.start_timeout = float(timeout), start_timeout
        self._procs = []
        self._dir = None

    # ------------------------------------------------------------ #

    def start(self) -> "World":
        _rank_device(0, self.device)        # no card and none named: raise
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="spblas_world_")
        store = os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.n, store, self.backend, self.device, self.stage,
                  self.threads, self.timeout, self._tasks[r],
                  self._results, os.getpid())) for r in range(self.n)]
        for p in self._procs:
            p.start()
        self._collect(self.start_timeout, "start")
        return self

    def _collect(self, limit: float, what: str) -> list:
        out = [None] * self.n
        got = 0
        deadline = time.monotonic() + limit
        while got < self.n:
            left = deadline - time.monotonic()
            if left <= 0:
                self.kill()
                raise WorldError(f"{what}: {self.n - got} of {self.n} ranks "
                                 f"gave no result within {limit:.0f} s")
            try:
                rank, status, value = self._results.get(
                    timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and out[r] is None]
                if dead:
                    self.kill()
                    raise WorldError(f"{what}: rank(s) {dead} died")
                continue
            if status == "error":
                self.kill()
                raise WorldError(f"{what}: rank {rank} failed:\n{value}")
            out[rank] = value
            got += 1
        return out

    def run(self, fn, *args, timeout: Optional[float] = None) -> list:
        """``fn(mesh, *args)`` on every rank; the results in rank order.
        Raises :class:`WorldError` (after killing every rank) when a rank
        fails or the call passes ``timeout`` seconds."""
        if not self.alive:
            raise WorldError("the world is not running")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(timeout or self.timeout,
                             getattr(fn, "__name__", "task"))

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []
        self._cleanup()

    def close(self) -> None:
        """Stop every rank (each destroys its process group) and remove
        the store's directory."""
        if not self._procs:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
        self.kill()

    def _cleanup(self) -> None:
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "World":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def run_world(n: int, fn, *args, backend: str = "gloo", device=None,
              stage_through_host: bool = False,
              threads: Optional[int] = None, timeout: float = 60.0) -> list:
    """Start a world of ``n`` ranks, run ``fn(mesh, *args)`` on each
    once, stop it; the results in rank order."""
    with World(n, backend=backend, device=device,
               stage_through_host=stage_through_host, threads=threads,
               timeout=timeout) as world:
        return world.run(fn, *args, timeout=timeout)

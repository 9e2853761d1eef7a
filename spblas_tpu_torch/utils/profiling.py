"""Roofline accounting and timing — counterpart of
``spblas_tpu/utils/profiling.py``.

Every op gets a traffic and flop model (:class:`OpCost`), so a measured
time converts to a share of the card's memory roofline; the inspection
phases of the SpGEMM engine build and of ``triangular_solve_inspect``
are recorded by name (:func:`record_phase`); and two timing helpers
measure a chain of steps, or one call, with CUDA events on the card and
``perf_counter`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

# device memory rate (GB/s) by a fragment of torch.cuda.get_device_name,
# most specific first (NVIDIA's data sheets; chip_smoke.py's _PARTS)
HBM_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100 NVL", 3900.0),
    ("H100", 3350.0),
    ("H200", 4800.0),
)


def device_hbm_gbps(device=None) -> float:
    """The memory rate of the card ``device`` (default: the current one),
    from :data:`HBM_GBPS`; raises for a card the table does not know, or
    without a card."""
    name = torch.cuda.get_device_name(device)
    for frag, bw in HBM_GBPS:
        if frag in name:
            return bw
    raise ValueError(f"no memory rate known for {name!r}")


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Minimal-traffic model of one op execution."""

    flops: int
    bytes: int
    label: str = ""

    def roofline_seconds(self, gbps: Optional[float] = None) -> float:
        gbps = gbps or device_hbm_gbps()
        return self.bytes / (gbps * 1e9)

    def fraction(self, measured_seconds: float,
                 gbps: Optional[float] = None) -> float:
        return self.roofline_seconds(gbps) / max(measured_seconds, 1e-12)


def spmv_cost(nnz: int, m: int, n: int, val_bytes=4, idx_bytes=4) -> OpCost:
    """CSR SpMV traffic: values + colind (+ amortized rowptr) + x + y."""
    return OpCost(flops=2 * nnz,
                  bytes=nnz * (val_bytes + idx_bytes) + (m + 1) * idx_bytes
                  + (n + m) * val_bytes,
                  label="spmv")


def dia_spmv_cost(nnz: int, m: int, n: int, ndiag: int,
                  val_bytes=4) -> OpCost:
    """DIA SpMV: dense diagonals + x + y, zero index traffic."""
    return OpCost(flops=2 * nnz,
                  bytes=ndiag * m * val_bytes + (n + m) * val_bytes,
                  label="dia_spmv")


def spmm_cost(nnz: int, m: int, n: int, k: int, val_bytes=4,
              idx_bytes=4) -> OpCost:
    return OpCost(flops=2 * nnz * k,
                  bytes=nnz * (val_bytes + idx_bytes)
                  + (n + m) * k * val_bytes,
                  label="spmm")


def spgemm_cost(flops: int, nnz_a: int, nnz_b: int, nnz_c: int,
                val_bytes=4, idx_bytes=4) -> OpCost:
    b = (nnz_a + nnz_b + nnz_c) * (val_bytes + idx_bytes)
    return OpCost(flops=2 * flops, bytes=b, label="spgemm")


# the most recent inspection breakdown of each op (host seconds by
# phase): the SpGEMM engine build (expansion_s, pack_s, build_s,
# upload_wait_s) and triangular_solve_inspect (pull_s, schedule_s,
# ragged_pack_s)
_inspect_phases: dict = {}


def record_phase(op: str, name: str, seconds: float) -> None:
    _inspect_phases.setdefault(op, {})[name] = round(seconds, 4)


def inspect_phases(op: str) -> dict:
    """Snapshot of the most recent inspection breakdown for ``op``."""
    return dict(_inspect_phases.get(op, {}))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def _perturb(x, r):
    if isinstance(x, torch.Tensor):
        return x + torch.tensor(1e-3 * r, dtype=x.dtype, device=x.device)
    return type(x)(_perturb(v, r) for v in x)


def _timer(on_card: bool, fn: Callable, out_of):
    """Seconds of ``fn()``: CUDA events around it and a sync on the
    value ``out_of`` picks from its result, or perf_counter on the
    CPU."""
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        first = out_of(out)
        end.record()
        float(first.real)
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    float(out_of(fn()).real)
    return time.perf_counter() - t0


def time_chained(step: Callable, x0, iters: int = 50, reps: int = 3
                 ) -> float:
    """Best time per ``step`` application over a chain of ``iters``
    steps, each fed the last one's result: distinct inputs each
    repetition (x0 perturbed), and the chain ends on a read of the last
    result's first element, a value every step feeds.  CUDA events time
    the chain on the card, perf_counter on the CPU."""

    def chain(x):
        for _ in range(iters):
            x = step(x)
        return x

    def first(out):
        return _leaves(out)[0].reshape(-1)[0]

    on_card = any(t.is_cuda for t in _leaves(x0))
    float(first(chain(x0)).real)
    best = float("inf")
    for r in range(reps):
        xr = _perturb(x0, r + 1)
        best = min(best, _timer(on_card, lambda: chain(xr), first))
    return best / iters


def time_fn(fn: Callable, *args, reps: int = 5) -> float:
    """Best time of one call (for ops too stateful to chain), synced on
    the first element of its first output tensor."""

    def first(out):
        return _leaves(out)[0].reshape(-1)[0]

    on_card = any(t.is_cuda for t in _leaves(args))
    float(first(fn(*args)).real)
    return min(_timer(on_card, lambda: fn(*args), first)
               for _ in range(reps))

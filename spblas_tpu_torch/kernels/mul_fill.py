"""Slot fill: the fused SpGEMM numeric as a gather and a segmented sum
over the slot-sorted expansion stream — the Hopper design of the paned
fill of ``kernels/route_mul_paned.py`` and of the ROUTE v1 numeric of
``kernels/route_mul_kernel.py``.

The TPU kernel ``spblas_tpu/kernels/route_mul_paned.py::
_paned_mul_kernel`` computes the slot sums of ``A_arr[sa] * B_arr[sb]``
by routing every product through (8, 128) tiles, since the TPU has no
hardware gather.  Hopper has one, so the port keeps the function and
reads the stream the tiles were packed from: a :class:`SlotStream`
(``sa``, ``sb`` and each slot's first product, ``run_start``), built on
the host beside the ROUTE plan (whose arrays stay bit-equal to JAX's);
``route_mul_kernel.py::_mul_kernel`` is replaced the same way.

On a CUDA tensor :func:`mul_fill` launches the hand-written kernel
``csrc/mul_fill.cu`` once over every slot (one owner a slot, no atomics,
the same bits on every run); on a CPU tensor it runs
:func:`mul_fill_reference`, the plain segmented sum.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t


@dataclasses.dataclass(frozen=True)
class SlotStream:
    """The slot-sorted expansion stream of a SpGEMM, on one device: the
    products of slot s are ``A_arr[sa[e]] * B_arr[sb[e]]`` for e in
    ``[run_start[s], run_start[s + 1])``."""

    sa: torch.Tensor          # (E,) int32  A entry of each product
    sb: torch.Tensor          # (E,) int32  B entry of each product
    run_start: torch.Tensor   # (nslots + 1,) int32  first product a slot
    a_len: int                # entries of A_arr every sa indexes into
    b_len: int                # entries of B_arr every sb indexes into
    longest: int              # products of the longest run (picks the
                              # kernel with or without its middle tier)

    @property
    def nslots(self) -> int:
        return int(self.run_start.shape[0]) - 1


def build_slot_stream(slots, src_a, src_b, a_len: int, b_len: int,
                      device) -> SlotStream:
    """The :class:`SlotStream` of a slot-sorted (nondecreasing ``slots``)
    expansion stream, placed on ``device``; slots without products (none
    in a product's own stream) get empty runs."""
    slots = np.asarray(slots, np.int64)
    if len(slots) >= 2**31:
        raise ValueError(f"{len(slots)} products: the stream's int32 "
                         "offsets hold fewer than 2^31")
    if len(slots) and (np.diff(slots) < 0).any():
        raise ValueError("slots must be nondecreasing")
    nslots = int(slots[-1]) + 1 if len(slots) else 0
    run_start = np.zeros(nslots + 1, np.int64)
    counts = np.bincount(slots, minlength=nslots)
    np.cumsum(counts, out=run_start[1:])

    def put(arr):
        return torch.from_numpy(np.asarray(arr).astype(np.int32)).to(device)

    return SlotStream(sa=put(src_a), sb=put(src_b),
                      run_start=put(run_start), a_len=int(a_len),
                      b_len=int(b_len),
                      longest=int(counts.max()) if nslots else 0)


def plan_stream(plan, builder: str) -> SlotStream:
    """The expansion stream a mul plan keeps for the CUDA fill; raises on
    a plan carried from JAX, which has none (``builder``: the function
    that builds a plan with one)."""
    if plan.expansion is None:
        raise ValueError("the plan carries no expansion stream (a plan "
                         f"carried from JAX): build it with {builder} to "
                         "fill on CUDA")
    return plan.expansion


def mul_fill_reference(stream: SlotStream, a_arr: torch.Tensor,
                       b_arr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the products, then one
    ``index_add_`` of each into its slot; (capacity,) f32."""
    v = a_arr[stream.sa.long()] * b_arr[stream.sb.long()]
    seg = torch.repeat_interleave(
        torch.arange(stream.nslots, device=v.device),
        stream.run_start.diff().long(), output_size=v.shape[0])
    out = torch.zeros(capacity, dtype=torch.float32, device=v.device)
    return out.index_add_(0, seg, v)


def _check_operands(stream: SlotStream, a_arr: torch.Tensor,
                    b_arr: torch.Tensor, capacity: int) -> None:
    ints = (stream.sa, stream.sb, stream.run_start)
    if any(t.device != a_arr.device for t in ints + (b_arr,)):
        raise ValueError(f"stream on {stream.sa.device}, values on "
                         f"{a_arr.device} and {b_arr.device}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("stream arrays must be int32")
    if a_arr.dtype != torch.float32 or b_arr.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {a_arr.dtype} and "
                        f"{b_arr.dtype}")
    if a_arr.dim() != 1 or b_arr.dim() != 1 \
            or a_arr.shape[0] < stream.a_len \
            or b_arr.shape[0] < stream.b_len \
            or stream.sb.shape != stream.sa.shape \
            or stream.run_start.dim() != 1 or capacity < stream.nslots:
        raise ValueError(f"bad shapes: a_arr {tuple(a_arr.shape)} (needs "
                         f"{stream.a_len}), b_arr {tuple(b_arr.shape)} "
                         f"(needs {stream.b_len}), {stream.nslots} slots "
                         f"for capacity {capacity}")
    if not all(t.is_contiguous() for t in ints + (a_arr, b_arr)):
        raise ValueError("stream arrays and values must be contiguous")


# (run_start, sa, sb, A, B, c, nslots, capacity, longest, stream) of
# mul_fill_f32
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 2 + (
    ctypes.c_int, ctypes.c_void_p)


def mul_fill(stream: SlotStream, a_arr: torch.Tensor, b_arr: torch.Tensor,
             capacity: int) -> torch.Tensor:
    """c (capacity,) f32 = the slot sums of ``a_arr[sa] * b_arr[sb]``,
    zero past the stream's slots.  CUDA tensors launch ``mul_fill.cu``
    once, on the current stream; CPU tensors take
    :func:`mul_fill_reference`."""
    capacity = int(capacity)
    _check_operands(stream, a_arr, b_arr, capacity)
    if not _t.on_cuda(a_arr):
        return mul_fill_reference(stream, a_arr, b_arr, capacity)
    c = torch.empty(capacity, dtype=torch.float32, device=a_arr.device)
    fn = _build.function("mul_fill", "mul_fill_f32", _ARGTYPES)
    _build.check(fn(
        stream.run_start.data_ptr(), stream.sa.data_ptr(),
        stream.sb.data_ptr(), a_arr.data_ptr(), b_arr.data_ptr(),
        c.data_ptr(), stream.nslots, capacity, stream.longest,
        torch.cuda.current_stream(a_arr.device).cuda_stream), "mul_fill")
    if capacity:
        mul_fill.launches += 1
    return c


mul_fill.launches = 0

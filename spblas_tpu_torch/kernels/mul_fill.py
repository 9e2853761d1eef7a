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
``csrc/mul_fill.cu`` once over every slot (one writer a slot, the same
bits on every run); on a CPU tensor it runs :func:`mul_fill_reference`,
the plain segmented sum.  Runs longer than ``HUB_MIN`` products (hub
slots) are cut, when the stream is built, into segments of
``HUB_SEG_LEN`` products (:func:`hub_segments`): the kernel sums each
segment in a block of its own and adds a hub's partials in segment
order, as :func:`hub_fill_reference`, the plain model of the cut, does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t

# runs longer than this (csrc/mul_fill.cu's kMid) are hub runs, cut into
# segments of HUB_SEG_LEN products, each summed by a block of its own (the
# kernel's hub tier); shorter runs stay with their slot's block
HUB_MIN = 1024
HUB_SEG_LEN = 1024


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
    longest: int              # products of the longest run
    longest_kept: int         # ... of the longest run below the hub cut
                              # (picks the kernel with or without its
                              # middle and block tiers)
    # the hub tier (None: the stream has no run past HUB_MIN): one row of
    # (lo, hi, hub, slot, first segment of the hub, segments of the hub,
    # 0, 0) a segment, in stream order (:func:`hub_segments`); an arrival
    # counter a hub, 0 between fills; a partial a segment.  The kernel
    # writes the last two, so two fills over one stream must not run at
    # once on two CUDA streams.
    hub_seg: Optional[torch.Tensor] = None    # (nseg, 8) int32
    hub_count: Optional[torch.Tensor] = None  # (hubs,) int32
    hub_part: Optional[torch.Tensor] = None   # (nseg,) f32

    @property
    def nslots(self) -> int:
        return int(self.run_start.shape[0]) - 1

    @property
    def nseg(self) -> int:
        return 0 if self.hub_seg is None else int(self.hub_seg.shape[0])


def hub_segments(run_start, seg_len: int) -> np.ndarray:
    """The hub tier's segment table of a stream's ``run_start``: every
    run longer than ``HUB_MIN`` products cut into segments of ``seg_len``
    (the last one shorter), runs and segments in stream order; (nseg, 8)
    int32 rows (lo, hi, hub, slot, first, count, 0, 0), ``first`` the
    hub's first segment and ``count`` its segments."""
    if seg_len < 1:
        raise ValueError(f"hub segment length {seg_len} below 1")
    run_start = np.asarray(run_start, np.int64)
    lens = np.diff(run_start)
    hubs = np.flatnonzero(lens > HUB_MIN)
    count = -(-lens[hubs] // seg_len)
    first = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int64)
    rows = np.zeros((int(count.sum()), 8), np.int64)
    hub = np.repeat(np.arange(len(hubs)), count)
    j = np.arange(len(rows)) - first[hub]
    rows[:, 0] = run_start[hubs][hub] + j * seg_len
    rows[:, 1] = np.minimum(rows[:, 0] + seg_len, run_start[hubs + 1][hub])
    rows[:, 2] = hub
    rows[:, 3] = hubs[hub]
    rows[:, 4] = first[hub]
    rows[:, 5] = count[hub]
    return rows.astype(np.int32)


def build_slot_stream(slots, src_a, src_b, a_len: int, b_len: int,
                      device) -> SlotStream:
    """The :class:`SlotStream` of a slot-sorted (nondecreasing ``slots``)
    expansion stream, placed on ``device``; slots without products (none
    in a product's own stream) get empty runs, and runs longer than
    ``HUB_MIN`` products the hub tier's segments of ``HUB_SEG_LEN``."""
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

    seg = hub_segments(run_start, HUB_SEG_LEN)
    hubs = int(seg[-1, 2]) + 1 if len(seg) else 0
    kept = counts[counts <= HUB_MIN]
    return SlotStream(sa=put(src_a), sb=put(src_b),
                      run_start=put(run_start), a_len=int(a_len),
                      b_len=int(b_len),
                      longest=int(counts.max()) if nslots else 0,
                      longest_kept=int(kept.max()) if len(kept) else 0,
                      hub_seg=put(seg) if hubs else None,
                      hub_count=torch.zeros(hubs, dtype=torch.int32,
                                            device=device) if hubs else None,
                      hub_part=torch.zeros(len(seg), dtype=torch.float32,
                                           device=device) if hubs else None)


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


def hub_fill_reference(stream: SlotStream, a_arr: torch.Tensor,
                       b_arr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Plain model of the kernel's hub cut: :func:`mul_fill_reference` for
    every slot but the hub slots, whose value is the sum, in segment
    order, of each segment's sum over its products; (capacity,) f32."""
    out = mul_fill_reference(stream, a_arr, b_arr, capacity)
    if stream.hub_seg is None:
        return out
    v = a_arr[stream.sa.long()] * b_arr[stream.sb.long()]
    total = {}
    for lo, hi, _, slot, *_ in stream.hub_seg.tolist():
        total[slot] = total.get(slot, 0.0) + v[lo:hi].sum()
    for slot, t in total.items():
        out[slot] = t
    return out


def _check_operands(stream: SlotStream, a_arr: torch.Tensor,
                    b_arr: torch.Tensor, capacity: int) -> None:
    ints = (stream.sa, stream.sb, stream.run_start)
    if stream.hub_seg is not None:
        ints += (stream.hub_seg, stream.hub_count)
        if stream.hub_part.dtype != torch.float32 \
                or stream.hub_part.device != a_arr.device \
                or stream.hub_seg.shape != (stream.hub_part.shape[0], 8):
            raise ValueError("bad hub tier: segments "
                             f"{tuple(stream.hub_seg.shape)}, partials "
                             f"{tuple(stream.hub_part.shape)} "
                             f"{stream.hub_part.dtype}")
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


# (run_start, sa, sb, A, B, c, nslots, capacity, longest_kept, hub_seg,
#  hub_count, hub_part, nseg, stream) of mul_fill_f32
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 2 + (
    ctypes.c_int,) + (ctypes.c_void_p,) * 3 + (ctypes.c_int,
                                               ctypes.c_void_p)


def mul_fill(stream: SlotStream, a_arr: torch.Tensor, b_arr: torch.Tensor,
             capacity: int) -> torch.Tensor:
    """c (capacity,) f32 = the slot sums of ``a_arr[sa] * b_arr[sb]``,
    zero past the stream's slots.  CUDA tensors launch ``mul_fill.cu``
    once, on the current stream (a stream with hub segments also writes
    its counters and partials: one fill over it at a time); CPU tensors
    take :func:`mul_fill_reference`."""
    capacity = int(capacity)
    _check_operands(stream, a_arr, b_arr, capacity)
    if not _t.on_cuda(a_arr):
        return mul_fill_reference(stream, a_arr, b_arr, capacity)
    c = torch.empty(capacity, dtype=torch.float32, device=a_arr.device)
    fn = _build.function("mul_fill", "mul_fill_f32", _ARGTYPES)
    hub = ((stream.hub_seg.data_ptr(), stream.hub_count.data_ptr(),
            stream.hub_part.data_ptr()) if stream.nseg else (None,) * 3)
    _build.check(fn(
        stream.run_start.data_ptr(), stream.sa.data_ptr(),
        stream.sb.data_ptr(), a_arr.data_ptr(), b_arr.data_ptr(),
        c.data_ptr(), stream.nslots, capacity, stream.longest_kept, *hub,
        stream.nseg, torch.cuda.current_stream(a_arr.device).cuda_stream),
        "mul_fill")
    if capacity:
        mul_fill.launches += 1
    return c


mul_fill.launches = 0

"""ROUTE v1 SpGEMM numeric executor — counterpart of
``spblas_tpu/kernels/route_mul_kernel.py`` (``route_mul``).

The TPU kernel ``route_mul_kernel.py::_mul_kernel`` routes every product
of the slot-sorted expansion stream through (8, 128) chunks of int32
tiles (12 KB a chunk), since the TPU has no hardware gather, and sums
overlapping out windows in its sequential grid.  Hopper gathers in
hardware: on a CUDA tensor :func:`route_mul` is one launch of the slot
fill ``csrc/mul_fill.cu`` (``kernels/mul_fill.py``) over the stream the
tiles were packed from (``RouteMulPlan.expansion``): one owner a slot,
no atomics, the same bits on every run, no pane padding and no zeroed
out pane.  A plan carried from JAX has no stream and is refused there.

On a CPU tensor :func:`route_mul` walks the tiles:
:func:`route_mul_padded` over the packed panes runs
:func:`route_mul_reference`, the plain PyTorch version of the TPU
kernel's computation, which the CPU tests hold to JAX's kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.mul_fill import mul_fill, plan_stream
from spblas_tpu_torch.kernels.route_mul import (
    LANES, SUBS, T1_LB, T1_OB, T1_Q1, T1_Q2, T1_Q3, T2_LA, T2_OA, T2_S7,
    T3_DIST, T3_P1, T3_P2, T3_P3, T3_VA, RouteMulPlan)

# chunks per step of the plain version
_REF_BLOCK = 4096


def _field(t: torch.Tensor, f) -> torch.Tensor:
    return (t >> f[0]) & f[1]


def pad_pane(values: torch.Tensor, rows: int) -> torch.Tensor:
    """A value array as the kernel reads it: the flat f32 pane of
    ``rows`` rows of 128, zeros past the values."""
    return F.pad(values.float(), (0, rows * LANES - values.shape[0])
                 ).contiguous()


def _gather(pane, base, octant, lane, g: int) -> torch.Tensor:
    """u[k, i, l] = pane[base[k] + 8*octant + i, lane] for octant < g;
    rows past the pane read 0."""
    k = octant.shape[0]
    ii = torch.arange(SUBS, device=octant.device).view(1, SUBS, 1)
    row = base.long().view(k, 1, 1) + SUBS * octant + ii
    inside = (octant < g) & (row < pane.shape[0])
    return torch.where(inside, pane[row.clamp(max=pane.shape[0] - 1), lane],
                       0.0)


def _reference_block(plan: RouteMulPlan, lo: int, hi: int, A, B,
                     out) -> None:
    """Chunks [lo, hi) at once: both gathers, the products, the two
    three-pull permutations around the prefix, publish into ``out``."""
    a = plan.tile1[lo:hi].long()
    a2 = plan.tile2[lo:hi].long()
    b = plan.tile3[lo:hi].long()
    k = a.shape[0]
    ii = torch.arange(SUBS, device=a.device).view(1, SUBS, 1)
    jj = torch.arange(LANES, device=a.device).view(1, 1, LANES)
    vb = _gather(B, plan.b_base[lo:hi], _field(a, T1_OB), _field(a, T1_LB),
                 plan.g_b)
    ua = _gather(A, plan.a_base[lo:hi], _field(a2, T2_OA),
                 _field(a2, T2_LA), plan.g_a)
    c = torch.gather(ua, 1, _field(a2, T2_S7)) * vb
    c = torch.gather(c, 1, _field(a, T1_Q1))
    c = torch.gather(c, 2, _field(a, T1_Q2))
    c = torch.gather(c, 1, _field(a, T1_Q3))
    dist = _field(b, T3_DIST)
    for d in (1, 2, 4):
        sh = torch.roll(c, d, dims=1)
        sh[:, :d] = 0
        c = c + torch.where(dist >= d, sh, 0.0)
    rs = torch.gather(c, 1, _field(b, T3_P1))
    rs = torch.gather(rs, 2, _field(b, T3_P2))
    rs = torch.gather(rs, 1, _field(b, T3_P3))
    dest_row = plan.o_base[lo:hi].long().view(k, 1, 1) + ii
    keep = (_field(b, T3_VA) > 0) & (dest_row < out.shape[0])
    dest = (dest_row * LANES + jj).expand(k, SUBS, LANES)
    out.view(-1).index_add_(0, dest[keep], rs[keep])


def route_mul_reference(plan: RouteMulPlan, a2: torch.Tensor,
                        b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the zeroed out pane, then the
    chunks in blocks (advanced indexing for the gathers, ``gather`` for
    the pulls, ``roll`` and a mask for the prefix, ``index_add_`` for
    the publish).  Returns the (out_rows, 128) f32 out pane."""
    A, B = a2.view(-1, LANES), b2.view(-1, LANES)
    out = torch.zeros(plan.out_rows, LANES, dtype=torch.float32,
                      device=a2.device)
    for lo in range(0, plan.nchunks, _REF_BLOCK):
        _reference_block(plan, lo, min(lo + _REF_BLOCK, plan.nchunks), A,
                         B, out)
    return out


def _check_operands(plan: RouteMulPlan, a2: torch.Tensor,
                    b2: torch.Tensor) -> None:
    ints = (plan.tile1, plan.tile2, plan.tile3, plan.a_base, plan.b_base,
            plan.o_base)
    if any(t.device != a2.device for t in ints + (b2,)):
        raise ValueError(f"plan on {plan.tile1.device}, panes on "
                         f"{a2.device} and {b2.device}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("plan arrays must be int32")
    if a2.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError(f"panes must be float32, got {a2.dtype} and "
                        f"{b2.dtype}")
    nc = plan.nchunks
    if any(t.shape != (nc, SUBS, LANES) for t in ints[:3]) \
            or any(t.shape != (nc,) for t in ints[3:]) \
            or a2.shape != (plan.a_rows * LANES,) \
            or b2.shape != (plan.b_rows * LANES,):
        raise ValueError(f"bad shapes: tile1 {tuple(plan.tile1.shape)}, "
                         f"a2 {tuple(a2.shape)}, b2 {tuple(b2.shape)}")
    if not all(t.is_contiguous() for t in ints + (a2, b2)):
        raise ValueError("plan arrays and panes must be contiguous")


def route_mul_padded(plan: RouteMulPlan, a2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """The plan's tile walk over the packed panes ``a2`` and ``b2`` (from
    :func:`pad_pane`): the (out_rows, 128) f32 out pane, by
    :func:`route_mul_reference`.  CPU tensors only: on the card the
    numeric is :func:`route_mul`'s slot fill, and CUDA tensors raise."""
    _check_operands(plan, a2, b2)
    if _t.on_cuda(a2):
        raise ValueError("route_mul_padded walks the tiles on the CPU "
                         "only: on CUDA tensors route_mul runs the slot "
                         "fill over plan.expansion")
    return route_mul_reference(plan, a2, b2)


def route_mul(plan: RouteMulPlan, a_arr: torch.Tensor,
              b_arr: torch.Tensor) -> torch.Tensor:
    """c_values (capacity,) f32 = the slot sums of A_arr[src_a] *
    B_arr[src_b].  On CUDA tensors one launch of the slot fill
    (:func:`mul_fill`) over the plan's expansion stream writes the whole
    capacity; on CPU tensors the plain tile walker runs over the packed
    panes."""
    if _t.on_cuda(a_arr):
        return mul_fill(plan_stream(plan, "build_route_mul_plan"),
                        a_arr.float().contiguous(),
                        b_arr.float().contiguous(), plan.capacity)
    out = route_mul_padded(plan, pad_pane(a_arr, plan.a_rows),
                           pad_pane(b_arr, plan.b_rows))
    return out.view(-1)[: plan.capacity]

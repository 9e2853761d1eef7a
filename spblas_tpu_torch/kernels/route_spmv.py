"""ROUTE v1 chunk SpMV — counterpart of ``spblas_tpu/kernels/route_spmv.py``
(``route_spmv``).

On a CUDA tensor :func:`route_spmv_padded` launches the hand-written
kernel ``csrc/route_spmv.cu`` (which replaces the TPU kernel
``route_spmv.py::_route_kernel``) once for the whole apply; on a CPU
tensor it runs the plain PyTorch version level by level
(:func:`route_spmv_chain_reference` over :func:`route_spmv_reference`).

A plan level has no chunk that reads what another chunk of it writes
(its chunks read x, and publish into y and the aux region); the aux
region of a level is the x of the next level's plan (``aux_plan``).  The
kernel runs every level in one launch over one zeroed buffer
(``route_plan.V1Layout``): each level publishes its y windows into the
shared y region and its aux windows straight into the next level's
packed x, and a chunk of level d waits on a device counter until level
d - 1 is done.  Chunks publish with atomic adds, so sums into one row are
taken in another order than the TPU's.
:func:`route_spmv_fused_reference` is the plain version of that order.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.route_plan import (
    LANES, SLOTS, SUBS, T1_L, T1_OCT, T1_Q1, T1_Q2, T1_Q3, T3_DIST, T3_P1,
    T3_P2, T3_P3, T3_VA, RoutePlan, V1Layout, plan_levels)

# chunks per step of the plain version: bounds its (k, 8, 128) int64
# temporaries to 32 MB each
_REF_BLOCK = 4096


def pack_x(plan: RoutePlan, x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: the flat (x_rows * 128,) f32 pane, x in
    front, each hot column t copied to the 8 slots ``n_pad + (t // 128)
    * 1024 + r * 128 + t % 128``, zeros elsewhere."""
    n = plan.shape[1]
    xf = x.float()
    flat = F.pad(xf, (0, plan.x_rows * LANES - n))
    nhot = plan.hot_cols.numel()
    if nhot:
        dev = flat.device
        t = torch.arange(nhot, device=dev)
        pos = plan.n_pad + (t // LANES) * SLOTS + t % LANES
        idx = pos[None, :] + LANES * torch.arange(SUBS, device=dev)[:, None]
        flat[idx.reshape(-1)] = xf[plan.hot_cols.long()].repeat(SUBS)
    return flat.contiguous()


def _field(t: torch.Tensor, bit: int, mask: int) -> torch.Tensor:
    return (t >> bit) & mask


def _reference_block(plan: RoutePlan, lo: int, hi: int, xs: torch.Tensor,
                     pane: torch.Tensor) -> None:
    """Chunks [lo, hi) at once: gather from ``xs`` (x_rows, 128), the two
    three-pull permutations around the prefix, publish into ``pane``."""
    a = plan.tile1[lo:hi].long()
    b = plan.tile3[lo:hi].long()
    k = a.shape[0]
    dev = a.device
    ii = torch.arange(SUBS, device=dev).view(1, SUBS, 1)
    jj = torch.arange(LANES, device=dev).view(1, 1, LANES)

    # vx[i, j] = x2[sb + 8*oct + i, l] for oct < g, else 0; rows past
    # the pane read 0
    oct_ = _field(a, T1_OCT, 7)
    row = plan.slab_base[lo:hi].long().view(k, 1, 1) + SUBS * oct_ + ii
    inside = (oct_ < plan.g) & (row < xs.shape[0])
    vx = torch.where(inside, xs[row.clamp(max=xs.shape[0] - 1),
                                _field(a, T1_L, 127)], 0.0)
    c = vx * plan.val[lo:hi]
    # permute 1: sublane, lane, sublane pulls
    c = torch.gather(c, 1, _field(a, T1_Q1, 7))
    c = torch.gather(c, 2, _field(a, T1_Q2, 127))
    c = torch.gather(c, 1, _field(a, T1_Q3, 7))
    dist = _field(b, T3_DIST, 7)
    for d in (1, 2, 4):
        sh = torch.roll(c, d, dims=1)
        sh[:, :d] = 0
        c = c + torch.where(dist >= d, sh, 0.0)
    # permute 2: segment ends to the y window's slots
    rs = torch.gather(c, 1, _field(b, T3_P1, 7))
    rs = torch.gather(rs, 2, _field(b, T3_P2, 127))
    rs = torch.gather(rs, 1, _field(b, T3_P3, 7))
    dest_row = plan.y_base[lo:hi].long().view(k, 1, 1) + ii
    keep = (_field(b, T3_VA, 1) > 0) & (dest_row < pane.shape[0])
    dest = dest_row * LANES + jj
    pane.view(-1).index_add_(0, dest[keep], rs[keep])


def route_spmv_reference(plan: RoutePlan, x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one plan level: the zeroed pane, then the
    chunks vectorised in blocks (advanced indexing for the gather,
    ``gather`` for the six pulls, ``roll`` and a mask for the prefix,
    ``index_add_`` for the publish).  Returns the (pane_rows, 128) f32
    pane."""
    xs = x2.view(-1, LANES)
    pane = torch.zeros(plan.pane_rows, LANES, dtype=torch.float32,
                       device=x2.device)
    for lo in range(0, plan.nchunks, _REF_BLOCK):
        _reference_block(plan, lo, min(lo + _REF_BLOCK, plan.nchunks), xs,
                         pane)
    return pane


def route_spmv_chain_reference(plan: RoutePlan,
                               x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the whole apply, level by level: the
    level's pane, its first m slots into y, its aux slots packed as the
    next level's x.  Returns y, (m,) f32."""
    m = plan.shape[0]
    pane = route_spmv_reference(plan, x2).view(-1)
    y = pane[:m]
    if plan.aux_plan is not None:
        start = plan.y_rows * LANES
        y = y + route_spmv_chain_reference(
            plan.aux_plan,
            pack_x(plan.aux_plan, pane[start:start + plan.aux_len]))
    return y


def _layout(plan: RoutePlan) -> V1Layout:
    if plan.layout is None:
        raise ValueError("the plan carries no one-launch layout: build it "
                         "with build_route_plan or route_plan.fuse_levels")
    return plan.layout


def route_spmv_fused_reference(plan: RoutePlan,
                               x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's order: every chunk of every
    level, level by level, into the one zeroed buffer, through the
    rebased ``fused_sb`` / ``fused_yb`` (level 0 reading ``x2``, level d
    its region of the buffer, which level d - 1 filled).  Returns the
    (buf_rows, 128) f32 buffer: y in its first m slots."""
    lay = _layout(plan)
    buf = torch.zeros(lay.buf_rows, LANES, dtype=torch.float32,
                      device=x2.device)
    for d, p in enumerate(plan_levels(plan)):
        xs = x2.view(-1, LANES) if d == 0 else buf[:lay.src_rows[d]]
        q = dataclasses.replace(p, slab_base=p.fused_sb, y_base=p.fused_yb)
        for lo in range(0, p.nchunks, _REF_BLOCK):
            _reference_block(q, lo, min(lo + _REF_BLOCK, p.nchunks), xs,
                             buf)
    return buf


def _check_operands(plan: RoutePlan, x2: torch.Tensor) -> None:
    ints = (plan.tile1, plan.tile3, plan.slab_base, plan.y_base)
    arrays = ints + (plan.val,)
    if any(a.device != x2.device for a in arrays):
        raise ValueError(f"plan on {plan.tile1.device}, x2 on {x2.device}")
    if any(a.dtype != torch.int32 for a in ints):
        raise TypeError("plan index arrays must be int32")
    if plan.val.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError(f"val and x2 must be float32, got {plan.val.dtype}"
                        f" and {x2.dtype}")
    nc = plan.nchunks
    if any(t.shape != (nc, SUBS, LANES)
           for t in (plan.tile1, plan.tile3, plan.val)) \
            or any(t.shape != (nc,) for t in (plan.slab_base, plan.y_base)) \
            or x2.shape != (plan.x_rows * LANES,):
        raise ValueError(f"bad shapes: tile1 {tuple(plan.tile1.shape)}, "
                         f"tile3 {tuple(plan.tile3.shape)}, "
                         f"val {tuple(plan.val.shape)}, "
                         f"x2 {tuple(x2.shape)}")
    if not all(a.is_contiguous() for a in arrays + (x2,)):
        raise ValueError("plan arrays and x2 must be contiguous")


def _level_words(p: RoutePlan, end: int, src_rows: int) -> list:
    """One level's eight descriptor words: tile1, tile3, val, fused_sb,
    fused_yb (pointers), chunk end, source rows, g."""
    arrays = (p.tile1, p.tile3, p.val, p.fused_sb, p.fused_yb)
    if any(not a.is_contiguous() for a in arrays) \
            or any(a.data_ptr() % 16 for a in arrays[:3]):
        raise ValueError("level arrays must be contiguous, the tiles "
                         "16-byte aligned")
    return [a.data_ptr() for a in arrays] + [end, src_rows, p.g]


# (desc, nlevels, x2, buf, buf_rows, stream) of route_spmv_f32
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)


def route_spmv_padded(plan: RoutePlan, x2: torch.Tensor) -> torch.Tensor:
    """The whole apply over the packed level-0 x ``x2`` (from
    :func:`pack_x`); returns y, (m,) f32.  CUDA tensors zero one buffer
    (``V1Layout``) and launch ``route_spmv.cu`` once, on the current
    stream, y a view of the buffer; CPU tensors take
    :func:`route_spmv_chain_reference`."""
    _check_operands(plan, x2)
    if not _t.on_cuda(x2):
        return route_spmv_chain_reference(plan, x2)
    lay = _layout(plan)
    words = []
    for p, end, rows in zip(plan_levels(plan), lay.level_ends,
                            lay.src_rows):
        if p.tile1.device != x2.device:
            raise ValueError(f"plan on {p.tile1.device}, x2 on {x2.device}")
        words += _level_words(p, end, rows)
    # the buffer, and past it 16 words of counters
    buf = torch.zeros(lay.buf_rows * LANES + 16, dtype=torch.float32,
                      device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    fn = _build.function("route_spmv", "route_spmv_f32", _ARGTYPES)
    _build.check(fn((ctypes.c_longlong * len(words))(*words), lay.nlevels,
                    x2.data_ptr(), buf.data_ptr(), lay.buf_rows, stream),
                 "route_spmv")
    route_spmv_padded.launches += 1
    return buf[:plan.shape[0]]


route_spmv_padded.launches = 0


def route_spmv(plan: RoutePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through a ROUTE v1 plan, in x's dtype (computed in f32):
    level 0's x packed, then every level at once (one launch on the
    card)."""
    return route_spmv_padded(plan, pack_x(plan, x)).to(x.dtype)

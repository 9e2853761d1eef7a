"""ROUTE2 chunk SpMV — counterpart of ``spblas_tpu/kernels/route2_kernel.py``
(``route2_spmv``, ``route2_dispatch``).

On a CUDA tensor :func:`route2_spmv_padded` launches the hand-written
kernel ``csrc/route2_spmv.cu`` (which replaces the TPU kernel
``route2_kernel.py::_route2_kernel``); on a CPU tensor it runs
:func:`route2_spmv_reference`, the plain PyTorch version of the same
computation.

The TPU kernel runs its chunks in grid order, so aux chunks read pane
slots that earlier chunks of the same dispatch published.  CUDA blocks
run in no order, so the pane is zeroed and the plan's chunks run as one
launch per ``Route2Plan.launch_ranges()`` entry: the first over every
flag-0 and flag-2 chunk, reading x, then one per aux level, reading the
pane.  No chunk of a launch reads a pane row another chunk of the same
launch writes, so each launch may run its chunks in any order; chunks
publish with atomic adds, so sums into one row are taken in another
order than the TPU's.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.route2 import (B_DIST, B_LF, B_LSRC, B_PEND,
                                             B_R2, B_SD2, B_SEL, B_SUBW,
                                             B_VA, LANES, SUBS, Route2Plan)


def pack_x2(plan: Route2Plan, x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: the flat (x_rows * 128,) f32 pane, x in
    front, the extension columns at ``nat_slots``, zeros elsewhere."""
    n = plan.shape[1]
    xf = x.float()
    if plan.ext_cols.numel():
        xf = torch.cat([F.pad(xf, (0, plan.nat_slots - n)),
                        xf[plan.ext_cols.long()]])
    return F.pad(xf, (0, plan.x_rows * LANES - xf.shape[0])).contiguous()


def out_rows(plan: Route2Plan) -> int:
    """Rows of the output pane: at least one slab tall, so every aux
    chunk's slab lies in it (rows past the plan's pane stay 0)."""
    return max(plan.pane_rows, SUBS * plan.g)


def _field(t: torch.Tensor, bit: int, mask: int) -> torch.Tensor:
    return (t >> bit) & mask


def chunk_reference(tile: torch.Tensor, val: torch.Tensor,
                    slab_base: torch.Tensor, y_base: torch.Tensor,
                    src_flag: torch.Tensor, rho, src: torch.Tensor,
                    pane: torch.Tensor, *, g: int, dist_max: int,
                    any_lane: bool, ww: int, rotated: bool) -> None:
    """The ROUTE2 chunk body over k chunks at once (``tile``, ``val``
    (k, 8, 128); ``slab_base``, ``y_base``, ``src_flag`` and, on a
    rotated plan, ``rho`` (k,)): gather from ``src`` (rows, 128) as it
    stands, then publish into ``pane`` (rows, 128).  The plain version
    of ``csrc/route2_chunk.cuh``."""
    t = tile.long()
    k = t.shape[0]
    dev = t.device
    flag = src_flag.long().view(k, 1, 1)
    ii = torch.arange(SUBS, device=dev).view(1, SUBS, 1)
    jj = torch.arange(LANES, device=dev).view(1, 1, LANES)

    # t1[a, l] = src[sb + r2[a, l], l]; rows past the pane read 0
    r2 = _field(t, B_R2, 255).clamp(max=SUBS * g - 1)
    row = slab_base.long().view(k, 1, 1) + r2
    inside = row < src.shape[0]
    t1 = torch.where(inside, src[row.clamp(max=src.shape[0] - 1), jj], 0.0)
    va = _field(t, B_VA, 1).float()

    t2 = torch.gather(t1, 2, _field(t, B_LF, 127))       # lane gather
    t3 = torch.gather(t2, 1, _field(t, B_SD2, 7))        # depth drop
    p = t3 * val
    dist = _field(t, B_DIST, 7)
    for d in (1, 2, 4):
        if d > dist_max:
            break
        sh = torch.roll(p, d, dims=1)
        sh[:, :d] = 0
        p = p + torch.where(dist >= d, sh, 0.0)
    rs = torch.gather(p, 1, _field(t, B_PEND, 7))
    if any_lane:
        rs = torch.gather(rs, 2, _field(t, B_LSRC, 127))
    hub = (t1 * val).sum(dim=(1, 2)).view(k, 1, 1)        # flag-2 chunks
    rs = torch.where(flag == 2, hub, rs) * va

    # destination of slot (s, j): sublane s, or (s - r) & 7 on a rotated
    # chunk; plus sub-window subw * 8 on a supercell plan
    sub = ii.expand(k, SUBS, LANES)
    if rotated:
        rh = rho.long().view(k, 1, 1)
        r = torch.where(_field(t, B_SEL, 1) == 1, (rh >> 17) & 7,
                        (rh >> 7) & 7)
        sub = torch.where(flag == 2, sub, (sub - r) & 7)
    keep = va > 0
    if ww > 1:
        sw = _field(t, B_SUBW, 7)
        keep = keep & (sw < ww)
        sub = sub + SUBS * sw
    dest_row = y_base.long().view(k, 1, 1) + sub
    keep = keep & (dest_row < pane.shape[0])
    dest = dest_row * LANES + jj
    pane.view(-1).index_add_(0, dest[keep], rs[keep])


def _reference_range(plan: Route2Plan, lo: int, hi: int,
                     src: torch.Tensor, pane: torch.Tensor) -> None:
    """Chunks [lo, hi) of one launch, all at once."""
    chunk_reference(
        plan.tile[lo:hi], plan.val[lo:hi], plan.slab_base[lo:hi],
        plan.y_base[lo:hi], plan.src_flag[lo:hi],
        plan.rho[lo:hi] if plan.rotated else None, src, pane, g=plan.g,
        dist_max=plan.dist_max, any_lane=plan.any_lane,
        ww=plan.row_window_mult, rotated=plan.rotated)


def route2_spmv_reference(plan: Route2Plan,
                          x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the zeroed pane, then each
    launch range vectorised over its chunks (advanced indexing for the
    three gathers, ``roll`` and a mask for the prefix, ``index_add_`` for
    the publish), in launch order.  Returns the (rows, 128) f32 pane."""
    xs = x2.view(-1, LANES)
    pane = torch.zeros(out_rows(plan), LANES, dtype=torch.float32,
                       device=x2.device)
    for i, (lo, hi) in enumerate(plan.launch_ranges()):
        if hi > lo:
            _reference_range(plan, lo, hi, xs if i == 0 else pane, pane)
    return pane


def _check_operands(plan: Route2Plan, x2: torch.Tensor) -> None:
    arrays = (plan.tile, plan.val, plan.slab_base, plan.y_base,
              plan.src_flag) + ((plan.rho,) if plan.rotated else ())
    if any(a.device != x2.device for a in arrays):
        raise ValueError(f"plan on {plan.tile.device}, x2 on {x2.device}")
    if any(a.dtype != torch.int32 for a in arrays if a is not plan.val):
        raise TypeError("plan index arrays must be int32")
    if plan.val.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError(f"val and x2 must be float32, got {plan.val.dtype}"
                        f" and {x2.dtype}")
    if plan.tile.shape != (plan.nchunks, SUBS, LANES) \
            or plan.val.shape != plan.tile.shape \
            or x2.shape != (plan.x_rows * LANES,):
        raise ValueError(f"bad shapes: tile {tuple(plan.tile.shape)}, "
                         f"val {tuple(plan.val.shape)}, "
                         f"x2 {tuple(x2.shape)}")
    if not all(a.is_contiguous() for a in arrays + (x2,)):
        raise ValueError("plan arrays and x2 must be contiguous")


# (tile, val, slab_base, y_base, src_flag, rho, lo, hi, src, src_rows,
#  dst, dst_rows, g, dist_max, any_lane, ww, rotated, stream) of
# route2_spmv_f32
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 2 + (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)


def route2_spmv_padded(plan: Route2Plan, x2: torch.Tensor) -> torch.Tensor:
    """The plan over the packed x pane ``x2`` (from :func:`pack_x2`);
    returns the (rows, 128) f32 output pane.  CUDA tensors launch
    ``route2_spmv.cu`` once per launch range, on the current stream;
    CPU tensors take :func:`route2_spmv_reference`."""
    _check_operands(plan, x2)
    if not _t.on_cuda(x2):
        return route2_spmv_reference(plan, x2)
    rows = out_rows(plan)
    pane = torch.zeros(rows, LANES, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    fn = _build.function("route2_spmv", "route2_spmv_f32", _ARGTYPES)
    rho = plan.rho.data_ptr() if plan.rotated else None
    for i, (lo, hi) in enumerate(plan.launch_ranges()):
        if hi <= lo:
            continue
        src, src_rows = (x2, plan.x_rows) if i == 0 else (pane, rows)
        _build.check(fn(
            plan.tile.data_ptr(), plan.val.data_ptr(),
            plan.slab_base.data_ptr(), plan.y_base.data_ptr(),
            plan.src_flag.data_ptr(), rho, lo, hi, src.data_ptr(), src_rows,
            pane.data_ptr(), rows, plan.g, plan.dist_max,
            int(plan.any_lane), plan.row_window_mult, int(plan.rotated),
            stream), "route2_spmv")
        route2_spmv_padded.launches += 1
    return pane


route2_spmv_padded.launches = 0


def route2_spmv(plan: Route2Plan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through a ROUTE2 plan, in x's dtype (computed in f32)."""
    pane = route2_spmv_padded(plan, pack_x2(plan, x))
    return pane.view(-1)[: plan.shape[0]].to(x.dtype)

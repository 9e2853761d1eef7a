"""ROUTE2 chunk SpMV and the fused SpGEMM numeric — counterpart of
``spblas_tpu/kernels/route2_kernel.py`` (``route2_spmv``,
``route2_dispatch``, ``route2_mul``).

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

The SpGEMM numeric (:func:`route2_mul`) runs a ``Route2MulPlan`` the same
way: :func:`route2_mul_padded` launches ``csrc/route2_mul.cu`` (which
replaces ``route2_kernel.py::_route2_mul_kernel``) once over the flag-0
chunks, reading the B pane, then once per aux level, reading the out
pane; CPU tensors take :func:`route2_mul_reference`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.route2 import (B2_LF, B2_R2, B2_SD2, B_DIST,
                                             B_LF, B_LSRC, B_PEND, B_R2,
                                             B_SD2, B_SEL, B_SUBW, B_VA,
                                             LANES, SUBS, Route2MulPlan,
                                             Route2Plan)


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


def _slab_route(r2, base, src, g: int) -> torch.Tensor:
    """u[k, a, l] = src[base[k] + r2[k, a, l], l]; slab rows bounded by
    the slab's 8g rows, rows past ``src`` read 0."""
    jj = torch.arange(LANES, device=r2.device).view(1, 1, LANES)
    row = base.long().view(-1, 1, 1) + r2.clamp(max=SUBS * g - 1)
    inside = row < src.shape[0]
    return torch.where(inside, src[row.clamp(max=src.shape[0] - 1), jj],
                       0.0)


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

    t1 = _slab_route(_field(t, B_R2, 255), slab_base, src, g)
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


# ------------------------------------------------------------------ #
# ROUTE2-mul: the fused SpGEMM numeric (dual gather chains)
# ------------------------------------------------------------------ #

# chunks per step of the plain versions
_REF_BLOCK = 4096


def _gather_chain(t, base, src, g: int, b_r2: int, b_lf: int,
                  b_sd2: int) -> torch.Tensor:
    u = _slab_route(_field(t, b_r2, 255), base, src, g)
    u = torch.gather(u, 2, _field(t, b_lf, 127))          # lane gather
    return torch.gather(u, 1, _field(t, b_sd2, 7))        # depth drop


def mul_chunk_reference(tile1: torch.Tensor, tile2: torch.Tensor,
                        a_base: torch.Tensor, b_base: torch.Tensor,
                        y_base: torch.Tensor, a2: torch.Tensor,
                        src: torch.Tensor, out: torch.Tensor, *, g_a: int,
                        g_b: int, dist_max: int) -> None:
    """The ROUTE2-mul chunk body over k chunks at once (``tile1``,
    ``tile2`` (k, 8, 128); ``a_base``, ``b_base``, ``y_base`` (k,)):
    gather from the A pane ``a2`` and from ``src`` (rows, 128) as they
    stand, then publish into ``out`` (rows, 128).  The plain version of
    ``csrc/route2_mul_chunk.cuh``."""
    t1, t2 = tile1.long(), tile2.long()
    k = t1.shape[0]
    ii = torch.arange(SUBS, device=t1.device).view(1, SUBS, 1)
    jj = torch.arange(LANES, device=t1.device).view(1, 1, LANES)
    p = (_gather_chain(t2, a_base, a2, g_a, B2_R2, B2_LF, B2_SD2)
         * _gather_chain(t1, b_base, src, g_b, B_R2, B_LF, B_SD2))
    dist = _field(t1, B_DIST, 7)
    for d in (1, 2, 4):
        if d > dist_max:
            break
        sh = torch.roll(p, d, dims=1)
        sh[:, :d] = 0
        p = p + torch.where(dist >= d, sh, 0.0)
    rs = torch.gather(p, 1, _field(t1, B_PEND, 7))
    dest_row = y_base.long().view(k, 1, 1) + ii
    keep = (_field(t1, B_VA, 1) == 1) & (dest_row < out.shape[0])
    dest = (dest_row * LANES + jj).expand(k, SUBS, LANES)
    out.view(-1).index_add_(0, dest[keep], rs[keep])


def mul_out_rows(plan: Route2MulPlan) -> int:
    """Rows of the out pane: at least one B slab tall, as the TPU
    kernel's (rows past the plan's pane stay 0)."""
    return max(plan.pane_rows, SUBS * plan.g_b)


def pad_pane(values: torch.Tensor, rows: int) -> torch.Tensor:
    """A value array as a mul kernel reads it: the flat f32 pane of
    ``rows`` rows of 128, zeros past the values."""
    return F.pad(values.float(), (0, rows * LANES - values.shape[0])
                 ).contiguous()


def pack_mul_panes(plan: Route2MulPlan, a_arr: torch.Tensor,
                   b_arr: torch.Tensor):
    """The A and B panes of a resident plan (``a_rows``, ``b_rows``)."""
    return pad_pane(a_arr, plan.a_rows), pad_pane(b_arr, plan.b_rows)


def route2_mul_reference(plan: Route2MulPlan, a2: torch.Tensor,
                         b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the zeroed out pane, then
    each launch range in blocks of chunks (advanced indexing for the
    gathers, ``roll`` and a mask for the prefix, ``index_add_`` for the
    publish), in launch order.  Returns the (rows, 128) f32 out pane."""
    a_s, b_s = a2.view(-1, LANES), b2.view(-1, LANES)
    out = torch.zeros(mul_out_rows(plan), LANES, dtype=torch.float32,
                      device=a2.device)
    for i, (lo, hi) in enumerate(plan.launch_ranges()):
        src = b_s if i == 0 else out
        for b0 in range(lo, hi, _REF_BLOCK):
            b1 = min(b0 + _REF_BLOCK, hi)
            mul_chunk_reference(
                plan.tile1[b0:b1], plan.tile2[b0:b1], plan.a_base[b0:b1],
                plan.b_base[b0:b1], plan.y_base[b0:b1], a_s, src, out,
                g_a=plan.g_a, g_b=plan.g_b, dist_max=plan.dist_max)
    return out


def _check_mul_operands(plan: Route2MulPlan, a2: torch.Tensor,
                        b2: torch.Tensor) -> None:
    ints = (plan.tile1, plan.tile2, plan.a_base, plan.b_base,
            plan.y_base, plan.src_flag)
    if any(t.device != a2.device for t in ints + (b2,)):
        raise ValueError(f"plan on {plan.tile1.device}, panes on "
                         f"{a2.device} and {b2.device}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("plan arrays must be int32")
    if a2.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError(f"panes must be float32, got {a2.dtype} and "
                        f"{b2.dtype}")
    nc = plan.nchunks
    if plan.tile1.shape != (nc, SUBS, LANES) \
            or plan.tile2.shape != plan.tile1.shape \
            or any(t.shape != (nc,) for t in ints[2:]) \
            or a2.shape != (plan.a_rows * LANES,) \
            or b2.shape != (plan.b_rows * LANES,):
        raise ValueError(f"bad shapes: tile1 {tuple(plan.tile1.shape)}, "
                         f"a2 {tuple(a2.shape)}, b2 {tuple(b2.shape)}")
    if not all(t.is_contiguous() for t in ints + (a2, b2)):
        raise ValueError("plan arrays and panes must be contiguous")


# (tile1, tile2, a_base, b_base, y_base, lo, hi, A, a_rows, src,
#  src_rows, out, out_rows, g_a, g_b, dist_max, stream) of route2_mul_f32
_MUL_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) * 2 + (
    ctypes.c_void_p, ctypes.c_longlong) * 3 + (
    ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def route2_mul_padded(plan: Route2MulPlan, a2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """The plan over the packed panes ``a2`` and ``b2`` (from
    :func:`pack_mul_panes`); returns the (rows, 128) f32 out pane.  CUDA
    tensors launch ``route2_mul.cu`` once per launch range, on the
    current stream; CPU tensors take :func:`route2_mul_reference`."""
    _check_mul_operands(plan, a2, b2)
    if not _t.on_cuda(a2):
        return route2_mul_reference(plan, a2, b2)
    rows = mul_out_rows(plan)
    out = torch.zeros(rows, LANES, dtype=torch.float32, device=a2.device)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    fn = _build.function("route2_mul", "route2_mul_f32", _MUL_ARGTYPES)
    for i, (lo, hi) in enumerate(plan.launch_ranges()):
        if hi <= lo:
            continue
        src, src_rows = (b2, plan.b_rows) if i == 0 else (out, rows)
        _build.check(fn(
            plan.tile1.data_ptr(), plan.tile2.data_ptr(),
            plan.a_base.data_ptr(), plan.b_base.data_ptr(),
            plan.y_base.data_ptr(), lo, hi, a2.data_ptr(), plan.a_rows,
            src.data_ptr(), src_rows, out.data_ptr(), rows, plan.g_a,
            plan.g_b, plan.dist_max, stream), "route2_mul")
        route2_mul_padded.launches += 1
    return out


route2_mul_padded.launches = 0


def route2_mul(plan: Route2MulPlan, a_arr: torch.Tensor,
               b_arr: torch.Tensor) -> torch.Tensor:
    """c_values (capacity,) f32 = the slot sums of A_arr[sa] * B_arr[sb]
    (values fresh from the panes, so a new-values run needs no update
    step)."""
    out = route2_mul_padded(plan, *pack_mul_panes(plan, a_arr, b_arr))
    return out.view(-1)[: plan.capacity]

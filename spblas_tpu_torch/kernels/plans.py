"""Plan selection behind ``matrix_opt`` — counterpart of
``spblas_tpu/kernels/plans.py`` (matvec and matmul).

The JAX ladder gates its Pallas rungs on the TPU; here they are gated on
the matrix living on a CUDA device.  The matvec ladder, in order:

  banded (fill >= 0.15)  -> band-panel plan (csrc/band_spmv.cu)
  block-dense            -> BSR plan, 8x128 blocks (csrc/bsr_spmv.cu)
  banded, narrow         -> band-panel plan
  stencil/mesh           -> DIA plan (csrc/dia_spmv.cu behind its gate)
  square, RCM-bandable   -> permuted band plan (band_perm: native RCM,
                            index_select permutations, band_spmv.cu)
  banded, complex64      -> two real band plans (band_cx; SpMM: one
                            pass of the complex kernel, band_spmm_cx)
  general, on CUDA       -> ROUTE2 plan (csrc/route2_spmv.cu), kind route;
                            hub-heavy rows: ROUTE v1 (csrc/route_spmv.cu),
                            kind route1, or degree-sorted v1 plus a ROUTE2
                            un-permute, kind route1_sorted; x and y past
                            the TPU's VMEM: paned ROUTE2
                            (csrc/route_paned_spmv.cu), kind route_paned
  general, complex64     -> two real plans of the kind above (route_cx);
                            over ROUTE2 one pass of the complex kernel
                            (route2_cx_spmv_f32 in csrc/route2_spmv.cu),
                            over the other kinds four real applies
  general                -> SELL (torch ops)

The matmul ladder (:func:`build_matmul_plan`) shares the structured
rungs (``STRUCTURED_KINDS``; the plan cache aliases them across the
``matvec`` and ``matmul`` keys) and sends general sparsity to SELL.
:func:`plan_spmm` runs the band SpMM kernels (``csrc/band_spmm.cu``,
resident or streamed B by the JAX 6 MB switch, B read in place; the
permuted band and the complex band on the resident kernel's index and
complex entry points), the BSR SpMM kernel
(``csrc/bsr_spmm.cu``) and the DIA and SELL products as torch ops.
No rung builds an ELL plan (``kernels/ell.py``), as in the JAX ladder;
both runners take one a caller builds (kind ``ell``, torch ops).

Thresholds and envelopes are the JAX package's (``plans.py:46-64``,
``:250-426``), kept for parity; re-deriving them for the H100 is ROADMAP
Queue 1 item 18.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spblas_tpu_torch import native
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import CSR, host_arrays
from spblas_tpu_torch.kernels.banded import (band_halfwidth, band_spmm,
                                             band_spmm_cx,
                                             band_spmm_stream, band_spmv,
                                             build_band_plan,
                                             build_permuted_band_plan,
                                             permuted_band_spmm,
                                             permuted_band_spmv)
from spblas_tpu_torch.kernels.bsr_kernels import _apply as bsr_apply
from spblas_tpu_torch.kernels.bsr_kernels import bsr_spmm, bsr_spmv_blocks
from spblas_tpu_torch.kernels.dia import (build_dia_plan, dia_fill_fraction,
                                          dia_spmm, dia_spmv)
from spblas_tpu_torch.kernels.ell import ell_spmm, ell_spmv
from spblas_tpu_torch.kernels.route2 import Route2Plan, build_route2_plan
from spblas_tpu_torch.kernels.route2_kernel import (cx_imag_plane,
                                                    route2_cx_spmv,
                                                    route2_spmv)
from spblas_tpu_torch.kernels.route_paned import (build_route_paned_plan,
                                                  estimate_paned_bytes,
                                                  route_paned_spmv)
from spblas_tpu_torch.kernels.route_plan import RoutePlan, build_route_plan
from spblas_tpu_torch.kernels.route_spmv import route_spmv
from spblas_tpu_torch.kernels.sell import (build_sell_plan, sell_spmm,
                                           sell_spmv)
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.types import on_cuda as _on_cuda

# DIA wins when its dense-diagonal storage is mostly true nonzeros
_DIA_FILL_THRESHOLD = 0.34
# band panels are kept while they are at least this full ...
_BAND_FILL_THRESHOLD = 0.15
# ... and, after the BSR rung, an already-banded narrow matrix down to here
_BAND_NARROW_FILL = 0.02
# BSR pays bh*bw slots per stored block: taken when blocks are this full
_BSR_FILL_THRESHOLD = 0.25
_BSR_BLOCK = (8, 128)
# the RCM-permuted band is kept only when this full
_BAND_PERM_FILL_THRESHOLD = 0.05
# plan_spmm streams B (band_spmm_stream) once the resident padded B
# passes this many bytes: the TPU's VMEM budget, kept for parity
_BAND_RESIDENT_B_BYTES = 6 * 1024 * 1024

# plan kinds usable by both spmv and spmm: the plan cache aliases them
# across the "matvec" and "matmul" keys, so structured inspection (RCM,
# band and BSR packing) runs once per matrix
STRUCTURED_KINDS = ("band", "band_perm", "band_cx", "bsr", "dia")
# matvec plans that plan_spmm replays one column at a time
_ROUTE_KINDS = ("route", "route1", "route1_sorted", "route_paned",
                "route_cx")

# plan kinds that preserve the operand dtype (torch formulations); the
# *_cx kinds are complex-aware but compute in two f32 planes
_DTYPE_PRESERVING_KINDS = ("sell", "ell", "dia")
_CX_KINDS = ("band_cx", "route_cx")

# ROUTE keeps x and y resident in the TPU's VMEM: (x_rows + y_rows) rows
# of 128 must fit.  Past it the ladder takes "route_paned".
_ROUTE_VMEM_ROWS = 20_000
# hub-row mass above this fraction takes ROUTE v1 ("route1")
_ROUTE_HUB_DEG = 32
_ROUTE_HUB_FRACTION = 0.15
# the JAX chunk-time model that picks plain or degree-sorted v1: a
# second dispatch's overhead against the sorted plan's chunk win
_SORTED_DISPATCH_NS = 150_000
_V1_NS_PER_CHUNK = 160
_R2_NS_PER_CHUNK = 70
# a ROUTE2 fill below this builds a v1 plan beside it and keeps the
# cheaper by 180 (v1) against 110 (ROUTE2) ns a chunk
_ROUTE2_FILL_GUARD = 0.08
# paned plans: cap the plan stream's device bytes, and drop plans whose
# cells are so starved that the stream outweighs its win
_ROUTE_PANED_BUDGET = int(os.environ.get("SPBLAS_ROUTE_PANED_BUDGET",
                                         5_000_000_000))
_PANED_MIN_FILL = 0.02


def _band_fill(a, h) -> float:
    return a.nnz / float(max(a.shape[0], 1) * (128 + 2 * h))


def _build_band_cx(a):
    """Complex banded plan: two real band-panel plans over the same
    structure (re/im planes)."""
    ar = dataclasses.replace(a, values=a.values.real.contiguous())
    ai = dataclasses.replace(a, values=a.values.imag.contiguous())
    return (build_band_plan(ar), build_band_plan(ai))


def _cx_apply(fn, plans, x):
    """(a+ib)(x+iy) = (ax-by) + i(ay+bx): four real applies of ``fn``."""
    pr, pi = plans
    xr = x.real.float()
    xi = x.imag.float() if x.is_complex() else torch.zeros_like(xr)
    yr = fn(pr, xr) - fn(pi, xi)
    yi = fn(pr, xi) + fn(pi, xr)
    return torch.complex(yr, yi)


def band_cx_spmv(plans, x):
    """Complex band SpMV: four real panel SpMVs."""
    return _cx_apply(band_spmv, plans, x)


def band_cx_spmm(plans, b):
    """Complex band SpMM: one pass of the complex kernel over both panel
    planes (``band_spmm_cx``), B (complex64, or real: two products) read
    in place; JAX runs four real panel SpMMs.  The planes must share
    their width and pad_l, as ``_build_band_cx`` builds them."""
    pr, pi = plans
    if pr.panels.shape != pi.panels.shape or pr.pad_l != pi.pad_l:
        raise ValueError(f"band_cx planes differ: panels "
                         f"{tuple(pr.panels.shape)} and "
                         f"{tuple(pi.panels.shape)}, pad_l {pr.pad_l} "
                         f"and {pi.pad_l}")
    b = b.to(torch.complex64) if b.is_complex() else b.float()
    return band_spmm_cx(pr.panels, pi.panels, b.contiguous(), pr.pad_l,
                        pr.shape[0])


def _dia_or_none(a):
    if dia_fill_fraction(a) >= _DIA_FILL_THRESHOLD:
        return ("dia", build_dia_plan(a))
    return None


def _try_bsr(a):
    """A BSR plan (8x128 blocks) when the stored blocks are at least
    ``_BSR_FILL_THRESHOLD`` full, else None.  The shape is padded to
    block multiples as metadata only: padded rows and columns are
    structurally empty.  Returns (bsr, (m, n))."""
    bh, bw = _BSR_BLOCK
    m, n = a.shape
    nnz = a.nnz
    if nnz == 0:
        return None
    rows, cols, _ = host_arrays(a)
    nb = -(-n // bw)
    nnzb = len(np.unique((rows // bh) * nb + cols.astype(np.int64) // bw))
    if nnz / float(nnzb * bh * bw) < _BSR_FILL_THRESHOLD:
        return None
    m_pad = -(-m // bh) * bh
    n_pad = nb * bw
    if (m_pad, n_pad) != (m, n):
        pad_rp = torch.cat([a.rowptr, a.rowptr[-1:].expand(m_pad - m)])
        a = CSR(values=a.values, rowptr=pad_rp, colind=a.colind, nnz=nnz,
                shape=(m_pad, n_pad))
    return (BSR.from_csr(a, _BSR_BLOCK), (m, n))


def _try_band_perm(a):
    """The RCM rung for a square matrix: a permuted band plan when the
    reordered band is at least ``_BAND_PERM_FILL_THRESHOLD`` full, else
    None."""
    m = a.shape[0]
    perm, h2 = native.rcm(m, a.nnz,
                          _t.to_numpy(a.rowptr).astype(np.int64),
                          _t.to_numpy(a.colind))
    if _band_fill(a, h2) >= _BAND_PERM_FILL_THRESHOLD:
        return ("band_perm", build_permuted_band_plan(a, perm=perm))
    return None


def _structured_plan(a, m, n, h):
    """The structured-plan ladder (band, BSR, DIA, RCM band); returns
    (kind, plan) or None when only general-sparsity plans apply."""
    if a.dtype.is_complex:
        if (_on_cuda(a.values) and a.dtype == torch.complex64
                and _band_fill(a, h) >= _BAND_NARROW_FILL):
            return ("band_cx", _build_band_cx(a))
        return _dia_or_none(a)
    if a.dtype == torch.float64:
        # the band kernel computes in f32: keep 64-bit data on the
        # dtype-preserving DIA/SELL paths
        return _dia_or_none(a)
    if _on_cuda(a.values):
        if _band_fill(a, h) >= _BAND_FILL_THRESHOLD:
            return ("band", build_band_plan(a))
        bsr = _try_bsr(a)
        if bsr is not None:
            return ("bsr", bsr)
        if _band_fill(a, h) >= _BAND_NARROW_FILL:
            # already banded, just narrow: the panel kernel beats every
            # gather path, and RCM would buy nothing
            return ("band", build_band_plan(a))
        dia = _dia_or_none(a)
        if dia is not None or m != n:
            return dia
        # general square sparsity: keep an RCM reordering only when it
        # makes the matrix genuinely banded
        return _try_band_perm(a)
    return _dia_or_none(a)


def _hub_fraction(a) -> float:
    """Fraction of nonzeros living in rows with degree > _ROUTE_HUB_DEG."""
    nnz = a.nnz
    if nnz == 0:
        return 0.0
    deg = np.diff(np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), nnz))
    return float(deg[deg > _ROUTE_HUB_DEG].sum()) / nnz


@dataclasses.dataclass(frozen=True)
class SortedRoutePlan:
    """Degree-sorted ROUTE v1 plus an un-permute pass: rows of equal
    degree share stripes (fewer starved cells on power-law rows), the
    result comes out in sorted row order, and a deg-1 ROUTE2 plan of the
    inverse permutation routes it back."""

    base: RoutePlan           # ROUTE v1 plan of A[perm, :]
    unperm: Route2Plan        # the inverse permutation as a deg-1 matrix
    entry_perm: torch.Tensor  # (nnz,) int32 original entry of each sorted one

    def update_values(self, values: torch.Tensor) -> "SortedRoutePlan":
        return dataclasses.replace(self, base=self.base.update_values(
            values[self.entry_perm.long()]))

    @property
    def fill(self) -> float:
        return self.base.fill

    @property
    def nchunks(self) -> int:
        return self.base.nchunks + self.unperm.nchunks


def _try_route_sorted(rp, ci, vv, m, n, nnz, plan_plain, device=None):
    """Degree-sorted v1 plus un-permute against the plain v1 plan;
    returns (kind, plan) for whichever the chunk-cost model favours."""
    rp64 = np.minimum(rp.astype(np.int64), nnz)
    deg = np.diff(rp64[: m + 1])
    # order: degree (stripe balance), then the rows' column centre of
    # mass (x-window locality within equal-degree runs)
    com = np.zeros(m)
    np.add.at(com, np.repeat(np.arange(m), deg), ci[:nnz])
    com = com / np.maximum(deg, 1)
    perm = np.lexsort((com, -deg))
    if np.array_equal(perm, np.arange(m)):
        return ("route1", plan_plain)
    new_deg = deg[perm]
    starts = rp64[perm]
    lens = new_deg
    entry_perm = (np.repeat(starts - np.concatenate(
        [[0], np.cumsum(lens)[:-1]]), lens)
        + np.arange(int(lens.sum()))) if nnz else np.zeros(0, np.int64)
    rp_s = np.concatenate([[0], np.cumsum(new_deg)])
    plan_s = build_route_plan(rp_s, ci[:nnz][entry_perm],
                              vv[:nnz][entry_perm], (m, n), nnz,
                              device=device)
    cost_plain = plan_plain.nchunks * _V1_NS_PER_CHUNK
    est_unperm = int(m / (1024 * 0.3)) + 8
    cost_sorted = (plan_s.nchunks * _V1_NS_PER_CHUNK
                   + est_unperm * _R2_NS_PER_CHUNK
                   + _SORTED_DISPATCH_NS)
    if cost_sorted >= cost_plain:
        return ("route1", plan_plain)
    inv = np.empty(m, np.int64)
    inv[perm] = np.arange(m)
    unperm = build_route2_plan(np.arange(m + 1, dtype=np.int64), inv,
                               np.ones(m, np.float32), (m, m), m,
                               device=device)
    return ("route1_sorted", SortedRoutePlan(
        base=plan_s, unperm=unperm,
        entry_perm=torch.as_tensor(entry_perm.astype(np.int32)).to(
            plan_s.val.device)))


def _try_route(a):
    """ROUTE plan for general sparsity, as the JAX ladder picks it: paned
    ROUTE2 past the VMEM rows; ROUTE v1 (plain or degree-sorted) for
    hub-heavy rows; else ROUTE2, or v1 where the ROUTE2 fill collapsed
    and v1's chunk-time model wins.  Returns (kind, plan) or None."""
    m, n = a.shape
    if -(-n // 128) + -(-m // 128) > _ROUTE_VMEM_ROWS:
        return _try_route_paned(a)
    rp = _t.to_numpy(a.rowptr)
    ci = _t.to_numpy(a.colind)
    vv = _t.to_numpy(a.values)
    dev = a.device
    if _hub_fraction(a) > _ROUTE_HUB_FRACTION:
        plan_plain = build_route_plan(rp, ci, vv, (m, n), a.nnz, device=dev)
        return _try_route_sorted(rp, ci, vv, m, n, a.nnz, plan_plain,
                                 device=dev)
    plan = build_route2_plan(rp, ci, vv, (m, n), a.nnz, device=dev)
    if plan.fill < _ROUTE2_FILL_GUARD:
        plan1 = build_route_plan(rp, ci, vv, (m, n), a.nnz, device=dev)
        if plan1.nchunks * 180 < plan.nchunks * 110:
            return ("route1", plan1)
    return ("route", plan)


def _try_route_paned(a):
    """Paned ROUTE2 for matrices whose x and y pass the VMEM rows, or
    None when the estimated plan stream passes the budget or the plan's
    fill collapsed."""
    m, n = a.shape
    nnz = a.nnz
    if nnz == 0 or estimate_paned_bytes(m, n, nnz) > _ROUTE_PANED_BUDGET:
        return None
    plan = build_route_paned_plan(a.rowptr, a.colind, a.values, (m, n),
                                  nnz, device=a.device)
    if plan.fill < _PANED_MIN_FILL:
        return None
    return ("route_paned", plan)


def _try_route_cx(a):
    """Complex64 general sparsity: two real ROUTE plans of the kind
    ``_try_route`` picks over the same structure (re/im value planes),
    the imaginary one by a values refresh of the real one; over a ROUTE2
    plan also the complex kernel's imaginary plane (``cx_imag_plane``:
    0 on the aux carriers), None for the other kinds.  Returns
    ("route_cx", (kind, plan_re, plan_im, val_im)) or None."""
    ar = dataclasses.replace(a, values=a.values.real.contiguous())
    got = _try_route(ar)
    if got is None:
        return None
    kind, plan = got
    pi = plan.update_values(a.values.imag)
    val_im = cx_imag_plane(plan, pi) if kind == "route" else None
    return ("route_cx", (kind, plan, pi, val_im))


def route_cx_spmv(p, x):
    """(a+ib)(x+iy): over a ROUTE2 plan one pass of the complex kernel
    (``route2_cx_spmv``); over the other kinds (ax-by) + i(ay+bx), four
    real ROUTE SpMVs (two for a real x)."""
    kind, pr, pi, val_im = p
    if kind == "route":
        return route2_cx_spmv(pr, val_im, x)
    if x.is_complex():
        xr, xi = x.real.float(), x.imag.float()
        yr = plan_spmv((kind, pr), xr) - plan_spmv((kind, pi), xi)
        yi = plan_spmv((kind, pr), xi) + plan_spmv((kind, pi), xr)
    else:
        xr = x.float()
        yr = plan_spmv((kind, pr), xr)
        yi = plan_spmv((kind, pi), xr)
    return torch.complex(yr, yi)


def build_matvec_plan(a) -> Tuple[str, object]:
    a = to_csr(a)
    m, n = a.shape
    structured = _structured_plan(a, m, n, band_halfwidth(a))
    if structured is not None:
        return structured
    if _on_cuda(a.values):
        route = None
        if not a.dtype.is_complex and a.dtype != torch.float64:
            route = _try_route(a)
        elif a.dtype == torch.complex64:
            route = _try_route_cx(a)
        if route is not None:
            return route
    return ("sell", build_sell_plan(a))


def build_matmul_plan(a) -> Tuple[str, object]:
    """SpMM plan: the structured rungs of :func:`build_matvec_plan`, and
    SELL for general sparsity (a ROUTE plan would replay the whole SpMV
    per column of B)."""
    a = to_csr(a)
    m, n = a.shape
    structured = _structured_plan(a, m, n, band_halfwidth(a))
    if structured is not None:
        return structured
    return ("sell", build_sell_plan(a))


def plan_dtype_safe(plan: Tuple[str, object], x_dtype) -> bool:
    """True when running ``plan`` on an operand of ``x_dtype`` keeps the
    numerics intact: the f32 band kernel would drop the imaginary part of
    a complex operand and narrow f64, so those take the base path."""
    kind = plan[0]
    if kind in _DTYPE_PRESERVING_KINDS:
        return True
    if kind in _CX_KINDS:
        return x_dtype not in (torch.complex128, torch.float64)
    return not (x_dtype.is_complex or x_dtype == torch.float64)


def optimized_plan(opt, op_key: str, x_dtype):
    """The cached plan for ``op_key`` ("matvec" or "matmul") to run, or
    None when the op must take its base path.  A structured plan built
    for the sibling op serves this one too, so RCM, band and BSR
    inspection runs once per matrix."""
    alias = "matmul" if op_key == "matvec" else "matvec"
    builder = build_matvec_plan if op_key == "matvec" \
        else build_matmul_plan
    cached = opt._plans.get(alias)
    if cached is not None and cached[0] in STRUCTURED_KINDS:
        plan = cached
    else:
        plan = opt.get_plan(op_key, builder)
    return plan if plan_dtype_safe(plan, x_dtype) else None


def transform_safe(x, *tensors) -> bool:
    """True when the non-differentiable plan path may run: neither ``x``
    nor any of ``tensors`` (the matrix values) requires grad.  Otherwise
    the op takes the differentiable base path."""
    return not any(t.requires_grad for t in (x, *tensors))


def plan_spmv(plan: Tuple[str, object], x: torch.Tensor) -> torch.Tensor:
    kind, p = plan
    if kind == "band":
        return band_spmv(p, x)
    if kind == "band_perm":
        return permuted_band_spmv(p, x)
    if kind == "bsr":
        # the BSR's columns run past x's to whole blocks; the kernel reads
        # x in place, as zeros past its end
        bsr, (m, _) = p
        return bsr_apply(bsr_spmv_blocks, bsr, x)[:m]
    if kind == "dia":
        return dia_spmv(p, x)
    if kind == "sell":
        return sell_spmv(p, x)
    if kind == "band_cx":
        return band_cx_spmv(p, x)
    if kind == "route":
        return route2_spmv(p, x)
    if kind == "route1":
        return route_spmv(p, x)
    if kind == "route1_sorted":
        return route2_spmv(p.unperm, route_spmv(p.base, x)).to(x.dtype)
    if kind == "route_paned":
        return route_paned_spmv(p, x)
    if kind == "route_cx":
        return route_cx_spmv(p, x)
    if kind == "ell":
        return ell_spmv(p, x)
    raise ValueError(f"unknown plan kind {kind!r}")


def plan_spmm(plan: Tuple[str, object], b: torch.Tensor) -> torch.Tensor:
    """C = A @ B over a cached plan; B is dense (n, k)."""
    kind, p = plan
    if kind == "band":
        # the resident B of the TPU kernel had to fit its VMEM; past
        # 6 MB the JAX ladder streams it, and so does this one
        resident = (p.nblocks * 128 + p.width) * b.shape[1] * 4
        if resident > _BAND_RESIDENT_B_BYTES:
            return band_spmm_stream(p, b)
        return band_spmm(p, b)
    if kind == "band_perm":
        return permuted_band_spmm(p, b)
    if kind == "bsr":
        bsr, (m, n) = p
        return bsr_spmm(bsr, F.pad(b, (0, 0, 0, bsr.shape[1] - n)))[:m]
    if kind == "band_cx":
        return band_cx_spmm(p, b)
    if kind == "sell":
        return sell_spmm(p, b)
    if kind == "dia":
        return dia_spmm(p, b)
    if kind == "ell":
        return ell_spmm(p, b)
    if kind in _ROUTE_KINDS:
        # a matvec ROUTE plan fed to SpMM replays the whole SpMV per
        # column of B; reachable only when a caller bypasses
        # build_matmul_plan, whose general rung is SELL
        warnings.warn(
            f"plan_spmm got a '{kind}' (matvec) plan: replaying the SpMV "
            f"kernel per column, ~{b.shape[1]}x the SpMM cost. Build an "
            "SpMM plan with build_matmul_plan (SELL) instead.",
            UserWarning, stacklevel=2)
        return torch.stack([plan_spmv(plan, b[:, j].contiguous())
                            for j in range(b.shape[1])], dim=1)
    raise ValueError(f"unknown plan kind {kind!r}")

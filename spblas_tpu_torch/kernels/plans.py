"""Plan selection behind ``matrix_opt`` — the matvec half of
``spblas_tpu/kernels/plans.py``.

The JAX ladder gates its Pallas rungs on the TPU; here they are gated on
the matrix living on a CUDA device:

  banded, on CUDA      -> band-panel plan (csrc/band_spmv.cu)
  stencil/mesh         -> DIA plan (csrc/dia_spmv.cu behind its gate)
  banded, complex64    -> two real band plans (band_cx)
  general, on CUDA     -> ROUTE2 plan (csrc/route2_spmv.cu), kind route
  general, complex64   -> two real ROUTE2 plans (route_cx)
  general              -> SELL (torch ops)

Thresholds are the JAX package's (``plans.py:46-64``, ``:250-261``),
kept for parity; re-deriving them for the H100 is ROADMAP Queue 1 item
18.  The rungs whose kernels are not ported yet are skipped by name
(``UNPORTED_KINDS``) on CUDA: a general matrix that JAX sends to ROUTE v1
(hub-heavy rows) or to paned ROUTE2 (x and y past the TPU's VMEM) lands
on ``sell``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.kernels.banded import (band_halfwidth, band_spmv,
                                             build_band_plan)
from spblas_tpu_torch.kernels.dia import (build_dia_plan, dia_fill_fraction,
                                          dia_spmv)
from spblas_tpu_torch.kernels.route2 import build_route2_plan
from spblas_tpu_torch.kernels.route2_kernel import route2_spmv
from spblas_tpu_torch.kernels.sell import build_sell_plan, sell_spmv
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.types import on_cuda as _on_cuda

# DIA wins when its dense-diagonal storage is mostly true nonzeros
_DIA_FILL_THRESHOLD = 0.34
# an already-banded but narrow matrix keeps the panel plan down to here
_BAND_NARROW_FILL = 0.02

# Rungs of the JAX ladder whose kernels the port does not have yet.  The
# CUDA ladder skips them by name; each has a ROADMAP Queue 3 entry.
UNPORTED_KINDS = ("bsr", "band_perm", "route1", "route1_sorted",
                  "route_paned")

# plan kinds usable by both spmv and spmm (aliased in the plan cache once
# plan_spmm lands)
STRUCTURED_KINDS = ("band", "band_perm", "band_cx", "bsr", "dia")

# plan kinds that preserve the operand dtype (torch formulations); the
# *_cx kinds are complex-aware but compute in two f32 planes
_DTYPE_PRESERVING_KINDS = ("sell", "dia")
_CX_KINDS = ("band_cx", "route_cx")

# ROUTE keeps x and y resident in the TPU's VMEM: (x_rows + y_rows) rows
# of 128 must fit.  Past it JAX takes "route_paned"; kept for parity
# (Queue 1 item 18).
_ROUTE_VMEM_ROWS = 20_000
# hub-row mass above this fraction sends JAX to ROUTE v1 ("route1")
_ROUTE_HUB_DEG = 32
_ROUTE_HUB_FRACTION = 0.15


def _band_fill(a, h) -> float:
    return a.nnz / float(max(a.shape[0], 1) * (128 + 2 * h))


def _build_band_cx(a):
    """Complex banded plan: two real band-panel plans over the same
    structure (re/im planes)."""
    ar = dataclasses.replace(a, values=a.values.real.contiguous())
    ai = dataclasses.replace(a, values=a.values.imag.contiguous())
    return (build_band_plan(ar), build_band_plan(ai))


def band_cx_spmv(plans, x):
    """(a+ib)(x+iy) = (ax-by) + i(ay+bx): four real panel SpMVs."""
    pr, pi = plans
    xr = x.real.float()
    xi = x.imag.float() if x.is_complex() else torch.zeros_like(xr)
    yr = band_spmv(pr, xr) - band_spmv(pi, xi)
    yi = band_spmv(pr, xi) + band_spmv(pi, xr)
    return torch.complex(yr, yi)


def _dia_or_none(a):
    if dia_fill_fraction(a) >= _DIA_FILL_THRESHOLD:
        return ("dia", build_dia_plan(a))
    return None


def _structured_plan(a, m, n, h):
    """The structured-plan ladder; returns (kind, plan) or None when only
    general-sparsity plans apply."""
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
        # the JAX ladder tries "bsr" (UNPORTED_KINDS) between its two band
        # rungs, at fills below 0.15; without it both band rungs are one
        if _band_fill(a, h) >= _BAND_NARROW_FILL:
            return ("band", build_band_plan(a))
        # after DIA, the "band_perm" (RCM) rung would stand here
        # (UNPORTED_KINDS)
    return _dia_or_none(a)


def _hub_fraction(a) -> float:
    """Fraction of nonzeros living in rows with degree > _ROUTE_HUB_DEG."""
    nnz = a.nnz
    if nnz == 0:
        return 0.0
    deg = np.diff(np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), nnz))
    return float(deg[deg > _ROUTE_HUB_DEG].sum()) / nnz


def _try_route(a):
    """ROUTE2 plan for general sparsity, or None where the JAX ladder
    takes a ROUTE rung the port does not have yet: "route_paned" past
    the VMEM rows, "route1"/"route1_sorted" for hub-heavy rows.  JAX's
    fill < 0.08 insurance compares against a ROUTE v1 plan, which the
    port cannot build yet; it keeps the ROUTE2 plan (ROADMAP Queue 3)."""
    m, n = a.shape
    if -(-n // 128) + -(-m // 128) > _ROUTE_VMEM_ROWS:
        return None
    if _hub_fraction(a) > _ROUTE_HUB_FRACTION:
        return None
    return ("route", build_route2_plan(a.rowptr, a.colind, a.values,
                                       (m, n), a.nnz, device=a.device))


def _try_route_cx(a):
    """Complex64 general sparsity: two real ROUTE2 plans over the same
    structure (re/im value planes), the imaginary one by a values
    refresh of the real one.  Returns ("route_cx", (kind, plan_re,
    plan_im)) or None."""
    ar = dataclasses.replace(a, values=a.values.real.contiguous())
    got = _try_route(ar)
    if got is None:
        return None
    kind, plan = got
    return ("route_cx", (kind, plan, plan.update_values(a.values.imag)))


def route_cx_spmv(p, x):
    """(a+ib)(x+iy) = (ax-by) + i(ay+bx): four real ROUTE2 SpMVs (two
    for a real x)."""
    kind, pr, pi = p
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
        # the ROUTE v1 and paned rungs would stand here too
        # (UNPORTED_KINDS)
        route = None
        if not a.dtype.is_complex and a.dtype != torch.float64:
            route = _try_route(a)
        elif a.dtype == torch.complex64:
            route = _try_route_cx(a)
        if route is not None:
            return route
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


def optimized_plan(opt, x_dtype):
    """The cached matvec plan to run, or None when the op must take its
    base path."""
    plan = opt.get_plan("matvec", build_matvec_plan)
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
    if kind == "dia":
        return dia_spmv(p, x)
    if kind == "sell":
        return sell_spmv(p, x)
    if kind == "band_cx":
        return band_cx_spmv(p, x)
    if kind == "route":
        return route2_spmv(p, x)
    if kind == "route_cx":
        return route_cx_spmv(p, x)
    raise ValueError(f"unknown plan kind {kind!r}")

"""SpTRSV: solve op(A) x = b for a triangular sparse A — counterpart of
``spblas_tpu/ops/triangular_solve.py``.

The inspect phase runs level-set analysis of the dependency DAG on the
host (``native.level_schedule``): rows whose dependencies all lie in
earlier levels solve together.  Three executors, chosen as the JAX
package chooses them:

- the ROUTE2 substitution (``kernels/route2.py::build_route2_solve_plan``,
  kernel: the solve entry point of ``csrc/route2_spmv.cu``), one launch
  per dependency level over one pane, for real f32 values on the card
  (or with ``SPBLAS_FORCE_ROUTE_TRSV``) within the pane envelope;
- past that envelope, the pane-blocked substitution (:class:`BlockTrsv`):
  per block of rows a diagonal-block solve and an off-diagonal strip SpMV
  through the matvec plan chooser;
- otherwise, and for f64, complex, conjugated, complex-scaled or
  gradient-carrying operands, the ragged level sweep
  (:func:`_trsv_execute`), a loop over levels of torch ops.

``uplo`` is "lower" or "upper"; ``diag`` is "explicit" or "unit" (an
implicit unit diagonal: diagonal entries are not read).  The envelopes
(``SPBLAS_ROUTE_SOLVE_PANE_CAP``, ``SPBLAS_BLOCK_SOLVE_ROWS``, the nnz
and level caps) are the TPU's, kept for parity (ROADMAP Queue 1 item
18).
"""

from __future__ import annotations

import dataclasses
import time
import os
from typing import Optional

import numpy as np
import torch

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch import views as _v
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.info import OperationInfo
from spblas_tpu_torch.utils.logging import traced


@dataclasses.dataclass(frozen=True)
class TrsvPlan:
    """Level schedule in ragged form: one flat off-diagonal entry stream
    sorted by (level, row) with per-level offsets, and one flat row
    stream sorted by level (the JAX plan's arrays, each padded by its cap
    as there).  ``lv_estart_host``/``lv_rstart_host`` are host copies of
    the offsets, so the sweep slices each level with no device read.

    ``route`` is the ROUTE2 solve plan (values baked as -a_ij/d_i for the
    values array ``route_vals_ref``; other values are re-baked on the
    device through ``route_dpe``, entry -> diagonal entry); ``blocked``
    the pane-blocked plan past the one-pane envelope."""

    ent_idx: torch.Tensor     # (E_pad,) int32 into values
    ent_col: torch.Tensor     # (E_pad,) int32
    ent_slot: torch.Tensor    # (E_pad,) int32 row slot within its level
    lv_estart: torch.Tensor   # (L+1,) int32 entry-stream offsets
    row_ids: torch.Tensor     # (m_pad,) int32 rows sorted by level
    diag_idx: torch.Tensor    # (m_pad,) int32 aligned with row_ids; -1 unit
    lv_rstart: torch.Tensor   # (L+1,) int32 row-stream offsets
    e_cap: int
    r_cap: int
    uplo: str
    unit_diag: bool
    m: int
    lv_estart_host: np.ndarray = None
    lv_rstart_host: np.ndarray = None
    route: object = None
    route_diag: object = None      # (m,) int32 diagonal entry idx, or None
    route_vals_ref: object = None  # the values array the bake saw
    route_dpe: object = None       # (capacity,) int32 entry -> diag idx
    blocked: object = None

    @property
    def num_levels(self) -> int:
        return int(self.lv_estart.shape[0]) - 1


@dataclasses.dataclass(frozen=True)
class BlockTrsv:
    """Pane-blocked substitution: rows split into K contiguous blocks of
    ``bm``; block k solves x_k = (alpha L_kk)^{-1} (b_k - alpha S_k
    x_known), L_kk through its own :class:`TrsvPlan` (its own ROUTE2
    solve plan) and the strip S_k through a matvec plan of the chooser."""

    subs: tuple            # per block: TrsvPlan of the diagonal block
    sub_vals: tuple        # per block: the block's values at inspect
    sub_eidx: tuple        # per block: (sub_nnz,) int32 global entry idx
    strip_plans: tuple     # per block: matvec plan or () when empty
    strip_eidx: tuple      # per block: (strip_nnz,) int32 or ()
    strip_kinds: tuple
    bm: int = 0
    lower: bool = True


@traced
def triangular_solve_inspect(a_view, uplo: str = "lower",
                             diag: str = "explicit",
                             host_arrays=None) -> OperationInfo:
    """Level-set analysis on the host; returns an info whose plan drives
    :func:`triangular_solve`.  ``host_arrays`` (optional): ``(rowptr,
    colind[, values])`` numpy copies of the container's arrays, which
    then are not read back from the device."""
    a = to_csr(_v.get_ultimate_base(a_view))
    m, n = a.shape
    if m != n:
        raise ValueError(f"triangular_solve requires square A, got {a.shape}")
    lower = _check_uplo(uplo)
    unit = _check_diag(diag)
    dev = a.device
    values_h = None
    from spblas_tpu_torch.utils.profiling import record_phase
    t0 = time.perf_counter()
    if host_arrays is not None:
        rowptr = np.asarray(host_arrays[0]).astype(np.int64)
        colind = np.asarray(host_arrays[1])
        if len(host_arrays) > 2:
            values_h = np.asarray(host_arrays[2])
    else:
        rowptr = _t.to_numpy(a.rowptr).astype(np.int64)
        colind = _t.to_numpy(a.colind)
    nnz = int(a.nnz)
    record_phase("trsv_inspect", "pull_s", time.perf_counter() - t0)

    t0 = time.perf_counter()
    levels, diag_pos, num_levels = native.level_schedule(
        m, nnz, rowptr, colind, lower, unit)
    record_phase("trsv_inspect", "schedule_s", time.perf_counter() - t0)
    t0 = time.perf_counter()

    # ragged schedule assembly from (levels, diag_pos)
    lo = np.minimum(rowptr[:-1], nnz)
    hi = np.minimum(rowptr[1:], nnz)
    row_of = np.repeat(np.arange(m), hi - lo)          # per live entry
    eidx_all = np.arange(nnz, dtype=np.int64)
    cols_all = colind[:nnz].astype(np.int64)
    off = (cols_all < row_of) if lower else (cols_all > row_of)
    num_levels = max(num_levels, 1)

    # rows sorted by level
    counts = np.bincount(levels, minlength=num_levels) if m else \
        np.zeros(num_levels, np.int64)
    lv_rstart = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(levels, kind="stable") if m else \
        np.zeros(0, np.int64)
    j_of = np.empty(max(m, 1), np.int64)
    j_of[order] = np.arange(m) - np.repeat(lv_rstart[:-1], counts)
    r_cap = max(int(counts.max()) if m else 0, 1)

    # off-diagonal entries sorted by (level, row)
    e_rows = row_of[off]
    e_lv = levels[e_rows] if m else np.zeros(0, np.int64)
    e_order = np.lexsort((e_rows, e_lv)) if len(e_rows) else \
        np.zeros(0, np.int64)
    e_counts = np.bincount(e_lv, minlength=num_levels) if len(e_rows) \
        else np.zeros(num_levels, np.int64)
    lv_estart = np.concatenate([[0], np.cumsum(e_counts)])
    e_cap = max(int(e_counts.max()), 1)

    epad = np.zeros(e_cap, np.int64)
    ent_idx = np.concatenate([eidx_all[off][e_order], epad])
    ent_col = np.concatenate([cols_all[off][e_order], epad])
    ent_slot = np.concatenate([j_of[e_rows][e_order], epad])
    row_ids = np.concatenate([np.arange(m, dtype=np.int64)[order],
                              np.full(r_cap, m, np.int64)])
    dpos = np.concatenate([diag_pos.astype(np.int64)[order] if m else
                           np.zeros(0, np.int64),
                           np.full(r_cap, -1, np.int64)])
    record_phase("trsv_inspect", "ragged_pack_s", time.perf_counter() - t0)

    route = route_diag = vals_ref = route_dpe = blocked = None
    if _route_solve_eligible(a, m, nnz, num_levels):
        from spblas_tpu_torch.kernels.route2 import build_route2_solve_plan
        if values_h is None:
            values_h = _t.to_numpy(a.values)
        route = build_route2_solve_plan(
            rowptr, colind, values_h, (m, m), nnz, levels, diag_pos, unit,
            lower, device=dev)
        vals_ref = a.values
        if not unit:
            # entry -> its row's diagonal entry, for on-device re-baking;
            # padded entries map to 0
            dpe = np.zeros(a.capacity, np.int64)
            dpe[:nnz] = diag_pos.astype(np.int64)[row_of]
            route_diag = _t.as_tensor(diag_pos.astype(np.int32), dev)
            route_dpe = _t.as_tensor(dpe.astype(np.int32), dev)
    elif _block_solve_eligible(a, m, nnz):
        if values_h is None:
            values_h = _t.to_numpy(a.values)
        blocked = _build_block_solve(rowptr, colind, values_h, m, nnz,
                                     lower, uplo, diag, dev)
        vals_ref = a.values

    def put(arr):
        return _t.as_tensor(arr.astype(np.int32), dev)

    plan = TrsvPlan(
        ent_idx=put(ent_idx), ent_col=put(ent_col), ent_slot=put(ent_slot),
        lv_estart=put(lv_estart), row_ids=put(row_ids), diag_idx=put(dpos),
        lv_rstart=put(lv_rstart), e_cap=int(e_cap), r_cap=int(r_cap),
        uplo="lower" if lower else "upper", unit_diag=unit, m=m,
        lv_estart_host=lv_estart.astype(np.int64),
        lv_rstart_host=lv_rstart.astype(np.int64),
        route=route, route_diag=route_diag, route_vals_ref=vals_ref,
        route_dpe=route_dpe, blocked=blocked)
    return OperationInfo(result_shape=(m, 1), result_nnz=m, plan=plan)


def _route_solve_eligible(a: CSR, m: int, nnz: int, num_levels: int) -> bool:
    """The one-pane substitution envelope: on the card (or forced), real
    f32 values, the TPU's pane, nnz and level caps."""
    if os.environ.get("SPBLAS_NO_ROUTE_TRSV") == "1":
        return False
    if not (_t.on_cuda(a.values) or os.environ.get("SPBLAS_FORCE_ROUTE_TRSV")):
        return False
    if a.values.dtype != torch.float32:
        return False
    # the TPU keeps two panes of m/128 rows in VMEM (y0 and the output)
    return (m // 128 <= _solve_pane_cap() and nnz <= 16_000_000
            and num_levels <= 200_000)


def _solve_pane_cap() -> int:
    """Pane row budget of the one-pane substitution."""
    return int(os.environ.get("SPBLAS_ROUTE_SOLVE_PANE_CAP", 9_000))


def _block_solve_eligible(a: CSR, m: int, nnz: int) -> bool:
    """The pane-blocked envelope: past the one-pane cap, at most 16
    blocks."""
    if os.environ.get("SPBLAS_NO_ROUTE_TRSV") == "1":
        return False
    if not (_t.on_cuda(a.values) or os.environ.get("SPBLAS_FORCE_ROUTE_TRSV")):
        return False
    if a.values.dtype != torch.float32:
        return False
    bm = _block_solve_rows()
    return (m // 128 > _solve_pane_cap() and -(-m // bm) <= 16
            and nnz <= 128_000_000)


def _block_solve_rows() -> int:
    return int(os.environ.get("SPBLAS_BLOCK_SOLVE_ROWS", 1 << 20))


def _build_block_solve(rowptr, colind, values_h, m, nnz, lower: bool,
                       uplo: str, diag: str, dev) -> BlockTrsv:
    """Host build of the pane-blocked plan: per block, the diagonal
    block's own inspection (whose gates pick the substitution or the
    sweep) and the strip's matvec plan through the chooser."""
    from spblas_tpu_torch.kernels.plans import build_matvec_plan

    bm = _block_solve_rows()
    K = -(-m // bm)
    row_of = np.repeat(np.arange(m, dtype=np.int64),
                       np.diff(np.minimum(rowptr[: m + 1], nnz)))
    cols = colind[:nnz].astype(np.int64)

    subs, sub_vals, sub_eidx = [], [], []
    strip_kinds, strip_plans, strip_eidx = [], [], []
    for k in range(K):
        lo_r, hi_r = k * bm, min((k + 1) * bm, m)
        bk = hi_r - lo_r
        sel = (row_of >= lo_r) & (row_of < hi_r)
        in_diag = sel & (cols >= lo_r) & (cols < hi_r)
        in_strip = sel & ((cols < lo_r) if lower else (cols >= hi_r))

        de = np.flatnonzero(in_diag)
        d_rp = np.concatenate([[0], np.cumsum(np.bincount(
            row_of[de] - lo_r, minlength=bk))])
        d_ci = (cols[de] - lo_r).astype(np.int32)
        d_vv = values_h[de].astype(np.float32)
        sub_csr = CSR.from_arrays(d_vv, d_rp, d_ci, (bk, bk), nnz=len(de),
                                  device=dev)
        subs.append(triangular_solve_inspect(
            sub_csr, uplo=uplo, diag=diag,
            host_arrays=(d_rp, d_ci, d_vv)).plan)
        sub_vals.append(sub_csr.values)
        sub_eidx.append(_t.as_tensor(de.astype(np.int32), dev))

        se = np.flatnonzero(in_strip)
        if len(se) == 0 or (lower and k == 0) or \
                (not lower and k == K - 1):
            strip_kinds.append("none")
            strip_plans.append(())
            strip_eidx.append(())
            continue
        s_rp = np.concatenate([[0], np.cumsum(np.bincount(
            row_of[se] - lo_r, minlength=bk))])
        s_ci = cols[se] - (0 if lower else hi_r)
        s_n = lo_r if lower else m - hi_r
        strip_csr = CSR.from_arrays(
            values_h[se].astype(np.float32), s_rp, s_ci.astype(np.int32),
            (bk, s_n), nnz=len(se), device=dev)
        kind, plan = build_matvec_plan(strip_csr)
        strip_kinds.append(kind)
        strip_plans.append(plan)
        strip_eidx.append(_t.as_tensor(se.astype(np.int32), dev))
    return BlockTrsv(subs=tuple(subs), sub_vals=tuple(sub_vals),
                     sub_eidx=tuple(sub_eidx),
                     strip_plans=tuple(strip_plans),
                     strip_eidx=tuple(strip_eidx),
                     strip_kinds=tuple(strip_kinds), bm=bm, lower=lower)


def _solve_one(plan: TrsvPlan, values, b, alpha):
    """The route-or-sweep step shared by the top-level solve and the
    blocked executor (values, b and alpha already vetted)."""
    if plan.route is not None:
        from spblas_tpu_torch.kernels.route2_kernel import route2_solve
        route = plan.route
        if values is not plan.route_vals_ref:
            route = route.update_solve_values(values, plan.route_dpe)
        alpha_f = alpha.float()
        if plan.route_diag is not None:
            y0 = b / (values[plan.route_diag.long()] * alpha_f)
        else:
            y0 = b / alpha_f
        return route2_solve(route, y0)
    return _trsv_execute(plan, values, b, alpha)


def _blocked_solve(blk: BlockTrsv, values, vals_ref, b, alpha):
    """K chained diagonal-block solves with strip SpMV updates between
    them."""
    from spblas_tpu_torch.kernels.plans import plan_spmv

    refresh = values is not vals_ref
    K = len(blk.subs)
    m = b.shape[0]
    order = range(K) if blk.lower else range(K - 1, -1, -1)
    xs: dict = {}
    for k in order:
        lo_r = k * blk.bm
        hi_r = min((k + 1) * blk.bm, m)
        r_k = b[lo_r:hi_r].float()
        if blk.strip_kinds[k] != "none":
            plan_k = blk.strip_plans[k]
            if refresh:
                plan_k = plan_k.update_values(
                    values[blk.strip_eidx[k].long()])
            known = range(k) if blk.lower else range(k + 1, K)
            xp = torch.cat([xs[j] for j in known])
            sy = plan_spmv((blk.strip_kinds[k], plan_k), xp)
            r_k = r_k - alpha.float() * sy
        vk = values[blk.sub_eidx[k].long()] if refresh else blk.sub_vals[k]
        xs[k] = _solve_one(blk.subs[k], vk, r_k, alpha)
    return torch.cat([xs[k] for k in range(K)])


def _result_dtype(values, b, alpha) -> torch.dtype:
    return torch.promote_types(torch.promote_types(values.dtype, b.dtype),
                               alpha.dtype)


def _trsv_execute(plan: TrsvPlan, values, b, alpha):
    """The ragged level sweep: per level, the off-diagonal dots of its
    rows by ``index_add`` over the level's slice of the entry stream,
    then its rows solved at once.  Differentiable in values, b and
    alpha; the level offsets come from the host copies, so the loop
    reads nothing back from the device."""
    m = plan.m
    dt = _result_dtype(values, b, alpha)
    vals = values.to(dt)
    bb = b.to(dt)
    al = alpha.to(dt)
    x = torch.zeros(m, dtype=dt, device=values.device)
    es, rs = plan.lv_estart_host, plan.lv_rstart_host
    for lv in range(plan.num_levels):
        r0, r1 = int(rs[lv]), int(rs[lv + 1])
        if r1 == r0:
            continue
        rows = plan.row_ids[r0:r1].long()
        dpos = plan.diag_idx[r0:r1].long()
        # an implicit unit diagonal of alpha*A is alpha itself
        d = torch.where(dpos >= 0, vals[dpos.clamp(min=0)],
                        torch.ones((), dtype=dt, device=vals.device)) * al
        num = bb[rows]
        e0, e1 = int(es[lv]), int(es[lv + 1])
        if e1 > e0:
            prod = (vals[plan.ent_idx[e0:e1].long()] * al
                    * x[plan.ent_col[e0:e1].long()])
            dot = torch.zeros(r1 - r0, dtype=dt, device=vals.device)
            num = num - dot.index_add(0, plan.ent_slot[e0:e1].long(), prod)
        x[rows] = num / d
    return x


@traced
def triangular_solve(a_view, b, uplo: str = "lower",
                     diag: str = "explicit",
                     info: Optional[OperationInfo] = None) -> torch.Tensor:
    """x = op(A)^{-1} b.  Pass ``info`` from
    :func:`triangular_solve_inspect` to reuse the level analysis."""
    base, alpha, conj = _v.fold(a_view)
    a = to_csr(base)
    if info is None:
        info = triangular_solve_inspect(a, uplo=uplo, diag=diag)
    plan: TrsvPlan = info.plan
    # a supplied info must agree with the call's triangle and diagonal
    if plan.uplo != ("lower" if _check_uplo(uplo) else "upper"):
        raise ValueError(
            f"triangular_solve: info was inspected with "
            f"uplo={plan.uplo!r} but called with uplo={uplo!r}")
    if plan.unit_diag != _check_diag(diag):
        plan_diag = "unit" if plan.unit_diag else "explicit"
        raise ValueError(
            f"triangular_solve: info was inspected with "
            f"diag={plan_diag!r} but called with diag={diag!r}")
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    if b.shape[0] != plan.m:
        raise ValueError(
            f"triangular_solve: b length {b.shape[0]} != m {plan.m}")
    values = a.values.conj() if conj else a.values
    from spblas_tpu_torch.kernels.plans import transform_safe
    # the kernel has no backward: grad through b, values or alpha takes
    # the differentiable sweep, as do complex alpha, conj and non-f32
    # values (the kernel computes in real f32)
    fast_ok = (not conj and transform_safe(b, values, alpha)
               and not alpha.is_complex()
               and b.dtype == torch.float32
               and values.dtype == torch.float32)
    if plan.route is not None and fast_ok:
        return _solve_one(plan, values, b, alpha)
    if plan.blocked is not None and fast_ok:
        blk: BlockTrsv = plan.blocked
        refresh = values is not plan.route_vals_ref
        strips_ok = all(k == "none" or hasattr(p, "update_values")
                        for k, p in zip(blk.strip_kinds, blk.strip_plans)) \
            if refresh else True
        if strips_ok:
            return _blocked_solve(blk, values, plan.route_vals_ref, b,
                                  alpha).to(torch.promote_types(
                                      values.dtype, b.dtype))
    return _trsv_execute(plan, values, b, alpha)


def _check_uplo(uplo: str) -> bool:
    if uplo not in ("lower", "upper"):
        raise ValueError(f"uplo must be 'lower' or 'upper', got {uplo!r}")
    return uplo == "lower"


def _check_diag(diag: str) -> bool:
    if diag not in ("explicit", "unit"):
        raise ValueError(f"diag must be 'explicit' or 'unit', got {diag!r}")
    return diag == "unit"

"""Two-phase SpGEMM: C = A @ B (+ beta * D) for sparse A, B — counterpart
of ``spblas_tpu/ops/spgemm.py``.

One expand → sort → compress (ESC) Gustavson formulation
(``backend/engine.py``) on the operands' device.  CSC and COO operands
are canonicalised to CSR; a CSC result uses the transpose trick
C^T = B^T A^T.

Protocol:

  symbolic  — enumerate the flops, sort, count the unique (i, j): one
              device-to-host read of result_nnz so the caller can
              allocate;
  numeric   — gather, multiply and segment-sum into the fixed structure.

The symbolic result is an :class:`SpgemmPlan` of gather/segment maps, so
numeric runs with new values (same sparsity) cost one fused pass: the
reuse capability of :class:`SpgemmState` and the 4-argument fused form
C = alpha*A*B + beta*D.  On CUDA operands (or with
``SPBLAS_FORCE_ROUTE_SPGEMM`` set) ``spgemm_compute(..., reuse=True)``
also builds a ROUTE2-mul engine plan (``kernels/route2.py``, paned past
the resident envelope: ``kernels/route_mul_paned.py``), and the numeric
phase then runs the hand-written slot fill ``csrc/mul_fill.cu`` over the
plan's expansion stream, resident or paned; ``SPBLAS_ROUTE_SPGEMM=1``
selects the ROUTE v1 engine for a resident product instead
(``kernels/route_mul.py``, whose numeric is the same slot fill over that
plan's stream); otherwise it is the torch numeric
(gather-multiply-``index_add_``).  The engine gates are the JAX
package's, kept for parity (ROADMAP Queue 1 item 18 re-derives them for
the card).  BSR·BSR one-shot products go to the block SpGEMM
(``kernels/bsr_spgemm.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch import views as _v
from spblas_tpu_torch.backend import engine
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.info import OperationInfo
from spblas_tpu_torch.utils.logging import traced


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Numeric plan: everything the numeric phase needs.

    For stream entry s (sorted order):
      is_d[s]  — entry comes from the D addend, not the A*B expansion
      src_a[s] — A entry index (A*B entries; 0 for D entries)
      src_b[s] — B entry index, or D entry index when is_d
      slot[s]  — output slot in C (== c_capacity: dropped)
    Plus the full C structure (rowptr, colind) and the live entry count
    (a host int).
    """

    src_a: torch.Tensor
    src_b: torch.Tensor
    is_d: torch.Tensor
    valid: torch.Tensor
    slot: torch.Tensor
    c_rowptr: torch.Tensor
    c_colind: torch.Tensor
    c_nnz: int
    shape: tuple
    has_d: bool = False
    # fused numeric engine (Route2MulPlan or Route2MulPanedPlan); None:
    # the torch numeric
    route: object = None
    a_capacity: int = 0
    b_capacity: int = 0
    d_capacity: int = 0

    @property
    def c_capacity(self) -> int:
        return int(self.c_colind.shape[0])

    def with_capacity(self, capacity: int) -> "SpgemmPlan":
        """Re-target the plan at another output capacity (the
        user-owns-allocation handshake: slots stay valid, colind is
        re-padded).  The engine keeps its baked capacity; the numeric
        pads or cuts its output (callers enforce capacity >=
        result_nnz, and engine slots are < result_nnz)."""
        capacity = int(capacity)
        cur = self.c_capacity
        if capacity == cur:
            return self
        if capacity > cur:
            colind = torch.cat([self.c_colind, self.c_colind.new_zeros(
                capacity - cur)])
        else:
            colind = self.c_colind[:capacity]
        slot = torch.where(self.slot >= cur, capacity,
                           self.slot.clamp(max=capacity)).to(self.slot.dtype)
        return dataclasses.replace(self, c_colind=colind, slot=slot)


# ------------------------------------------------------------------ #
# stages
# ------------------------------------------------------------------ #

def _entry_mask(a: CSR) -> torch.Tensor:
    return torch.arange(a.capacity, device=a.device) < a.nnz


def _symbolic_sort(a: CSR, b: CSR, d: Optional[CSR], e_capacity: int):
    """Expansion + lexicographic sort + structure counts.  Returns the
    sorted streams, the heads and slots, rowptr and nnz (0-d)."""
    m, n = a.shape[0], b.shape[1]
    src_a, src_b, rows, valid = engine.expansion_maps(
        a.rowptr, a.colind, _entry_mask(a), b.rowptr, a.capacity,
        b.capacity, e_capacity, m)
    cols = torch.where(valid, b.colind[src_b.long()], 0).to(_t.index_dtype)
    is_d = torch.zeros(e_capacity, dtype=torch.bool, device=a.device)
    if d is not None:
        d_mask = _entry_mask(d)
        d_rows = torch.where(d_mask, engine.segment_ids_from_ptr(
            d.rowptr, d.capacity), m).to(_t.index_dtype)
        d_cols = torch.where(d_mask, d.colind, 0).to(_t.index_dtype)
        rows = torch.cat([rows, d_rows])
        cols = torch.cat([cols, d_cols])
        src_a = torch.cat([src_a, src_a.new_zeros(d.capacity)])
        src_b = torch.cat([src_b, torch.arange(
            d.capacity, dtype=_t.offset_dtype, device=a.device)])
        valid = torch.cat([valid, d_mask])
        is_d = torch.cat([is_d, torch.ones(d.capacity, dtype=torch.bool,
                                           device=a.device)])
    rows_s, cols_s, src_a_s, src_b_s, is_d_s, valid_s = engine.lexsort_coo(
        rows, cols, n, src_a, src_b, is_d, valid)
    heads, slots, nnz, rowptr = engine.coalesce_sorted(rows_s, cols_s,
                                                       valid_s, m)
    return (cols_s, src_a_s, src_b_s, is_d_s, valid_s, heads, slots,
            rowptr, nnz)


def _structure_fill(cols_s, heads, slots, valid_s, c_capacity: int):
    drop = c_capacity
    slot_all = torch.where(valid_s, slots.clamp(max=drop), drop)
    head_slot = torch.where(heads, slot_all, drop)
    c_colind = engine.scatter_set(head_slot.long(), cols_s, c_capacity)
    return c_colind, slot_all.to(_t.offset_dtype)


def _numeric(plan: SpgemmPlan, a_values, b_values, d_values, alpha, beta):
    """Gather-multiply-reduce numeric fill; the whole reuse hot path.

    With a fused engine (real f32, built at compute time) the expansion
    runs in the hand-written mul kernel; otherwise the torch numeric:
    gathers, multiply and one ``index_add_`` (differentiable)."""
    if plan.route is not None:
        from spblas_tpu_torch.kernels.route2 import Route2MulPlan
        from spblas_tpu_torch.kernels.route2_kernel import route2_mul
        from spblas_tpu_torch.kernels.route_mul import RouteMulPlan
        from spblas_tpu_torch.kernels.route_mul_kernel import route_mul
        from spblas_tpu_torch.kernels.route_mul_paned import route2_mul_paned
        one = a_values.new_ones(1)
        a_arr = torch.cat([alpha * a_values, one])
        b_arr = (torch.cat([b_values, beta * d_values])
                 if d_values is not None else b_values)
        if isinstance(plan.route, Route2MulPlan):
            out = route2_mul(plan.route, a_arr, b_arr)
        elif isinstance(plan.route, RouteMulPlan):
            out = route_mul(plan.route, a_arr, b_arr)
        else:
            out = route2_mul_paned(plan.route, a_arr, b_arr)
        # the plan may have been re-targeted at another output capacity
        # (with_capacity): the delta is canonical zero padding
        cap = plan.c_capacity
        out = out[:cap] if out.shape[0] >= cap else torch.nn.functional.pad(
            out, (0, cap - out.shape[0]))
        return out.to(torch.result_type(a_values, b_values))
    cap = plan.c_capacity
    v_ab = a_values[plan.src_a.long()] * b_values[plan.src_b.long()]
    if d_values is not None:
        nd = d_values.shape[0]
        v_d = d_values[plan.src_b.long().clamp(max=nd - 1)]
        v = torch.where(plan.is_d, beta * v_d, alpha * v_ab)
    else:
        v = alpha * v_ab
    v = torch.where(plan.valid, v, torch.zeros((), dtype=v.dtype,
                                               device=v.device))
    out = torch.zeros(cap + 1, dtype=v.dtype, device=v.device)
    return out.index_add(0, plan.slot.long(), v)[:cap]


# paned mul engine gate: on the TPU the A pane stays VMEM-resident
# (12,288 sublane rows = 6 MB f32); kept for parity
_PANED_A_ROWS_MAX = 12_288


def _try_build_route(a: CSR, b: CSR, d: Optional[CSR], c_capacity: int):
    """Build the fused numeric engine when the operands are on the card
    (or ``SPBLAS_FORCE_ROUTE_SPGEMM`` is set) and fit its envelope (real
    values; the JAX package's VMEM-residency gates).

    The expansion stream is recomputed on the host from the CSR arrays
    by the native expander; its slot numbers match the device plan's,
    since both number the unique (row, col) pairs in the same order.  D
    entries gather a constant 1 from the slot appended after A's values
    and beta*d from the region appended after B's values, so the stream
    is uniformly A_arr[sa] * B_arr[sb]."""
    if os.environ.get("SPBLAS_NO_ROUTE_SPGEMM") == "1":
        return None
    if not (_t.on_cuda(a.values)
            or os.environ.get("SPBLAS_FORCE_ROUTE_SPGEMM")):
        return None
    if a.dtype.is_complex:
        return None
    a_len = a.capacity + 1
    b_len = b.capacity + (d.capacity if d is not None else 0)
    rows = (-(-a_len // 128) + -(-b_len // 128) + -(-c_capacity // 128))
    # beyond the resident envelope the paned engine panels the output
    resident_ok = rows <= 18_000
    paned_ok = -(-a_len // 128) <= _PANED_A_ROWS_MAX
    if not (resident_ok or paned_ok):
        return None

    from spblas_tpu_torch import native
    from spblas_tpu_torch.utils.profiling import record_phase
    t_exp = time.perf_counter()
    m = a.shape[0]
    a_nnz, b_nnz = a.nnz, b.nnz
    a_rp = np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), a_nnz)
    a_ci = _t.to_numpy(a.colind[:a_nnz]).astype(np.int64)
    b_rp = np.minimum(_t.to_numpy(b.rowptr).astype(np.int64), b_nnz)
    b_ci = _t.to_numpy(b.colind[:b_nnz]).astype(np.int64)
    cnt = b_rp[a_ci + 1] - b_rp[a_ci]
    total = int(cnt.sum())
    paned = not (resident_ok and total <= 8_000_000)
    if os.environ.get("SPBLAS_FORCE_PANED_SPGEMM") == "1":
        paned = True
    if paned:
        if not paned_ok:
            return None
        if total > int(os.environ.get("SPBLAS_MUL_EXPANSION_BUDGET",
                                      64_000_000)):
            # host pack time scales with the expansion
            return None
    d_nnz = d.nnz if d is not None else 0
    d_rp = (np.minimum(_t.to_numpy(d.rowptr).astype(np.int64), d_nnz)
            if d is not None else None)
    d_ci = (_t.to_numpy(d.colind[:d_nnz]).astype(np.int64)
            if d is not None else None)
    slots, sa, sb, nnz_h = native.mul_expand(
        m, a_nnz, a_rp, a_ci.astype(np.int32), b_nnz, b_rp,
        b_ci.astype(np.int32), d_nnz, d_rp, d_ci, a.capacity, b.capacity,
        total + d_nnz)
    if nnz_h > c_capacity:
        return None
    record_phase("spgemm_engine", "expansion_s",
                 time.perf_counter() - t_exp)
    if paned:
        # plan-size gate: mul chunks ~= occupied (slot-stripe, B-window)
        # cells; refuse past the chunk budget (the torch numeric takes
        # those sizes without a multi-GB plan)
        from spblas_tpu_torch.kernels.route2 import SLOTS, mul_pane_g
        win_b = mul_pane_g(b_len) * SLOTS
        cellkey = ((slots >> 10) * (b_len // win_b + 2) + sb // win_b)
        srt = native.argsort_i64(cellkey)
        if srt is not None:
            sk = srt[1]
            est_chunks = (1 + int(np.count_nonzero(np.diff(sk)))
                          if len(sk) else 0)
        else:
            est_chunks = len(np.unique(cellkey))
        if est_chunks > int(os.environ.get("SPBLAS_MUL_CHUNK_BUDGET",
                                           400_000)):
            return None
    t_pack = time.perf_counter()
    try:
        return _build_route_packer(slots, sa, sb, a_len, b_len, c_capacity,
                                   paned=paned, device=a.device)
    finally:
        record_phase("spgemm_engine", "pack_s",
                     time.perf_counter() - t_pack)


def _build_route_packer(slots, sa, sb, a_len, b_len, c_capacity,
                        paned: bool = False, device=None):
    if paned:
        from spblas_tpu_torch.kernels.route_mul_paned import \
            build_route2_mul_paned_plan
        return build_route2_mul_paned_plan(slots, sa, sb, a_len, b_len,
                                           c_capacity, device=device)
    if os.environ.get("SPBLAS_ROUTE_SPGEMM") == "1":
        # the ROUTE v1 engine, kept selectable for comparison
        from spblas_tpu_torch.kernels.route_mul import build_route_mul_plan
        return build_route_mul_plan(slots, sa, sb, a_len, b_len,
                                    c_capacity, device=device)
    from spblas_tpu_torch.kernels.route2 import build_route2_mul_plan
    return build_route2_mul_plan(slots, sa, sb, a_len, b_len, c_capacity,
                                 device=device)


# ------------------------------------------------------------------ #
# public two-phase API
# ------------------------------------------------------------------ #

@traced
def spgemm_compute(a_view, b_view, d_view=None,
                   c_capacity: Optional[int] = None,
                   reuse: bool = True) -> OperationInfo:
    """Symbolic phase: structure of C = A@B (+ D's structure if given).

    One device-to-host read gives result_nnz.  ``reuse=True`` (the
    two-phase contract) also builds the fused numeric engine where it
    applies, so repeated fills run the mul kernel; one-shot callers pass
    ``reuse=False`` to skip that host inspection and take the torch
    numeric."""
    a = to_csr(_v.get_ultimate_base(a_view))
    b = to_csr(_v.get_ultimate_base(b_view))
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"spgemm dimension mismatch: A is {a.shape}, B is {b.shape}")
    d = None
    if d_view is not None:
        d = to_csr(_v.get_ultimate_base(d_view))
        if d.shape != (m, n):
            raise ValueError(
                f"spgemm: D shape {d.shape} != C shape {(m, n)}")
    # flop count -> expansion capacity (host int64: an int32 device sum
    # would wrap past 2^31 flops)
    b_rowptr_h = _t.to_numpy(b.rowptr).astype(np.int64)
    b_len = (np.minimum(b_rowptr_h[1:], b.nnz)
             - np.minimum(b_rowptr_h[:-1], b.nnz))
    a_cols_h = _t.to_numpy(a.colind[:a.nnz])
    e_total = int(b_len[a_cols_h].sum())
    if e_total >= 2**31:
        raise RuntimeError(
            f"SpGEMM expansion has {e_total} flops (>= 2^31): use "
            "spgemm_chunked to bound the expansion")
    e_capacity = _t.quantize_capacity(max(e_total, 1))
    (cols_s, src_a_s, src_b_s, is_d_s, valid_s, heads, slots, c_rowptr,
     nnz_dev) = _symbolic_sort(a, b, d, e_capacity)
    nnz = int(nnz_dev)  # the device-to-host read of the protocol
    if c_capacity is None:
        c_capacity = _t.quantize_capacity(max(nnz, 1))
    if nnz > c_capacity:
        raise RuntimeError(
            f"SpGEMM ran out of memory: result_nnz {nnz} exceeds "
            f"requested capacity {c_capacity}")
    c_colind, slot_all = _structure_fill(cols_s, heads, slots, valid_s,
                                         int(c_capacity))
    route = None
    if reuse:
        from spblas_tpu_torch.utils.profiling import record_phase
        t0 = time.perf_counter()
        route = _try_build_route(a, b, d, int(c_capacity))
        record_phase("spgemm_engine", "build_s", time.perf_counter() - t0)
        if (route is not None and _t.on_cuda(a.values)
                and os.environ.get("SPBLAS_SYNC_UPLOAD") == "1"):
            # the plan's uploads, waited for (transfer-time accounting)
            t0 = time.perf_counter()
            torch.cuda.synchronize(a.device)
            record_phase("spgemm_engine", "upload_wait_s",
                         time.perf_counter() - t0)
    plan = SpgemmPlan(src_a=src_a_s, src_b=src_b_s, is_d=is_d_s,
                      valid=valid_s, slot=slot_all, c_rowptr=c_rowptr,
                      c_colind=c_colind, c_nnz=nnz, shape=(m, n),
                      has_d=d is not None, route=route,
                      a_capacity=a.capacity, b_capacity=b.capacity,
                      d_capacity=d.capacity if d is not None else 0)
    return OperationInfo(result_shape=(m, n), result_nnz=nnz,
                         result_capacity=int(c_capacity), plan=plan)


def _values(base, conj: bool) -> torch.Tensor:
    v = to_csr(base).values
    return v.conj().resolve_conj() if conj else v


@traced
def spgemm_fill(info: OperationInfo, a_view, b_view, d_view=None,
                c: Optional[CSR] = None) -> CSR:
    """Numeric phase into the structure computed by
    :func:`spgemm_compute`.  ``c`` (optional) supplies user-owned
    capacity (the allocate-then-update handshake)."""
    plan: SpgemmPlan = info.plan
    if plan.has_d and d_view is None:
        raise ValueError(
            "spgemm_fill: plan was computed with a D addend but none was "
            "passed (the D slots would fill with garbage)")
    if not plan.has_d and d_view is not None:
        raise ValueError(
            "spgemm_fill: plan has no D structure; recompute with d_view")
    a_base, alpha_a, conj_a = _v.fold(a_view)
    b_base, alpha_b, conj_b = _v.fold(b_view)
    a = to_csr(a_base)
    b = to_csr(b_base)
    a_values = _values(a, conj_a)
    b_values = _values(b, conj_b)
    alpha = alpha_a * alpha_b
    beta = torch.ones((), dtype=alpha.dtype)
    d_values = None
    d = None
    if d_view is not None:
        d_base, beta_d, conj_d = _v.fold(d_view)
        d = to_csr(d_base)
        d_values = _values(d, conj_d)
        beta = beta_d
    if c is not None:
        if c.capacity < info.result_nnz:
            raise RuntimeError(
                f"spgemm_fill: user capacity {c.capacity} < result_nnz "
                f"{info.result_nnz} (csr_builder overflow analogue)")
        if c.capacity != plan.c_capacity:
            plan = plan.with_capacity(c.capacity)
    if plan.route is not None:
        from spblas_tpu_torch.kernels.plans import transform_safe
        operands = [a_values, b_values, alpha, beta] + (
            [d_values] if d_values is not None else [])
        if not transform_safe(*operands):
            # grad through values: the mul kernel has no backward; take
            # the differentiable torch numeric
            plan = dataclasses.replace(plan, route=None)
        elif any(v.dtype.is_complex or v.dtype == torch.float64
                 for v in operands):
            # the mul kernels compute in f32: complex or f64 fill-time
            # values or scales take the dtype-preserving torch numeric
            plan = dataclasses.replace(plan, route=None)
        elif (a.capacity != plan.a_capacity
              or b.capacity != plan.b_capacity
              or (d is not None and d.capacity != plan.d_capacity)):
            # the engine's gather indices and const-1 slot are baked
            # against the compute-time capacities
            plan = dataclasses.replace(plan, route=None)
    c_values = _numeric(plan, a_values, b_values, d_values, alpha, beta)
    return CSR(values=c_values, rowptr=plan.c_rowptr,
               colind=plan.c_colind[:c_values.shape[0]], nnz=plan.c_nnz,
               shape=plan.shape)


@traced
def spgemm(a_view, b_view, c_capacity: Optional[int] = None):
    """One-shot C = A @ B (compute + fill).

    BSR x BSR operands with compatible blocks go to the block SpGEMM
    (``kernels/bsr_spgemm.py``) and return a BSR result; everything else
    canonicalises to CSR."""
    from spblas_tpu_torch.formats.bsr import BSR

    a_base, alpha_a, conj_a = _v.fold(a_view)
    b_base, alpha_b, conj_b = _v.fold(b_view)
    if (isinstance(a_base, BSR) and isinstance(b_base, BSR)
            and a_base.block_shape[1] == b_base.block_shape[0]
            and not conj_a and not conj_b):
        from spblas_tpu_torch.kernels.bsr_spgemm import bsr_spgemm
        c = bsr_spgemm(a_base, b_base)
        return dataclasses.replace(c, values=c.values * (alpha_a * alpha_b))
    info = spgemm_compute(a_view, b_view, c_capacity=c_capacity,
                          reuse=False)
    return spgemm_fill(info, a_view, b_view)


# ------------------------------------------------------------------ #
# reuse state
# ------------------------------------------------------------------ #

class SpgemmState:
    """Opaque reuse handle for repeated numeric SpGEMM (rocSPARSE's
    ``spgemm_state_t``).  The user guarantees unchanged sparsity between
    ``numeric`` calls."""

    def __init__(self):
        self.info: Optional[OperationInfo] = None
        self._has_d = False

    def symbolic_compute(self, a, b, d=None,
                         c_capacity: Optional[int] = None) -> OperationInfo:
        self.info = spgemm_compute(a, b, d_view=d, c_capacity=c_capacity)
        self._has_d = d is not None
        return self.info

    def symbolic_fill(self, a, b, c: Optional[CSR] = None) -> CSR:
        """Materialise the structure (colind/rowptr) with zero values."""
        self._require_info()
        plan = self.info.plan
        if c is not None:
            if c.capacity < self.info.result_nnz:
                raise RuntimeError(
                    f"symbolic_fill: user capacity {c.capacity} < "
                    f"result_nnz {self.info.result_nnz} "
                    "(csr_builder overflow analogue)")
            if c.capacity != plan.c_capacity:
                plan = plan.with_capacity(c.capacity)
                self.info = self.info.update(plan=plan)
        cap = plan.c_capacity
        values = torch.zeros(cap, dtype=_v.get_ultimate_base(a).dtype,
                             device=plan.c_colind.device)
        return CSR(values=values, rowptr=plan.c_rowptr,
                   colind=plan.c_colind, nnz=plan.c_nnz, shape=plan.shape)

    def numeric(self, a, b, d=None) -> CSR:
        """Numeric re-run with new values, same sparsity."""
        self._require_info()
        return spgemm_fill(self.info, a, b, d_view=d)

    def _require_info(self):
        if self.info is None:
            raise RuntimeError(
                "SpgemmState used before symbolic_compute "
                "(mirrors rocsparse_status_invalid_pointer)")


# free-function parity with the reference's reuse API names
def multiply_symbolic_compute(state: SpgemmState, a, b,
                              c_capacity: Optional[int] = None
                              ) -> OperationInfo:
    return state.symbolic_compute(a, b, c_capacity=c_capacity)


def multiply_symbolic_fill(state: SpgemmState, a, b,
                           c: Optional[CSR] = None) -> CSR:
    return state.symbolic_fill(a, b, c)


def multiply_numeric(state: SpgemmState, a, b) -> CSR:
    return state.numeric(a, b)


def multiply_fused(state: SpgemmState, a, b, d,
                   c_capacity: Optional[int] = None) -> CSR:
    """4-argument fused C = alpha*A*B + beta*D (alpha and beta ride in as
    scaled views).  Pass d=None for the null-D shortcut."""
    if d is None:
        state.symbolic_compute(a, b, c_capacity=c_capacity)
        return state.numeric(a, b)
    state.symbolic_compute(a, b, d=d, c_capacity=c_capacity)
    return state.numeric(a, b, d=d)


def spgemm_csc(a_view, b_view, c_capacity: Optional[int] = None):
    """C = A @ B materialised as CSC — the transpose trick: compute the
    CSR of C^T = B^T A^T, then reinterpret it as the CSC of C at zero
    cost (``views.transposed``)."""
    ct = spgemm(_v.transposed(b_view), _v.transposed(a_view),
                c_capacity=c_capacity)
    return _v.transposed(ct)


def spgemm_chunked(a_view, b_view, rows_per_chunk: int) -> CSR:
    """C = A @ B with the expansion bounded by row chunking: each chunk
    of A's rows (padded to a uniform row count) is one one-shot product,
    so the ESC arrays hold at most one chunk's flops."""
    a_base, alpha_a, conj_a = _v.fold(a_view)
    b_base, alpha_b, conj_b = _v.fold(b_view)
    a = to_csr(a_base)
    b = to_csr(b_base)
    if conj_a:
        a = dataclasses.replace(a, values=_values(a, True))
    if conj_b:
        b = dataclasses.replace(b, values=_values(b, True))
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"spgemm dimension mismatch: A is {a.shape}, B is {b.shape}")
    alpha = alpha_a * alpha_b
    rows_per_chunk = int(rows_per_chunk)
    rowptr = _t.to_numpy(a.rowptr).astype(np.int64)
    nnz = a.nnz
    vals_l, cols_l, counts = [], [], np.zeros(m + 1, np.int64)
    for r0 in range(0, m, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, m)
        lo = int(min(rowptr[r0], nnz))
        hi = int(min(rowptr[r1], nnz))
        sub_rowptr = np.zeros(rows_per_chunk + 1, np.int64)
        sub_rowptr[: r1 - r0 + 1] = np.minimum(rowptr[r0: r1 + 1], nnz) - lo
        sub_rowptr[r1 - r0 + 1:] = hi - lo
        sub = CSR.from_arrays(a.values[lo:hi], sub_rowptr, a.colind[lo:hi],
                              (rows_per_chunk, k), nnz=hi - lo,
                              device=a.device)
        info = spgemm_compute(sub, b, reuse=False)  # one-shot chunks
        c_chunk = spgemm_fill(info, sub, b)
        cn = info.result_nnz
        vals_l.append(c_chunk.values[:cn])
        cols_l.append(c_chunk.colind[:cn])
        counts[r0 + 1: r1 + 1] = np.diff(
            _t.to_numpy(c_chunk.rowptr)[: r1 - r0 + 1])
    values = torch.cat(vals_l) if vals_l else a.values.new_zeros(0)
    colind = torch.cat(cols_l) if cols_l else a.colind.new_zeros(0)
    return CSR.from_arrays(values * alpha, np.cumsum(counts), colind,
                           (m, n), nnz=int(values.shape[0]),
                           device=a.device)

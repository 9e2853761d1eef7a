"""SpADD: C = A + B, dense/vector and sparse two-phase forms —
counterpart of ``spblas_tpu/ops/add.py``.

The sparse path is the SpGEMM structure engine's merge: both operands'
live entries concatenated, one stable sort by (row, col), equal
neighbours coalesced into output slots.  ``add_inspect`` builds that
union once (one read of the result nnz to the host); ``add_compute``
refills it with new values as often as the sparsity stays.

The numeric fill sums each output slot's entries in the sorted stream's
order, as the reference's sequential scatter does: it gathers the k-th
entry of every slot for k below the longest run (two for canonical
operands, more where a COO operand repeats a (row, col)) and adds them
in turn.  No atomics, so the same inputs give the same bits on every
run, on the card as on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch import views as _v
from spblas_tpu_torch.backend import engine
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.info import OperationInfo
from spblas_tpu_torch.ops.spgemm import _structure_fill
from spblas_tpu_torch.utils.logging import traced


@dataclasses.dataclass(frozen=True)
class AddPlan:
    """Sorted merge maps for numeric re-runs with unchanged sparsity.

    a_pos, b_pos: the merged stream's position of each live entry of A
    and of B; run_start, run_len: each output slot's first stream
    position and entry count, (c_capacity,); max_run: the longest run;
    c_nnz and max_run are host ints."""

    a_pos: torch.Tensor
    b_pos: torch.Tensor
    run_start: torch.Tensor
    run_len: torch.Tensor
    max_run: int
    c_rowptr: torch.Tensor
    c_colind: torch.Tensor
    c_nnz: int
    shape: Tuple[int, int]

    @property
    def c_capacity(self) -> int:
        return int(self.c_colind.shape[0])


@traced
def add_inspect(a_view, b_view,
                c_capacity: Optional[int] = None) -> OperationInfo:
    """Symbolic union of the two sparsity patterns (add_impl.hpp:79-108):
    both operands' live entries in one stable (row, col) sort, equal
    neighbours coalesced into a slot.  One device-to-host read gives the
    result nnz (and the longest run)."""
    a = to_csr(_v.get_ultimate_base(a_view))
    b = to_csr(_v.get_ultimate_base(b_view))
    if a.shape != b.shape:
        raise ValueError(f"add shape mismatch: {a.shape} vs {b.shape}")
    m, n = a.shape
    dev = a.device
    total = a.nnz + b.nnz
    rows_s, cols_s, src = engine.lexsort_coo(
        torch.cat([a.row_ids()[:a.nnz], b.row_ids()[:b.nnz]]),
        torch.cat([a.colind[:a.nnz], b.colind[:b.nnz]]), n,
        torch.arange(total, device=dev))
    live = torch.ones(total, dtype=torch.bool, device=dev)
    heads, slots, nnz_dev, c_rowptr = engine.coalesce_sorted(
        rows_s, cols_s, live, m)
    run_len = torch.zeros(total + 1, dtype=torch.int64,
                          device=dev).index_add_(0, slots.long(),
                                                 live.long())
    nnz, max_run = (int(v) for v in torch.stack(
        [nnz_dev.long(), run_len.max()]).tolist())
    if c_capacity is None:
        c_capacity = _t.quantize_capacity(max(nnz, 1))
    if nnz > c_capacity:
        raise RuntimeError("add: result capacity too small "
                           "(csr_builder overflow analogue)")
    c_capacity = int(c_capacity)
    c_colind, _ = _structure_fill(cols_s, heads, slots, live, c_capacity)
    run_len = torch.nn.functional.pad(run_len[:nnz], (0, c_capacity - nnz))
    # the stream positions of the entries of A, then of B
    pos = torch.empty_like(src)
    pos[src] = torch.arange(total, device=dev)
    plan = AddPlan(a_pos=pos[:a.nnz], b_pos=pos[a.nnz:],
                   run_start=torch.cumsum(run_len, 0) - run_len,
                   run_len=run_len, max_run=max_run, c_rowptr=c_rowptr,
                   c_colind=c_colind, c_nnz=nnz, shape=(m, n))
    return OperationInfo(result_shape=(m, n), result_nnz=nnz,
                         result_capacity=c_capacity, plan=plan)


def _add_numeric(plan: AddPlan, a_values, b_values, alpha_a, alpha_b):
    """Each slot's run summed left to right in stream order: the scaled
    entries laid out in the stream, then the k-th entries of all slots
    gathered and added in turn; no atomics."""
    va = alpha_a * a_values[:plan.a_pos.shape[0]]
    vb = alpha_b * b_values[:plan.b_pos.shape[0]]
    dt = torch.promote_types(va.dtype, vb.dtype)
    v = torch.empty(va.shape[0] + vb.shape[0], dtype=dt, device=va.device)
    v[plan.a_pos] = va.to(dt)
    v[plan.b_pos] = vb.to(dt)
    out = torch.zeros(plan.c_capacity, dtype=dt, device=v.device)
    for k in range(plan.max_run):
        term = v[(plan.run_start + k).clamp(max=v.shape[0] - 1)]
        out = out + torch.where(k < plan.run_len, term, 0)
    return out


@traced
def add_compute(info: OperationInfo, a_view, b_view,
                c: Optional[CSR] = None) -> CSR:
    """Numeric fill into the union structure (add_impl.hpp:110-113).

    ``c`` supplies user-owned capacity (the allocate-then-fill
    handshake); it must fit result_nnz."""
    plan: AddPlan = info.plan
    a_base, alpha_a, conj_a = _v.fold(a_view)
    b_base, alpha_b, conj_b = _v.fold(b_view)
    a_values = to_csr(a_base).values
    b_values = to_csr(b_base).values
    if conj_a:
        a_values = a_values.conj()
    if conj_b:
        b_values = b_values.conj()
    out = CSR(values=_add_numeric(plan, a_values, b_values, alpha_a,
                                  alpha_b),
              rowptr=plan.c_rowptr, colind=plan.c_colind, nnz=plan.c_nnz,
              shape=plan.shape)
    if c is not None:
        if c.capacity < info.result_nnz:
            raise RuntimeError(
                f"add_compute: user capacity {c.capacity} < result_nnz "
                f"{info.result_nnz} (csr_builder overflow analogue)")
        out = out.with_capacity(c.capacity)
    return out


@traced
def add(a_view, b_view, c_capacity: Optional[int] = None):
    """C = A + B.

    Dense/dense and vector/vector -> elementwise (add_impl.hpp:10-38);
    sparse/sparse -> the two-phase union add; sparse/dense -> dense.
    """
    a_sparse = _v.is_sparse(a_view)
    b_sparse = _v.is_sparse(b_view)
    if not a_sparse and not b_sparse:
        a, alpha_a, conj_a = _v.fold(a_view)
        b, alpha_b, conj_b = _v.fold(b_view)
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if conj_a:
            a = a.conj()
        if conj_b:
            b = b.conj()
        if a.shape != b.shape:
            raise ValueError(f"add shape mismatch: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        return alpha_a * a + alpha_b * b
    if a_sparse and b_sparse:
        info = add_inspect(a_view, b_view, c_capacity=c_capacity)
        return add_compute(info, a_view, b_view)
    # sparse + dense -> dense (the dense lookupable path, add_impl.hpp:23-38)
    if a_sparse:
        a, alpha_a, conj_a = _v.fold(a_view)
        dense = add(b_view, torch.zeros(a.shape, dtype=a.dtype,
                                        device=a.device))
        sp = a.todense().conj() if conj_a else a.todense()
        return alpha_a * sp + dense
    return add(b_view, a_view)

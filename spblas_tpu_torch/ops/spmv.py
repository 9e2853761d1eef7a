"""SpMV: y = A @ x for sparse A, dense x — counterpart of
``spblas_tpu/ops/spmv.py``.

An ``OptimizedMatrix`` runs its cached plan (``plans.plan_spmv``); a BSR
takes its block kernel; everything else takes the base path, a gather +
multiply + ``index_add`` that autograd differentiates.
"""

from __future__ import annotations

import dataclasses

import torch

from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.dcsr import DCSR
from spblas_tpu_torch import views as _v
from spblas_tpu_torch.kernels import plans as _plans
from spblas_tpu_torch.kernels.bsr_kernels import bsr_spmv
from spblas_tpu_torch.utils.logging import traced


@traced
def spmv(a_view, x_view) -> torch.Tensor:
    """y = (folded a_view) @ (folded x_view); raises ValueError on a
    dimension mismatch.  A non-tensor x is placed on A's device."""
    a, alpha_a, conj_a = _v.fold(a_view)
    x, alpha_x, conj_x = _v.fold(x_view)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=a.device)
    m, n = a.shape
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(
            f"spmv dimension mismatch: A is {a.shape}, x is "
            f"{tuple(x.shape)}")
    if conj_x:
        x = x.conj()
    opt = _v.get_matrix_opt(a_view)
    plan = None
    if (opt is not None and not conj_a and _v.is_sparse(a_view)
            and _plans.transform_safe(x, a.values)):
        plan = _plans.optimized_plan(opt, "matvec", x.dtype)
    if plan is not None:
        y = _plans.plan_spmv(plan, x)
    else:
        y = _spmv_base(a, x, conj_a)
    return y * (alpha_a * alpha_x)


def _segment_sum(contrib: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Sum ``contrib`` (entries, or entries by columns) into ``num`` rows
    by segment id.  One extra row takes ids == num (padded CSR entries),
    which ``index_add`` would reject and ``segment_sum`` drops; it is cut
    off."""
    out = contrib.new_zeros((num + 1,) + tuple(contrib.shape[1:]))
    return out.index_add(0, seg, contrib)[:num]


def _entries(a, conj_a: bool):
    """(values, column ids, row ids) of a CSR/CSC/COO/DCSR's entries, the
    values conjugated when ``conj_a``; padded entries hold value 0 (and
    row m in a CSR or DCSR)."""
    vals = a.values.conj() if conj_a else a.values
    if isinstance(a, (CSR, DCSR)):
        return vals, a.colind, a.row_ids()
    if isinstance(a, CSC):
        return vals, a.col_ids() % a.shape[1], a.rowind
    return vals, a.colind, a.rowind


def _spmv_base(a, x, conj_a: bool):
    if isinstance(a, BSR):
        if conj_a:
            a = dataclasses.replace(a, values=a.values.conj())
        return bsr_spmv(a, x)
    if isinstance(a, (CSR, CSC, COO, DCSR)):
        vals, cols, rows = _entries(a, conj_a)
        return _segment_sum(vals * x.index_select(0, cols), rows, a.shape[0])
    # dense matrix fallback
    mat = a.conj() if conj_a else a
    return mat @ x

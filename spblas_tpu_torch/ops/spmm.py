"""SpMM: C = A @ B for sparse A, dense B (and the dense @ dense fallback)
— counterpart of ``spblas_tpu/ops/spmm.py``.

An ``OptimizedMatrix`` runs its cached plan (band, BSR, RCM band, DIA,
SELL; ``plans.plan_spmm``); everything else takes the base path: BSR
through its block kernel, CSR/CSC/COO/DCSR as a gather of whole B rows, a
multiply and an ``index_add`` that autograd differentiates.
"""

from __future__ import annotations

import dataclasses

import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch import views as _v
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.dcsr import DCSR
from spblas_tpu_torch.kernels import plans as _plans
from spblas_tpu_torch.kernels.bsr_kernels import bsr_spmm
from spblas_tpu_torch.ops.spmv import _entries, _segment_sum
from spblas_tpu_torch.utils.logging import traced


@traced
def spmm(a_view, b_view) -> torch.Tensor:
    """C = (folded a_view) @ (folded b_view); raises ValueError on a
    dimension mismatch.  A non-tensor B is placed on A's device."""
    a, alpha_a, conj_a = _v.fold(a_view)
    b, alpha_b, conj_b = _v.fold(b_view)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    m, k = a.shape
    if b.dim() != 2 or b.shape[0] != k:
        raise ValueError(
            f"spmm dimension mismatch: A is {tuple(a.shape)}, B is "
            f"{tuple(b.shape)}")
    if conj_b:
        b = b.conj()
    opt = _v.get_matrix_opt(a_view)
    plan = None
    if (opt is not None and not conj_a and _v.is_sparse(a_view)
            and _plans.transform_safe(b, a.values)):
        plan = _plans.optimized_plan(opt, "matmul", b.dtype)
    if plan is not None:
        c = _plans.plan_spmm(plan, b)
    else:
        c = _spmm_base(a, b, conj_a)
    return c * (alpha_a * alpha_b)


def _spmm_base(a, b, conj_a: bool):
    if isinstance(a, BSR):
        if conj_a:
            a = dataclasses.replace(a, values=a.values.conj())
        return bsr_spmm(a, b)
    if isinstance(a, (CSR, CSC, COO, DCSR)):
        vals, cols, rows = _entries(a, conj_a)
        return _segment_sum(vals[:, None] * b.index_select(0, cols), rows,
                            a.shape[0])
    # dense @ dense: full precision whatever the caller's TF32 setting
    mat = a.conj() if conj_a else a
    return _t.wide_matmul(torch.matmul, mat, b)

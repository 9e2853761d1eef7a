"""multiply — the polymorphic product entry point and the two-phase
protocol, counterpart of ``spblas_tpu/ops/multiply.py``.

Sparse times a dense vector runs SpMV, sparse (or dense) times a dense
matrix SpMM, and dense times sparse the transpose identity over SpMM.
SpGEMM raises ``NotImplementedError`` naming the ROADMAP item that ports
it.
"""

from __future__ import annotations

import os
from typing import Optional

from spblas_tpu_torch import views as _v
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.info import OperationInfo
from spblas_tpu_torch.ops.spmm import spmm
from spblas_tpu_torch.ops.spmv import spmv
from spblas_tpu_torch.utils.logging import traced

_NOT_PORTED = {"spgemm": "SpGEMM is ROADMAP Queue 1 item 10"}


def _kind(a_view, b_view):
    a = _v.get_ultimate_base(a_view)
    b = _v.get_ultimate_base(b_view)
    a_sp = _v.is_sparse(a)
    b_sp = _v.is_sparse(b)
    b_vec = getattr(b, "ndim", 2) == 1 and not b_sp
    if a_sp and b_vec:
        return "spmv"
    if a_sp and b_sp:
        return "spgemm"
    if not a_sp and b_sp:
        return "dense_sparse"   # C = A·B == (Bᵀ·Aᵀ)ᵀ
    return "spmm"  # sparse·dense and dense·dense both go to spmm


def _not_ported(kind):
    raise NotImplementedError(
        f"{kind} is not ported to spblas_tpu_torch yet: "
        f"{_NOT_PORTED[kind]}")


def _debug_validate(*tensors):
    """SPBLAS_DEBUG=1 -> host-side structural checks before dispatch."""
    if os.environ.get("SPBLAS_DEBUG") != "1":
        return
    for t in tensors:
        base = _v.get_ultimate_base(t)
        if hasattr(base, "validate"):
            base.validate()


@traced
def multiply(a, b, c_capacity: Optional[int] = None):
    """c = a @ b with views folded, on the operands' device; the result
    is a dense vector or matrix.  Sparse·sparse (SpGEMM) is not ported
    yet."""
    _debug_validate(a, b)
    kind = _kind(a, b)
    if kind == "spmv":
        return spmv(a, b)
    if kind == "spgemm":
        _not_ported(kind)
    if kind == "dense_sparse":
        return _dense_sparse(a, b)
    return spmm(a, b)


def _dense_sparse(a, b):
    """Dense A · sparse B through the transpose identity.  The lazy flip
    exists only for CSR/CSC, so another sparse format is converted to CSR
    first (and loses its ``matrix_opt`` handle, as in the JAX package)."""
    b_base, alpha_b, conj_b = _v.fold(b)
    if not isinstance(b_base, (CSR, CSC)):
        # alpha * conj(csr): the conjugation sits below the scale, so the
        # already folded alpha is not conjugated again
        bc = to_csr(b_base)
        b = _v.scaled(alpha_b, _v.conjugated(bc) if conj_b else bc)
    return spmm(_v.transposed(b), _v.transposed(a)).transpose(-1, -2)


def multiply_inspect(a, b) -> OperationInfo:
    """Plan hook; returns an (empty) info for SpMV and SpMM like the
    reference.  Heavy planning belongs to ``views.matrix_opt``."""
    a_base = _v.get_ultimate_base(a)
    b_base = _v.get_ultimate_base(b)
    m = a_base.shape[0]
    if _kind(a, b) == "spmv" or getattr(b_base, "ndim", 2) == 1:
        return OperationInfo(result_shape=(m,), result_nnz=0)
    return OperationInfo(result_shape=(m, b_base.shape[1]), result_nnz=0)


@traced
def multiply_compute(a, b, c_capacity: Optional[int] = None
                     ) -> OperationInfo:
    """Symbolic phase: the inspect no-op for SpMV and SpMM."""
    if _kind(a, b) == "spgemm":
        _not_ported("spgemm")
    return multiply_inspect(a, b)


@traced
def multiply_fill(info: OperationInfo, a, b, c=None):
    """Numeric phase (fill == numeric multiply)."""
    return multiply(a, b)

"""Out-of-place transpose (materialized) and its inspect phase —
counterpart of ``spblas_tpu/ops/transpose.py``.

The transpose's CSR is the input's CSC read the other way round
(``views.transposed``, zero cost), so it costs one CSR -> CSC
conversion: a stable sort of the live entries by column and a count for
the new row pointer, as torch ops on the operand's device.  Views are
folded into the values first (conjugate, then scale).
"""

from __future__ import annotations

import dataclasses

from spblas_tpu_torch import views as _v
from spblas_tpu_torch.formats.convert import csr_to_csc, to_csr
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.info import OperationInfo
from spblas_tpu_torch.utils.logging import traced


@traced
def transpose_inspect(a_view) -> OperationInfo:
    """The transpose keeps the structure's size: its nnz and capacity
    are the input's."""
    a = _v.get_ultimate_base(a_view)
    m, n = a.shape
    return OperationInfo(result_shape=(n, m), result_nnz=int(a.nnz),
                         result_capacity=a.capacity)


@traced
def transpose(a_view, capacity=None) -> CSR:
    """B = op(A)^T materialized as a CSR (folds scaled and conjugated
    views): the CSC of op(A), read as the CSR of its transpose;
    ``capacity`` re-targets the padded capacity and must hold the nnz."""
    base, alpha, conj = _v.fold(a_view)
    a = to_csr(base)
    c = csr_to_csc(dataclasses.replace(
        a, values=_v.fold_values(a.values, alpha, conj)))
    out = _v.transposed(c)
    if capacity is not None:
        if a.nnz > capacity:
            raise RuntimeError("transpose: output capacity too small "
                               "(transpose_impl.hpp capacity check)")
        out = out.with_capacity(capacity)
    return out

"""Format conversions to CSR — counterpart of
``spblas_tpu/formats/convert.py::to_csr`` for CSR, COO and CSC.

BSR and DCSR arrive with their slice (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO


def to_csr(a) -> CSR:
    if isinstance(a, CSR):
        return a
    if isinstance(a, COO):
        return a.to_csr()
    if isinstance(a, CSC):
        return csc_to_csr(a)
    raise TypeError(f"cannot convert {type(a).__name__} to CSR")


def csc_to_csr(a: CSC) -> CSR:
    """Materialized CSC -> CSR: one stable sort by row.  CSC entries are
    already column-major, so the stable sort leaves the columns of each
    row ascending; padded entries sort last (key m) and are re-zeroed."""
    m, _ = a.shape
    live = torch.arange(a.capacity, device=a.device) < a.nnz
    keys = torch.where(live, a.rowind, m)
    order = torch.argsort(keys, stable=True)
    cols = a.col_ids()[order]
    counts = torch.bincount(keys[live].long(), minlength=m)
    rowptr = torch.zeros(m + 1, dtype=_t.offset_dtype, device=a.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    # order maps the first nnz slots to live entries, so `live` (a prefix
    # mask) also marks the live slots of the sorted arrays
    return CSR(values=torch.where(live, a.values[order], 0),
               rowptr=rowptr,
               colind=torch.where(live, cols, 0).to(_t.index_dtype),
               nnz=a.nnz, shape=a.shape)

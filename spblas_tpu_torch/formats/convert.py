"""Format conversions to CSR — counterpart of
``spblas_tpu/formats/convert.py::to_csr`` for CSR, COO, CSC and BSR.

DCSR arrives with its own slice (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import torch

import numpy as np

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.bsr import BSR
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
    if isinstance(a, BSR):
        return bsr_to_csr(a)
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


def bsr_to_csr(a: BSR) -> CSR:
    """Expand BSR blocks to scalar entries (host-side; zero entries
    inside stored blocks are kept, like vendor BSR->CSR converters)."""
    bh, bw = a.block_shape
    m, n = a.shape
    nnzb = a.nnz_blocks
    vals = _t.to_numpy(a.values[:nnzb])
    brow = _t.to_numpy(a.block_row_ids()[:nnzb])
    bcol = _t.to_numpy(a.block_colind[:nnzb])
    rows = (brow[:, None, None] * bh
            + np.arange(bh)[None, :, None]).repeat(bw, axis=2)
    cols = (bcol[:, None, None] * bw
            + np.arange(bw)[None, None, :]).repeat(bh, axis=1)
    rows, cols, v = rows.ravel(), cols.ravel(), vals.ravel()
    order = np.lexsort((cols, rows))
    rowptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rowptr[1:], rows, 1)
    return CSR.from_arrays(v[order], np.cumsum(rowptr), cols[order],
                           (m, n), nnz=len(v), device=a.device)

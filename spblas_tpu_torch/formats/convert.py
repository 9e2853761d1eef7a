"""Format conversions (CSR, CSC, COO, BSR, DCSR) — counterpart of
``spblas_tpu/formats/convert.py``.

Ops that iterate rows call :func:`to_csr` and pay one stable sort at
most.  A CSR's live entries lie row-major (columns within a row in any
order) and a CSC's column-major, so each regrouping is one stable sort
of the live entries by the other index, on the matrix's device: the
result lies in (major, minor) order as the JAX package's two-key sort
leaves it.
"""

from __future__ import annotations

import torch

import numpy as np

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.backend import engine
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.csr import CSR, _pad_to
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO, csr_to_coo
from spblas_tpu_torch.formats.dcsr import DCSR


def to_csr(a) -> CSR:
    if isinstance(a, CSR):
        return a
    if isinstance(a, (COO, DCSR)):
        return a.to_csr()
    if isinstance(a, CSC):
        return csc_to_csr(a)
    if isinstance(a, BSR):
        return bsr_to_csr(a)
    raise TypeError(f"cannot convert {type(a).__name__} to CSR")


def to_csc(a) -> CSC:
    if isinstance(a, CSC):
        return a
    if isinstance(a, CSR):
        return csr_to_csc(a)
    if isinstance(a, (COO, BSR, DCSR)):
        return csr_to_csc(to_csr(a))
    raise TypeError(f"cannot convert {type(a).__name__} to CSC")


def to_coo(a) -> COO:
    if isinstance(a, COO):
        return a
    if isinstance(a, CSR):
        return csr_to_coo(a)
    if isinstance(a, CSC):
        return csr_to_coo(csc_to_csr(a))
    raise TypeError(f"cannot convert {type(a).__name__} to COO")


def _regroup(values, major, minor, nnz: int, capacity: int, count: int):
    """The first ``nnz`` entries, which lie in ``minor``-major order, in
    ``major``-major order: one stable sort by ``major`` (the ``minor``
    order holds within each group), the ``count + 1`` group pointer, and
    the sorted ``minor`` ids and values padded with zeros to
    ``capacity``."""
    key = major[:nnz]
    order = torch.argsort(key, stable=True)
    ptr = engine.rowptr_from_counts(
        torch.bincount(key.long(), minlength=count), count)
    return (ptr, _pad_to(minor[:nnz][order].to(_t.index_dtype), capacity),
            _pad_to(values[:nnz][order], capacity))


def csr_to_csc(a: CSR) -> CSC:
    """Materialized CSR -> CSC: the live entries are row-major, so one
    stable sort by column puts them in (col, row) order."""
    colptr, rowind, values = _regroup(a.values, a.colind, a.row_ids(), a.nnz,
                                      a.capacity, a.shape[1])
    return CSC(values=values, colptr=colptr, rowind=rowind, nnz=a.nnz,
               shape=a.shape)


def csc_to_csr(a: CSC) -> CSR:
    """Materialized CSC -> CSR: the live entries are column-major, so one
    stable sort by row puts them in (row, col) order."""
    rowptr, colind, values = _regroup(a.values, a.rowind, a.col_ids(), a.nnz,
                                      a.capacity, a.shape[0])
    return CSR(values=values, rowptr=rowptr, colind=colind, nnz=a.nnz,
               shape=a.shape)


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

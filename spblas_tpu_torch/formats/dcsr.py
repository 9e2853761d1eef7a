"""DCSR container (doubly-compressed sparse row, hypersparse) —
counterpart of ``spblas_tpu/formats/dcsr.py``.

Only non-empty rows are stored: ``rowind`` lists them and ``rowptr``
compresses the entry offsets over that list, so a matrix whose rows are
mostly empty keeps no pointer per empty row.  Ops consume a DCSR through
per-entry row ids (:meth:`DCSR.row_ids`, padding mapped to row m as in
CSR) or through :meth:`DCSR.to_csr`, so every CSR path serves it.
``nrows`` and ``nnz`` are host integers, as ``CSR.nnz`` is.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR


@dataclasses.dataclass(frozen=True)
class DCSR:
    """values (capacity,); colind (capacity,) int32; rowind (row_capacity,)
    int32, the stored rows' ids; rowptr (row_capacity + 1,) int32, offsets
    into values per stored row; nrows the live count of stored rows and
    nnz the live entry count (host ints); shape (m, n)."""

    values: torch.Tensor
    colind: torch.Tensor
    rowind: torch.Tensor
    rowptr: torch.Tensor
    nrows: int
    nnz: int
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def row_capacity(self) -> int:
        return int(self.rowind.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def from_csr(cls, a: CSR, row_capacity=None) -> "DCSR":
        """The DCSR of a CSR, on its device; ``values`` and ``colind``
        alias the CSR's.  The row pointer is read to the host (an
        inspection)."""
        if not isinstance(a, CSR):
            raise TypeError(f"DCSR.from_csr takes a CSR, not "
                            f"{type(a).__name__}")
        rowptr = _t.to_numpy(a.rowptr).astype(np.int64)
        lo = np.minimum(rowptr[:-1], a.nnz)
        hi = np.minimum(rowptr[1:], a.nnz)
        nonempty = np.flatnonzero(hi > lo)
        r = len(nonempty)
        rcap = row_capacity or _t.quantize_capacity(max(r, 1))
        rowind = np.zeros(rcap, np.int64)
        rowind[:r] = nonempty
        # CSR entries are row-major, so the stored rows' entry runs are
        # contiguous and the compressed rowptr is their length cumsum
        c_rowptr = np.zeros(rcap + 1, np.int64)
        c_rowptr[1:r + 1] = np.cumsum(hi[nonempty] - lo[nonempty])
        c_rowptr[r + 1:] = c_rowptr[r]
        dev = a.device
        return cls(values=a.values, colind=a.colind,
                   rowind=_t.as_tensor(rowind, dev, _t.index_dtype),
                   rowptr=_t.as_tensor(c_rowptr, dev, _t.offset_dtype),
                   nrows=r, nnz=a.nnz, shape=a.shape)

    def row_ids(self) -> torch.Tensor:
        """Per-entry global row id, (capacity,) int32; padded entries map
        to m — the bridge to every CSR-style path."""
        e = torch.arange(self.capacity, dtype=self.rowptr.dtype,
                         device=self.device)
        stored = torch.searchsorted(self.rowptr[1:], e, right=True)
        stored = stored.clamp(max=self.row_capacity - 1)
        return torch.where(e < self.nnz, self.rowind[stored],
                           self.shape[0]).to(_t.index_dtype)

    def to_csr(self) -> CSR:
        """The CSR over the same values and columns (entries are already
        row-major)."""
        m, _ = self.shape
        counts = torch.bincount(self.row_ids()[:self.nnz].long(),
                                minlength=m)
        rowptr = torch.zeros(m + 1, dtype=_t.offset_dtype,
                             device=self.device)
        rowptr[1:] = torch.cumsum(counts, 0)
        return CSR(values=self.values, rowptr=rowptr, colind=self.colind,
                   nnz=self.nnz, shape=self.shape)

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m + 1, n), dtype=self.dtype, device=self.device)
        out.index_put_((self.row_ids().long(), self.colind.long()),
                       self.values, accumulate=True)
        return out[:m]

    def __repr__(self):
        return (f"DCSR(shape={self.shape}, capacity={self.capacity}, "
                f"row_capacity={self.row_capacity}, dtype={self.dtype}, "
                f"device={self.device})")

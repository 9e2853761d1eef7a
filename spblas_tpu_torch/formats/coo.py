"""COO container — counterpart of ``spblas_tpu/formats/coo.py``.

Invariant: live entries are sorted by row (columns within a row in any
order); padded entries have values == 0 and rowind == colind == 0 (never
``CSR.row_ids``'s sentinel m).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR, _pad_to


@dataclasses.dataclass(frozen=True)
class COO:
    values: torch.Tensor
    rowind: torch.Tensor
    colind: torch.Tensor
    nnz: int
    shape: Tuple[int, int]

    @classmethod
    def from_arrays(cls, values, rowind, colind, shape, nnz=None,
                    capacity=None, device=None) -> "COO":
        dev = _t.resolve_device(device)
        values = _t.as_tensor(values, dev)
        rowind = _t.as_tensor(rowind, dev, _t.index_dtype)
        colind = _t.as_tensor(colind, dev, _t.index_dtype)
        nnz = int(values.shape[0]) if nnz is None else int(nnz)
        if capacity is None:
            capacity = max(_t.quantize_capacity(nnz), int(values.shape[0]))
        if int(values.shape[0]) > nnz:
            # COO numerics have no mask: enforce canonical zero padding
            values, rowind, colind = (
                torch.cat([t[:nnz], t.new_zeros(t.shape[0] - nnz)])
                for t in (values, rowind, colind))
        return cls(values=_pad_to(values, capacity),
                   rowind=_pad_to(rowind, capacity),
                   colind=_pad_to(colind, capacity), nnz=nnz,
                   shape=(int(shape[0]), int(shape[1])))

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def entry_mask(self) -> torch.Tensor:
        """(capacity,) bool — True for live entries."""
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.dtype, device=self.device)
        out.index_put_((self.rowind.long(), self.colind.long()),
                       self.values, accumulate=True)
        return out

    def to_csr(self) -> CSR:
        """Row-major-sorted COO -> CSR (same entry order, build rowptr)."""
        m, _ = self.shape
        counts = torch.bincount(self.rowind[:self.nnz].long(), minlength=m)
        rowptr = torch.zeros(m + 1, dtype=_t.offset_dtype,
                             device=self.device)
        rowptr[1:] = torch.cumsum(counts, 0)
        return CSR(values=self.values, rowptr=rowptr, colind=self.colind,
                   nnz=self.nnz, shape=self.shape)

    def validate(self) -> None:
        m, n = self.shape
        nnz = self.nnz
        rowind = _t.to_numpy(self.rowind)
        colind = _t.to_numpy(self.colind)
        if nnz:
            if rowind[:nnz].min() < 0 or rowind[:nnz].max() >= m:
                raise ValueError("rowind out of range")
            if colind[:nnz].min() < 0 or colind[:nnz].max() >= n:
                raise ValueError("colind out of range")
            if np.any(np.diff(rowind[:nnz]) < 0):
                raise ValueError("COO entries not grouped by row")
        if _t.to_numpy(self.values)[nnz:].any():
            raise ValueError("COO padding carries nonzero values")
        if rowind[nnz:].any() or colind[nnz:].any():
            raise ValueError("COO padding carries nonzero indices")

    def __repr__(self):
        return (f"COO(shape={self.shape}, capacity={self.capacity}, "
                f"dtype={self.dtype}, device={self.device})")


def csr_to_coo(a: CSR) -> COO:
    """CSR -> COO over the same values and columns; the padded rows are 0
    (the class invariant), not ``row_ids``'s sentinel m."""
    rows = torch.where(a.entry_mask(), a.row_ids(), 0)
    return COO(values=a.values, rowind=rows.to(_t.index_dtype),
               colind=a.colind, nnz=a.nnz, shape=a.shape)


def csc_to_coo(a) -> COO:
    """CSC -> COO re-sorted row-major, with canonical zero padding."""
    from spblas_tpu_torch.formats.convert import to_coo
    return to_coo(a)

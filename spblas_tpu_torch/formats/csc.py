"""CSC container — counterpart of ``spblas_tpu/formats/csc.py``.

Same padded-capacity design as :mod:`spblas_tpu_torch.formats.csr`;
``colptr`` compresses columns and ``rowind`` holds per-entry row indices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import _pad_to


@dataclasses.dataclass(frozen=True)
class CSC:
    """values (capacity,), colptr (n + 1,), rowind (capacity,), nnz (host
    int), shape (m, n)."""

    values: torch.Tensor
    colptr: torch.Tensor
    rowind: torch.Tensor
    nnz: int
    shape: Tuple[int, int]

    @classmethod
    def from_arrays(cls, values, colptr, rowind, shape, nnz=None,
                    capacity=None, device=None) -> "CSC":
        dev = _t.resolve_device(device)
        values = _t.as_tensor(values, dev)
        colptr = _t.as_tensor(colptr, dev, _t.offset_dtype)
        rowind = _t.as_tensor(rowind, dev, _t.index_dtype)
        nnz = int(values.shape[0]) if nnz is None else int(nnz)
        if capacity is None:
            capacity = max(_t.quantize_capacity(nnz), int(values.shape[0]))
        if int(values.shape[0]) > nnz:
            values = torch.cat([values[:nnz],
                                values.new_zeros(values.shape[0] - nnz)])
            rowind = torch.cat([rowind[:nnz],
                                rowind.new_zeros(rowind.shape[0] - nnz)])
        return cls(values=_pad_to(values, capacity), colptr=colptr,
                   rowind=_pad_to(rowind, capacity), nnz=nnz,
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_dense(cls, dense, capacity=None, tol=0.0,
                   device=None) -> "CSC":
        dense = _t.to_numpy(dense) if isinstance(dense, torch.Tensor) \
            else np.asarray(dense)
        m, n = dense.shape
        cols, rows = np.nonzero(np.abs(dense.T) > tol)
        vals = dense[rows, cols]
        colptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(colptr[1:], cols, 1)
        return cls.from_arrays(vals, np.cumsum(colptr), rows, (m, n),
                               nnz=len(vals), capacity=capacity,
                               device=device)

    def update(self, values, colptr=None, rowind=None, nnz=None) -> "CSC":
        """Functional re-bind over new buffers, on this matrix's device."""
        dev = self.device
        return CSC(values=_t.as_tensor(values, dev),
                   colptr=self.colptr if colptr is None else _t.as_tensor(
                       colptr, dev, _t.offset_dtype),
                   rowind=self.rowind if rowind is None else _t.as_tensor(
                       rowind, dev, _t.index_dtype),
                   nnz=self.nnz if nnz is None else int(nnz),
                   shape=self.shape)

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def col_ids(self) -> torch.Tensor:
        """Per-entry column index, (capacity,); padded entries map to n."""
        e = torch.arange(self.capacity, dtype=self.colptr.dtype,
                         device=self.device)
        return torch.searchsorted(self.colptr[1:], e, right=True,
                                  out_int32=True)

    def col_lengths(self) -> torch.Tensor:
        return (self.colptr[1:] - self.colptr[:-1]).to(_t.index_dtype)

    def entry_mask(self) -> torch.Tensor:
        """(capacity,) bool — True for live entries."""
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n + 1), dtype=self.dtype, device=self.device)
        out.index_put_((self.rowind.long(), self.col_ids().long()),
                       self.values, accumulate=True)
        return out[:, :n]

    def validate(self) -> None:
        m, n = self.shape
        colptr = _t.to_numpy(self.colptr)
        rowind = _t.to_numpy(self.rowind)
        values = _t.to_numpy(self.values)
        nnz = self.nnz
        if colptr.shape != (n + 1,):
            raise ValueError(f"colptr shape {colptr.shape} != ({n + 1},)")
        if colptr[0] != 0 or colptr[-1] != nnz:
            raise ValueError("colptr must start at 0 and end at nnz")
        if np.any(np.diff(colptr) < 0):
            raise ValueError("colptr must be monotone non-decreasing")
        if nnz and (rowind[:nnz].min() < 0 or rowind[:nnz].max() >= m):
            raise ValueError("rowind out of range")
        if np.any(values[nnz:] != 0) or np.any(rowind[nnz:] != 0):
            raise ValueError("padding not canonical (zeros)")

    def __repr__(self):
        return (f"CSC(shape={self.shape}, capacity={self.capacity}, "
                f"dtype={self.dtype}, device={self.device})")

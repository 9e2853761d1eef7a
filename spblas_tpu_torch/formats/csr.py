"""CSR container — counterpart of ``spblas_tpu/formats/csr.py``.

A frozen dataclass of tensors with *static capacity*: ``values`` and
``colind`` are padded to ``capacity >= nnz``.  ``nnz`` is a host integer
here (no device sync to read it).

Canonical padding invariant: entries at positions >= nnz have
``values == 0`` and ``colind == 0``, and ``row_ids`` maps them to row
``m`` (one past the last row), so numeric ops may ignore ``nnz``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with padded static capacity.

      values: (capacity,) scalar dtype
      rowptr: (m + 1,) int32, rowptr[m] == nnz
      colind: (capacity,) int32
      nnz:    live entry count (host int)
      shape:  (m, n)
    """

    values: torch.Tensor
    rowptr: torch.Tensor
    colind: torch.Tensor
    nnz: int
    shape: Tuple[int, int]

    @classmethod
    def from_arrays(cls, values, rowptr, colind, shape, nnz=None,
                    capacity=None, device=None) -> "CSR":
        """Build a CSR from (possibly unpadded) numpy arrays or tensors;
        ``capacity`` defaults to a power-of-two bucket of nnz."""
        dev = _t.resolve_device(device)
        values = _t.as_tensor(values, dev)
        rowptr = _t.as_tensor(rowptr, dev, _t.offset_dtype)
        colind = _t.as_tensor(colind, dev, _t.index_dtype)
        nnz = int(values.shape[0]) if nnz is None else int(nnz)
        if capacity is None:
            capacity = max(_t.quantize_capacity(nnz), int(values.shape[0]))
        if int(values.shape[0]) > nnz:
            # canonical zero padding over caller-supplied oversized buffers
            values = torch.cat([values[:nnz],
                                values.new_zeros(values.shape[0] - nnz)])
            colind = torch.cat([colind[:nnz],
                                colind.new_zeros(colind.shape[0] - nnz)])
        return cls(values=_pad_to(values, capacity), rowptr=rowptr,
                   colind=_pad_to(colind, capacity), nnz=nnz,
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_dense(cls, dense, capacity=None, tol=0.0,
                   device=None) -> "CSR":
        dense = _t.to_numpy(dense) if isinstance(dense, torch.Tensor) \
            else np.asarray(dense)
        m, n = dense.shape
        rows, cols = np.nonzero(np.abs(dense) > tol)
        vals = dense[rows, cols]
        rowptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(rowptr[1:], rows, 1)
        return cls.from_arrays(vals, np.cumsum(rowptr), cols, (m, n),
                               nnz=len(vals), capacity=capacity,
                               device=device)

    def update(self, values, rowptr=None, colind=None, nnz=None) -> "CSR":
        """Functional re-bind over new buffers, on this matrix's device."""
        dev = self.device
        return CSR(values=_t.as_tensor(values, dev),
                   rowptr=self.rowptr if rowptr is None else _t.as_tensor(
                       rowptr, dev, _t.offset_dtype),
                   colind=self.colind if colind is None else _t.as_tensor(
                       colind, dev, _t.index_dtype),
                   nnz=self.nnz if nnz is None else int(nnz),
                   shape=self.shape)

    def with_capacity(self, capacity: int) -> "CSR":
        """Grow or shrink the padded capacity (the caller ensures nnz
        fits; shrinking only drops canonical zero padding)."""
        capacity = int(capacity)
        if capacity < self.capacity:
            return dataclasses.replace(self, values=self.values[:capacity],
                                       colind=self.colind[:capacity])
        return dataclasses.replace(self,
                                   values=_pad_to(self.values, capacity),
                                   colind=_pad_to(self.colind, capacity))

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def index_dtype(self):
        return self.colind.dtype

    def row_ids(self) -> torch.Tensor:
        """Per-entry row index, (capacity,).  Padded entries map to m."""
        e = torch.arange(self.capacity, dtype=self.rowptr.dtype,
                         device=self.device)
        return torch.searchsorted(self.rowptr[1:], e, right=True,
                                  out_int32=True)

    def row_lengths(self) -> torch.Tensor:
        return (self.rowptr[1:] - self.rowptr[:-1]).to(_t.index_dtype)

    def entry_mask(self) -> torch.Tensor:
        """(capacity,) bool — True for live entries."""
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m + 1, n), dtype=self.dtype, device=self.device)
        out.index_put_((self.row_ids().long(), self.colind.long()),
                       self.values, accumulate=True)
        return out[:m]

    def validate(self) -> None:
        """Host-side structural checks; raises ValueError on violation."""
        m, n = self.shape
        rowptr = _t.to_numpy(self.rowptr)
        colind = _t.to_numpy(self.colind)
        values = _t.to_numpy(self.values)
        nnz = self.nnz
        if rowptr.shape != (m + 1,):
            raise ValueError(f"rowptr shape {rowptr.shape} != ({m + 1},)")
        if rowptr[0] != 0 or rowptr[-1] != nnz:
            raise ValueError("rowptr must start at 0 and end at nnz")
        if np.any(np.diff(rowptr) < 0):
            raise ValueError("rowptr must be monotone non-decreasing")
        if nnz > self.capacity:
            raise ValueError(f"nnz {nnz} exceeds capacity {self.capacity}")
        if nnz and (colind[:nnz].min() < 0 or colind[:nnz].max() >= n):
            raise ValueError("colind out of range")
        if np.any(values[nnz:] != 0) or np.any(colind[nnz:] != 0):
            raise ValueError("padding not canonical (zeros)")

    def __repr__(self):
        return (f"CSR(shape={self.shape}, capacity={self.capacity}, "
                f"dtype={self.dtype}, device={self.device})")


def host_row_ids(rowptr, nnz: int, m: int) -> np.ndarray:
    """Per-live-entry row ids from a (possibly capacity-padded) rowptr —
    the shared host-inspect idiom (numpy only)."""
    rowptr = np.asarray(rowptr).astype(np.int64)
    lo = np.minimum(rowptr[:-1], nnz)
    hi = np.minimum(rowptr[1:], nnz)
    return np.repeat(np.arange(m), hi - lo)


def host_arrays(a: CSR):
    """(rows, cols, values) of the live entries, as numpy, for the host
    plan builders."""
    nnz = a.nnz
    rows = host_row_ids(_t.to_numpy(a.rowptr), nnz, a.shape[0])
    return rows, _t.to_numpy(a.colind[:nnz]), _t.to_numpy(a.values[:nnz])


def _pad_to(arr: torch.Tensor, capacity: int) -> torch.Tensor:
    n = arr.shape[0]
    if n == capacity:
        return arr
    if n > capacity:
        raise ValueError(f"array length {n} exceeds capacity {capacity}")
    return torch.cat([arr, arr.new_zeros(capacity - n)])

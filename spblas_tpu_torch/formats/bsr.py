"""BSR container (block compressed sparse row) — counterpart of
``spblas_tpu/formats/bsr.py``.

Each stored entry is a dense (bh, bw) block, so SpMV and SpMM become
batched dense products with no index traffic inside a block
(``kernels/bsr_kernels.py``).

Layout: values (capacity, bh, bw), block_rowptr (mb + 1,) int32,
block_colind (capacity,) int32, where mb = m // bh.  Blocks past
``nnz_blocks`` (capacity padding) hold zeros and block column 0; only
``block_rowptr`` bounds a block row, so numeric code may ignore them.
``nnz_blocks`` is a host integer, as ``CSR.nnz`` is.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR, host_arrays


def block_column_order(block_rowptr: torch.Tensor,
                       block_colind: torch.Tensor, ncb: int):
    """The stored blocks in block-column order, made on their device with
    no host sync: ``(col_ptr, col_order)``, int32, where
    ``col_order[col_ptr[j]:col_ptr[j + 1]]`` are the indices of the
    stored blocks of block column j in block-row order (a stable sort;
    capacity padding sorts past the last column and is never listed).
    ``ncb`` is the number of block columns."""
    cap = block_colind.shape[0]
    dev = block_colind.device
    stored = torch.arange(cap, device=dev) < block_rowptr[-1]
    key = torch.where(stored, block_colind.long(),
                      torch.full_like(block_colind, ncb, dtype=torch.int64))
    order = torch.argsort(key, stable=True).to(torch.int32)
    counts = torch.zeros(ncb + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, key, torch.ones_like(key))
    col_ptr = torch.zeros(ncb + 1, dtype=torch.int32, device=dev)
    col_ptr[1:] = torch.cumsum(counts[:ncb], 0)
    return col_ptr, order


@dataclasses.dataclass(frozen=True)
class BSR:
    values: torch.Tensor        # (capacity, bh, bw)
    block_rowptr: torch.Tensor  # (mb + 1,) int32
    block_colind: torch.Tensor  # (capacity,) int32
    nnz_blocks: int
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @classmethod
    def _from_blocks(cls, blocks, brow, bcol, mb, shape, block_shape,
                     capacity, device) -> "BSR":
        """Pad the (nnzb, bh, bw) blocks, sorted by block row, to
        ``capacity`` (default: a power-of-two bucket of nnzb)."""
        nnzb = len(brow)
        if capacity is None:
            capacity = _t.quantize_capacity(max(nnzb, 1))
        if nnzb > capacity:
            raise ValueError("capacity too small")
        bh, bw = block_shape
        vals = np.zeros((capacity, bh, bw), dtype=blocks.dtype)
        vals[:nnzb] = blocks
        cols = np.zeros(capacity, np.int64)
        cols[:nnzb] = bcol
        rowptr = np.zeros(mb + 1, dtype=np.int64)
        np.add.at(rowptr[1:], brow, 1)
        return cls(values=_t.as_tensor(vals, device),
                   block_rowptr=_t.as_tensor(np.cumsum(rowptr), device,
                                             _t.offset_dtype),
                   block_colind=_t.as_tensor(cols, device, _t.index_dtype),
                   nnz_blocks=nnzb, shape=(int(shape[0]), int(shape[1])),
                   block_shape=(int(bh), int(bw)))

    @classmethod
    def from_dense(cls, dense, block_shape=(128, 128), capacity=None,
                   tol=0.0, device=None) -> "BSR":
        dense = _t.to_numpy(dense) if isinstance(dense, torch.Tensor) \
            else np.asarray(dense)
        m, n = dense.shape
        bh, bw = block_shape
        if m % bh or n % bw:
            raise ValueError(
                f"shape {dense.shape} not divisible by blocks {block_shape}")
        mb, nb = m // bh, n // bw
        blocks = dense.reshape(mb, bh, nb, bw).transpose(0, 2, 1, 3)
        nz = np.abs(blocks).max(axis=(2, 3)) > tol   # (mb, nb)
        brow, bcol = np.nonzero(nz)
        return cls._from_blocks(blocks[brow, bcol], brow, bcol, mb, (m, n),
                                (bh, bw), capacity,
                                _t.resolve_device(device))

    @classmethod
    def from_csr(cls, a: CSR, block_shape=(128, 128),
                 capacity=None) -> "BSR":
        """Host-side re-blocking of a CSR matrix (an inspect-phase
        conversion), by direct entry scatter with no dense intermediate;
        the blocks land on the CSR's device."""
        bh, bw = block_shape
        m, n = a.shape
        if m % bh or n % bw:
            raise ValueError(
                f"shape {a.shape} not divisible by blocks {block_shape}")
        rows, cols, vals = host_arrays(a)
        cols = cols.astype(np.int64)
        nb = n // bw
        uniq, inv = np.unique((rows // bh) * nb + cols // bw,
                              return_inverse=True)
        blocks = np.zeros((len(uniq), bh, bw), dtype=vals.dtype)
        blocks[inv, rows % bh, cols % bw] = vals
        return cls._from_blocks(blocks, uniq // nb, uniq % nb, m // bh,
                                (m, n), (bh, bw), capacity, a.device)

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
    def nnz(self) -> int:
        bh, bw = self.block_shape
        return self.nnz_blocks * bh * bw

    @functools.cached_property
    def column_order(self):
        """:func:`block_column_order` of this structure, made on first use
        and kept (the f32 SpMM kernel's work list)."""
        return block_column_order(self.block_rowptr, self.block_colind,
                                  self.shape[1] // self.block_shape[1])

    @functools.cached_property
    def tf32_gate(self):
        """:func:`types.tf32_gate` of the stored blocks, (exact, amax),
        made on first use and kept."""
        return _t.tf32_gate(self.values[: self.nnz_blocks])

    @property
    def tf32_exact(self) -> bool:
        """False sends the f32 SpMM and block SpGEMM off the 3xTF32
        tensor-core kernels (values below 2^-112 keep fewer bits there;
        infinities and NaNs can read NaN)."""
        return self.tf32_gate[0]

    @property
    def tf32_amax(self) -> float:
        """The stored blocks' largest magnitude: the SpMM kernel's test of
        B and the block SpGEMM's product test are set from it."""
        return self.tf32_gate[1]

    def block_row_ids(self) -> torch.Tensor:
        """Per-block block-row index, (capacity,); padded blocks map to
        mb."""
        e = torch.arange(self.capacity, dtype=self.block_rowptr.dtype,
                         device=self.device)
        return torch.searchsorted(self.block_rowptr[1:], e, right=True,
                                  out_int32=True)

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        bh, bw = self.block_shape
        mb, nb = m // bh, n // bw
        out = torch.zeros((mb + 1, nb, bh, bw), dtype=self.dtype,
                          device=self.device)
        out.index_put_((self.block_row_ids().long(),
                        self.block_colind.long()), self.values,
                       accumulate=True)
        return out[:mb].permute(0, 2, 1, 3).reshape(m, n)

    def __repr__(self):
        return (f"BSR(shape={self.shape}, blocks={self.block_shape}, "
                f"capacity={self.capacity}, dtype={self.dtype}, "
                f"device={self.device})")

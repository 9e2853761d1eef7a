"""Row-block CSR: the distributed container for SpGEMM, SpADD and SpMM —
counterpart of ``spblas_tpu/parallel/rowblock.py``.

Rank d owns global rows [d*mloc, (d+1)*mloc) as a local CSR with global
column indices, every rank padded to one entry capacity (canonical
padding: value 0, column 0).  Each rank holds its own slice: ``values``
is ``values[rank]`` of the JAX package's stacked ``(p, lcap)`` arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.parallel.mesh import RowMesh


@dataclasses.dataclass(frozen=True)
class RowBlockCSR:
    """One rank's row block: values (lcap,); colind (lcap,) global
    column ids; rowptr (mloc + 1,) local offsets with rowptr[mloc] = the
    block's live entries, ``nnz`` (a host int)."""

    values: torch.Tensor
    colind: torch.Tensor
    rowptr: torch.Tensor
    nnz: int
    shape: Tuple[int, int]
    mloc: int
    p: int
    rank: int

    @property
    def local_capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    def local_csr(self) -> CSR:
        """The block as a port CSR of shape (mloc, n), its arrays shared."""
        return CSR(values=self.values, rowptr=self.rowptr,
                   colind=self.colind, nnz=self.nnz,
                   shape=(self.mloc, self.shape[1]))


def local_rowptr(rowptr, d: int, mloc: int, m: int):
    """Rank ``d``'s zero-based clamped sub-rowptr (mloc+1) plus its
    global entry range [lo, hi): the block-slicing idiom shared by
    partition_route, partition_sell and partition_rowblock."""
    r0, r1 = min(d * mloc, m), min((d + 1) * mloc, m)
    lo, hi = int(rowptr[r0]), int(rowptr[r1])
    sub = np.zeros(mloc + 1, np.int64)
    if r1 > r0:
        sub[: r1 - r0 + 1] = rowptr[r0: r1 + 1] - lo
    sub[r1 - r0 + 1:] = hi - lo
    return lo, hi, sub


def partition_rowblock(a, mesh: RowMesh,
                       local_capacity: int | None = None) -> RowBlockCSR:
    """Host-side partition: this rank's block of the global CSR ``a``,
    at the capacity of the fullest rank's block."""
    a = to_csr(a)
    p, d = mesh.size, mesh.rank
    m, n = a.shape
    mloc = -(-m // p)
    nnz = a.nnz
    rowptr = np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), nnz)
    starts = rowptr[np.minimum(np.arange(p) * mloc, m)]
    ends = rowptr[np.minimum((np.arange(p) + 1) * mloc, m)]
    cap = int((ends - starts).max()) if p else 1
    cap = max(_t.quantize_capacity(max(cap, 1)), 1)
    if local_capacity is not None:
        if local_capacity < cap:
            raise ValueError(
                f"local_capacity {local_capacity} < required {cap}")
        cap = int(local_capacity)

    lo, hi, sub = local_rowptr(rowptr, d, mloc, m)
    vals = np.zeros(cap, dtype=_t.to_numpy(a.values[:1]).dtype)
    cols = np.zeros(cap, dtype=np.int32)
    vals[: hi - lo] = _t.to_numpy(a.values[lo:hi])
    cols[: hi - lo] = _t.to_numpy(a.colind[lo:hi])
    dev = mesh.device
    return RowBlockCSR(
        values=torch.from_numpy(vals).to(dev),
        colind=torch.from_numpy(cols).to(dev),
        rowptr=torch.from_numpy(sub.astype(np.int32)).to(dev),
        nnz=hi - lo, shape=(m, n), mloc=mloc, p=p, rank=d)


def assemble_csr(rb: RowBlockCSR, mesh: RowMesh) -> CSR:
    """Reassembly of every rank's block into the global CSR, on every
    rank (all-gathers of the block arrays), on the mesh's device."""
    p, mloc = rb.p, rb.mloc
    m, n = rb.shape
    values = _t.to_numpy(mesh.all_gather(rb.values))
    colind = _t.to_numpy(mesh.all_gather(rb.colind))
    rowptr = _t.to_numpy(mesh.all_gather(rb.rowptr)).astype(np.int64)
    out_vals, out_cols, counts = [], [], np.zeros(m + 1, dtype=np.int64)
    for d in range(p):
        r1 = max(0, min((d + 1) * mloc, m) - d * mloc)
        k = int(rowptr[d, r1])
        out_vals.append(values[d, :k])
        out_cols.append(colind[d, :k])
        counts[d * mloc + 1: d * mloc + r1 + 1] = np.diff(
            rowptr[d, : r1 + 1])
    return CSR.from_arrays(np.concatenate(out_vals),
                           np.cumsum(counts), np.concatenate(out_cols),
                           (m, n), nnz=int(counts.sum()),
                           device=mesh.device)

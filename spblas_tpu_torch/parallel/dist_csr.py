"""Row-partitioned distributed sparse matrix — counterpart of
``spblas_tpu/parallel/dist_csr.py``.

Rank d owns rows [d*mloc, (d+1)*mloc) (the global row count padded to
p*mloc; padding rows are empty).  Its rows are column-blocked into p
blocks matching the row partition of x, stored rotation-scheduled:
position s on rank d holds the block for the columns of rank (d+s) % p,
so the ring SpMV indexes blocks by its step counter.  Blocks are
COO-of-blocks with one padded capacity (``rowloc`` sentinel ``mloc``,
value 0), so the gather·mul·``index_add`` step needs no masks.

Each rank holds its own slice: ``values[s]`` here is ``values[rank, s]``
of the JAX package's stacked ``(p, p, bcap)`` arrays, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import CSR, host_arrays
from spblas_tpu_torch.parallel.mesh import RowMesh


@dataclasses.dataclass(frozen=True)
class DistCSR:
    """One rank's slice of a row-partitioned matrix.

      values  (p, bcap)  [s] = entries of this rank's rows with columns
                         in block (rank+s) % p
      rowloc  (p, bcap)  local row id in [0, mloc); sentinel mloc = pad
      colloc  (p, bcap)  column id local to its block, in [0, nloc)
      nnz                total live entries over every rank (host int)

    shape is the unpadded global (m, n); mloc/nloc are padded block
    sizes (m <= p*mloc, n <= p*nloc)."""

    values: torch.Tensor
    rowloc: torch.Tensor
    colloc: torch.Tensor
    nnz: int
    shape: Tuple[int, int]
    mloc: int
    nloc: int
    rank: int

    @property
    def p(self) -> int:
        return int(self.values.shape[0])

    @property
    def block_capacity(self) -> int:
        return int(self.values.shape[1])

    @property
    def dtype(self):
        return self.values.dtype


def partition_csr(a, mesh: RowMesh, block_capacity: int | None = None
                  ) -> DistCSR:
    """Host inspect step: this rank's slice of the rotation-scheduled
    partition of the global CSR ``a`` (every rank passes the whole
    matrix; the block capacity comes from every rank's counts)."""
    a = to_csr(a)
    p, d = mesh.size, mesh.rank
    m, n = a.shape
    mloc = -(-m // p)
    nloc = -(-n // p)
    rows, cols, vals = host_arrays(a)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    nnz = len(vals)

    dev = rows // mloc                      # owning rank of each entry
    slot = (cols // nloc - dev) % p         # rotation-scheduled position
    counts = np.zeros((p, p), dtype=np.int64)
    np.add.at(counts, (dev, slot), 1)
    cap = int(counts.max()) if nnz else 1
    cap = max(_t.quantize_capacity(cap), 1)
    if block_capacity is not None:
        if block_capacity < cap:
            raise ValueError(
                f"block_capacity {block_capacity} < required {cap}")
        cap = int(block_capacity)

    own = dev == d
    rows, cols, slot, vals = rows[own], cols[own], slot[own], vals[own]
    values = np.zeros((p, cap), dtype=vals.dtype)
    rowloc = np.full((p, cap), mloc, dtype=np.int32)
    colloc = np.zeros((p, cap), dtype=np.int32)
    # stable order inside each block: by (slot, row, col); each entry's
    # offset is its rank in its slot's run
    order = np.lexsort((cols, rows, slot))
    slot_s = slot[order]
    k = len(order)
    if k:
        first = np.concatenate([[True], slot_s[1:] != slot_s[:-1]])
        grp_start = np.flatnonzero(first)
        pos = np.arange(k) - np.repeat(
            grp_start, np.diff(np.append(grp_start, k)))
    else:
        pos = np.zeros(0, dtype=np.int64)
    values[slot_s, pos] = vals[order]
    rowloc[slot_s, pos] = (rows[order] % mloc).astype(np.int32)
    colloc[slot_s, pos] = (cols[order] % nloc).astype(np.int32)
    put = lambda arr: torch.from_numpy(arr).to(mesh.device)  # noqa: E731
    return DistCSR(values=put(values), rowloc=put(rowloc),
                   colloc=put(colloc), nnz=nnz, shape=(m, n), mloc=mloc,
                   nloc=nloc, rank=d)


def rank_rows(x, total: int, rows: int, rank: int,
              device) -> torch.Tensor:
    """Rows [rank*rows, (rank+1)*rows) of x zero-padded to ``total``
    rows, on ``device``."""
    x = torch.as_tensor(x)
    if x.shape[0] < total:
        x = torch.cat([x, x.new_zeros((total - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    return x[rank * rows:(rank + 1) * rows].to(device).contiguous()


def partition_vector(x, dist: DistCSR, mesh: RowMesh, axis: str = "cols"
                     ) -> torch.Tensor:
    """This rank's chunk of x padded to p*nloc (p*mloc for
    ``axis='rows'``): rows [rank*nloc, (rank+1)*nloc)."""
    size = dist.nloc if axis == "cols" else dist.mloc
    return rank_rows(x, dist.p * size, size, mesh.rank, mesh.device)


def gather_result(y: torch.Tensor, dist: DistCSR,
                  mesh: RowMesh) -> torch.Tensor:
    """Every rank's piece of a distributed result (all-gathered), the row
    padding stripped: the global (m,) or (m, k) result on every rank."""
    g = mesh.all_gather(y)
    return g.reshape((-1,) + tuple(y.shape[1:]))[: dist.shape[0]]


def to_local_csr(dist: DistCSR, mesh: RowMesh) -> CSR:
    """Reassemble the global CSR on every rank (one all-gather of each
    block array), on the mesh's device (testing / IO utility)."""
    p, mloc, nloc = dist.p, dist.mloc, dist.nloc
    values = _t.to_numpy(mesh.all_gather(dist.values))
    rowloc = _t.to_numpy(mesh.all_gather(dist.rowloc))
    colloc = _t.to_numpy(mesh.all_gather(dist.colloc))
    rows, cols, vals = [], [], []
    for d in range(p):
        for s in range(p):
            live = rowloc[d, s] < mloc
            rows.append(rowloc[d, s][live] + d * mloc)
            cols.append(colloc[d, s][live] + ((d + s) % p) * nloc)
            vals.append(values[d, s][live])
    rows = np.concatenate(rows).astype(np.int64)
    cols = np.concatenate(cols).astype(np.int64)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    m, n = dist.shape
    rowptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rowptr[1:], rows, 1)
    return CSR.from_arrays(vals, np.cumsum(rowptr), cols, (m, n),
                           nnz=len(vals), device=mesh.device)

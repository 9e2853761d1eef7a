"""Seeded random matrix generators — the port's own copy of the
distributions of ``spblas_tpu/utils/generate.py``.

The same seed gives the same numpy arrays as the JAX package's
generators: unique random (row, col) entries, sorted row-major, values
U[0, 100), and ``generate_csr`` shuffles colind within rows so no
algorithm may assume sorted rows.  Every generator takes the ``device``
its result lives on (default: ``cuda``, raising without a card).
"""

from __future__ import annotations

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR


def _complex_dtype(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        return dtype
    return np.dtype(np.complex128 if dtype == np.float64 else np.complex64)


def _coo_arrays(m, n, nnz, seed=0, dtype=np.float32, complex_=False):
    if nnz > m * n:
        raise ValueError("nnz exceeds m*n")
    rng = np.random.default_rng(seed)
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows = (flat // n).astype(np.int64)
    cols = (flat % n).astype(np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    if complex_:
        vals = (rng.uniform(0, 100, nnz) + 1j * rng.uniform(0, 100, nnz)
                ).astype(_complex_dtype(dtype))
    else:
        vals = rng.uniform(0, 100, nnz).astype(dtype)
    return vals, rows, cols


def _rows_to_rowptr(rows, m):
    rowptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rowptr[1:], rows, 1)
    return np.cumsum(rowptr)


def generate_csr_arrays(m, n, nnz, seed=0, dtype=np.float32,
                        complex_=False):
    """Host (numpy) arrays ``(vals, rowptr, cols)`` of
    :func:`generate_csr`."""
    vals, rows, cols = _coo_arrays(m, n, nnz, seed, dtype, complex_)
    rowptr = _rows_to_rowptr(rows, m)
    # within-row shuffle: lexsort by (row, random key)
    rng = np.random.default_rng(seed)
    order = np.lexsort((rng.random(nnz), rows))
    return vals[order], rowptr, cols[order]


def generate_csr(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                 capacity=None, device=None) -> CSR:
    """CSR with *shuffled* colind within each row."""
    vals, rowptr, cols = generate_csr_arrays(m, n, nnz, seed, dtype,
                                             complex_)
    return CSR.from_arrays(vals, rowptr, cols, (m, n), nnz=nnz,
                           capacity=capacity, device=device)


def generate_dense(m, n, seed=0, dtype=np.float32, complex_=False,
                   device=None) -> torch.Tensor:
    """Dense U[0, 100) matrix."""
    rng = np.random.default_rng(seed)
    if complex_:
        arr = (rng.uniform(0, 100, (m, n))
               + 1j * rng.uniform(0, 100, (m, n))).astype(
                   _complex_dtype(dtype))
    else:
        arr = rng.uniform(0, 100, (m, n)).astype(dtype)
    return _t.as_tensor(arr, _t.resolve_device(device))


def generate_vector(n, seed=0, dtype=np.float32, complex_=False,
                    device=None) -> torch.Tensor:
    return generate_dense(1, n, seed, dtype, complex_, device)[0]


def generate_banded_csr(m, n, bandwidth, seed=0, dtype=np.float32,
                        capacity=None, device=None) -> CSR:
    """Synthetic banded matrix with half-bandwidth ``bandwidth // 2`` —
    the headline SpMV matrix."""
    rng = np.random.default_rng(seed)
    half = bandwidth // 2
    rows_l, cols_l = [], []
    for off in range(-half, half + 1):
        i0, i1 = max(0, -off), min(m, n - off)
        if i1 <= i0:
            continue
        i = np.arange(i0, i1, dtype=np.int64)
        rows_l.append(i)
        cols_l.append(i + off)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.uniform(-1, 1, len(rows))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = vals + 1j * rng.uniform(-1, 1, len(rows))
    vals = vals.astype(dtype)
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, m), cols, (m, n),
                           nnz=len(rows), capacity=capacity, device=device)


def _coo_to_csr(rows, cols, vals, shape, capacity=None,
                device=None) -> CSR:
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, shape[0]), cols,
                           shape, nnz=len(rows), capacity=capacity,
                           device=device)


def generate_stencil_csr(dims, seed=0, dtype=np.float32, capacity=None,
                         device=None) -> CSR:
    """Finite-difference Laplacian stencil on a structured grid: 2D
    5-point for ``dims=(nx, ny)``, 3D 7-point for ``(nx, ny, nz)``.
    Diagonal = coordination number, off-diagonals = -1 with a small
    seeded jitter."""
    dims = tuple(int(d) for d in dims)
    m = int(np.prod(dims))
    idx = np.arange(m, dtype=np.int64)
    grid = np.unravel_index(idx, dims)
    rows_l, cols_l = [idx], [idx]
    for ax in range(len(dims)):
        for step in (-1, 1):
            coord = grid[ax] + step
            ok = (coord >= 0) & (coord < dims[ax])
            nb = list(grid)
            nb[ax] = np.where(ok, coord, grid[ax])
            j = np.ravel_multi_index(tuple(nb), dims)
            rows_l.append(idx[ok])
            cols_l.append(j[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    rng = np.random.default_rng(seed)
    vals = np.where(rows == cols, 2.0 * len(dims),
                    -1.0 + 0.01 * rng.standard_normal(len(rows)))
    return _coo_to_csr(rows, cols, vals.astype(dtype), (m, m), capacity,
                       device)


def generate_fem_graph_csr(nx, ny, seed=0, dtype=np.float32,
                           capacity=None, device=None) -> CSR:
    """FEM-style mesh graph: P1 triangles on an ``nx x ny`` structured
    triangulation with per-cell randomized diagonal flips (node degrees
    4-8, nine diagonals)."""
    m = nx * ny
    idx = np.arange(m, dtype=np.int64)
    ix, iy = idx // ny, idx % ny
    rows_l, cols_l = [idx], [idx]           # self (diagonal)
    for dx, dy in ((1, 0), (0, 1)):         # grid edges, both directions
        ok = (ix + dx < nx) & (iy + dy < ny)
        j = idx + dx * ny + dy
        rows_l += [idx[ok], j[ok]]
        cols_l += [j[ok], idx[ok]]
    rng = np.random.default_rng(seed)       # one random diagonal per cell
    cok = (ix < nx - 1) & (iy < ny - 1)
    cells = idx[cok]
    flip = rng.integers(0, 2, len(cells)).astype(bool)
    a = np.where(flip, cells, cells + ny)
    b = np.where(flip, cells + ny + 1, cells + 1)
    rows_l += [a, b]
    cols_l += [b, a]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    deg = np.zeros(m, np.int64)
    np.add.at(deg, rows[rows != cols], 1)
    vals = np.where(rows == cols, deg[rows].astype(np.float64) + 1.0,
                    -1.0 + 0.01 * rng.standard_normal(len(rows)))
    return _coo_to_csr(rows, cols, vals.astype(dtype), (m, m), capacity,
                       device)

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
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.dcsr import DCSR


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


def generate_coo(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                 capacity=None, device=None) -> COO:
    """COO of unique entries, sorted row-major."""
    vals, rows, cols = _coo_arrays(m, n, nnz, seed, dtype, complex_)
    return COO.from_arrays(vals, rows, cols, (m, n), nnz=nnz,
                           capacity=capacity, device=device)


def _rows_to_rowptr(rows, m):
    rowptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rowptr[1:], rows, 1)
    return np.cumsum(rowptr)


def generate_csr_sorted(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                        capacity=None, device=None) -> CSR:
    """CSR with sorted column indices within rows."""
    vals, rows, cols = _coo_arrays(m, n, nnz, seed, dtype, complex_)
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, m), cols, (m, n),
                           nnz=nnz, capacity=capacity, device=device)


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


def _csc_of(t: CSR, m, n) -> CSC:
    """The CSC of an m x n matrix whose n x m transpose's CSR is ``t``."""
    return CSC(values=t.values, colptr=t.rowptr, rowind=t.colind,
               nnz=t.nnz, shape=(m, n))


def generate_csc_sorted(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                        capacity=None, device=None) -> CSC:
    """CSC of an m x n matrix = CSR of the n x m transpose, row indices
    sorted within columns."""
    return _csc_of(generate_csr_sorted(n, m, nnz, seed, dtype, complex_,
                                       capacity, device), m, n)


def generate_csc(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                 capacity=None, device=None) -> CSC:
    """CSC with row indices shuffled within columns."""
    return _csc_of(generate_csr(n, m, nnz, seed, dtype, complex_, capacity,
                                device), m, n)


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


def generate_gaussian(m, n, seed=0, dtype=np.float32,
                      device=None) -> torch.Tensor:
    """Dense N(0, 1) matrix."""
    rng = np.random.default_rng(seed)
    return _t.as_tensor(rng.normal(0, 1, (m, n)).astype(dtype),
                        _t.resolve_device(device))


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


def generate_dcsr(m, n, nnz, seed=0, dtype=np.float32,
                  device=None) -> DCSR:
    """Hypersparse fixture: entries drawn into about nnz / 4 + 1 random
    rows (duplicates dropped), so most rows are empty."""
    rng = np.random.default_rng(seed)
    num_rows = max(1, min(m, nnz // 4 + 1))
    active = np.sort(rng.choice(m, size=num_rows, replace=False))
    rows = rng.choice(active, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    _, idx = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = rng.uniform(0, 100, len(rows)).astype(dtype)
    return DCSR.from_csr(_coo_to_csr(rows, cols, vals, (m, n),
                                     device=device))


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


def generate_rmat_csr(n, nnz, seed=0, a=0.57, b=0.19, c=0.19,
                      dtype=np.float32, device=None) -> CSR:
    """R-MAT power-law pattern (Chakrabarti et al.), the stand-in for
    skewed-degree matrices: edges drop recursively into quadrants with
    probabilities (a, b, c, 1-a-b-c); duplicates are coalesced, so nnz
    is at most the requested count."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    n_pow = 1 << scale
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for level in range(scale):
        r = rng.random(nnz)
        quad_b = (r >= a) & (r < a + b)
        quad_c = (r >= a + b) & (r < a + b + c)
        quad_d = r >= a + b + c
        bit = 1 << (scale - 1 - level)
        rows += bit * (quad_c | quad_d)
        cols += bit * (quad_b | quad_d)
    keep = (rows < n) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    key = rows * n_pow + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.uniform(0.1, 1.0, len(rows)).astype(dtype) / \
        max(len(rows) / max(n, 1), 1.0)
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, n), cols, (n, n),
                           nnz=len(rows), device=device)


def generate_powerlaw_cluster_csr(n, attach=8, p_tri=0.5, seed=0,
                                  dtype=np.float32, device=None) -> CSR:
    """Scale-free graph with clustering (the Holme-Kim powerlaw-cluster
    model): growing preferential attachment where each new link closes a
    triangle with probability ``p_tri``.  Symmetric, zero-free diagonal,
    values U(0.1, 1) scaled by 1/sqrt(deg) so row sums stay O(1).
    ``data/powerlaw_64k.mtx.gz`` is its export at n 65,536, seed 7."""
    rng = np.random.default_rng(seed)
    attach = int(attach)
    n = int(n)
    if n <= attach + 1:
        raise ValueError("n must exceed attach+1")
    adj = [set() for _ in range(n)]
    # endpoint pool: each edge contributes both endpoints, so uniform
    # draws from the pool are degree-proportional
    pool = []
    for v in range(attach + 1):          # seed clique
        for u in range(v):
            adj[v].add(u)
            adj[u].add(v)
            pool.append(u)
            pool.append(v)
    for v in range(attach + 1, n):
        targets = set()
        last = None
        draws = rng.integers(0, 1 << 62, size=4 * attach)
        coin = rng.random(attach)
        di = 0
        while len(targets) < attach:
            t = None
            if last is not None and coin[len(targets) % attach] < p_tri:
                # triangle step: a random neighbor of the last target
                nbrs = adj[last]
                if nbrs:
                    cand = list(nbrs)[int(draws[di] % len(nbrs))]
                    di = (di + 1) % len(draws)
                    if cand != v and cand not in targets:
                        t = cand
            if t is None:                 # preferential-attachment step
                t = pool[int(draws[di] % len(pool))]
                di = (di + 1) % len(draws)
                if t == v or t in targets:
                    last = None
                    continue
            targets.add(t)
            last = t
        for t in targets:
            adj[v].add(t)
            adj[t].add(v)
            pool.append(v)
            pool.append(t)
    rows = np.concatenate([np.full(len(adj[v]), v, np.int64)
                           for v in range(n)])
    cols = np.concatenate([np.fromiter(adj[v], np.int64, len(adj[v]))
                           for v in range(n)])
    deg = np.bincount(rows, minlength=n)
    # one value per undirected edge (numerically symmetric): a u<v
    # half-edge draws the value, the mirror looks it up by edge key
    lo = np.minimum(rows, cols)
    hi = np.maximum(rows, cols)
    key = lo * n + hi
    uniq, inv = np.unique(key, return_inverse=True)
    edge_vals = rng.uniform(0.1, 1.0, len(uniq))
    scale = 1.0 / np.sqrt(np.maximum(deg[lo], 1) *
                          np.maximum(deg[hi], 1)) ** 0.5
    vals = (edge_vals[inv] * scale).astype(dtype)
    return _coo_to_csr(rows, cols, vals, (n, n), device=device)


def generate_triangular_csr(m, seed=0, lower=True, unit_diag=False,
                            density=0.05, dtype=np.float32, capacity=None,
                            device=None) -> CSR:
    """Well-conditioned random triangular factor for SpTRSV: each row
    draws Binomial(span, density) distinct off-diagonal columns of its
    triangle, values U[-1, 1); the diagonal (unless ``unit_diag``) is
    m + U[1, 2), so substitution is stable."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l, vals_l = [], [], []
    for r in range(m):
        lo, hi = (0, r) if lower else (r + 1, m)
        span = hi - lo
        k = min(span, rng.binomial(span, density)) if span > 0 else 0
        if k > 0:
            cs = np.sort(rng.choice(np.arange(lo, hi), size=k,
                                    replace=False))
            rows_l.append(np.full(k, r, dtype=np.int64))
            cols_l.append(cs)
            vals_l.append(rng.uniform(-1, 1, k).astype(dtype))
        if not unit_diag:
            rows_l.append(np.array([r], dtype=np.int64))
            cols_l.append(np.array([r], dtype=np.int64))
            vals_l.append(np.array([m + rng.uniform(1, 2)], dtype=dtype))
    if rows_l:
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate(vals_l)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
    else:  # strictly-unit-diagonal factor with no off-diagonal entries
        rows = np.zeros(0, np.int64)
        cols = np.zeros(0, np.int64)
        vals = np.zeros(0, dtype)
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, m), cols, (m, m),
                           nnz=len(rows), capacity=capacity, device=device)


def generate_block_chain_arrays(m, block=64, deg=4, seed=0,
                                dtype=np.float32):
    """Host (numpy) arrays ``(vals, rowptr, cols)`` of
    :func:`generate_block_chain_lower`."""
    rng = np.random.default_rng(seed)
    rows_i = np.arange(m, dtype=np.int64)
    blk = rows_i // block
    dep_rows = np.repeat(rows_i[blk > 0], deg)
    prev_base = (blk[blk > 0] - 1) * block
    dep_cols = (np.repeat(prev_base, deg)
                + rng.integers(0, block, len(dep_rows)))
    dep_vals = rng.uniform(-0.1, 0.1, len(dep_rows))
    rows = np.concatenate([dep_rows, rows_i])
    cols = np.concatenate([dep_cols, rows_i])
    vals = np.concatenate([dep_vals, rng.uniform(2.0, 3.0, m)])
    # coalesce duplicate deps, keep sorted CSR
    key = rows * np.int64(m) + cols
    order = np.argsort(key, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    head = np.concatenate([[True], key[order][1:] != key[order][:-1]])
    grp = np.cumsum(head) - 1
    out_vals = np.zeros(int(grp[-1]) + 1, np.float64)
    np.add.at(out_vals, grp, vals)
    rows, cols = rows[head], cols[head]
    return (out_vals.astype(dtype), _rows_to_rowptr(rows, m), cols)


def generate_block_chain_lower(m, block=64, deg=4, seed=0,
                               dtype=np.float32, device=None) -> CSR:
    """Lower-triangular with a long dependency chain: every row of block
    k depends on ``deg`` random rows of block k-1, so the level schedule
    has exactly ceil(m/block) levels of ``block`` rows each.  Diagonal
    dominant (U[2, 3) against U[-0.1, 0.1) off the diagonal)."""
    vals, rowptr, cols = generate_block_chain_arrays(m, block, deg, seed,
                                                     dtype)
    return CSR.from_arrays(vals, rowptr, cols, (m, m), nnz=len(vals),
                           device=device)

"""Matrix IO: Matrix Market / SuiteSparse loading — counterpart of
``spblas_tpu/utils/io.py``.

The parse runs in the port's native host runtime (``native.mm_read``,
C++, the JAX package's reader), the (row, col) sort in
``native.coo_to_csr``; duplicates are summed on the sorted stream.  The
CSR lands on ``device`` (the card unless the caller names another), where
``matrix_opt`` and the kernels take it like any other matrix.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tempfile

import numpy as np

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR


def _mm_read_complex(path: str):
    """A complex Matrix Market coordinate file -> (rows, cols, vals,
    shape), vals complex128: the native reader is real-only, so complex
    files are parsed here, as the JAX package parses them.  Symmetric,
    skew and Hermitian storage is expanded."""
    with open(path) as f:
        header = f.readline().lower()
        if "coordinate" not in header:
            raise ValueError("only coordinate Matrix Market supported")
        skew = "skew-symmetric" in header
        hermitian = "hermitian" in header
        symmetric = "symmetric" in header or skew or hermitian
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nz = (int(t) for t in line.split())
        rows, cols, vals = [], [], []
        for _ in range(nz):
            parts = f.readline().split()
            i, j = int(parts[0]) - 1, int(parts[1]) - 1
            v = float(parts[2]) + 1j * float(parts[3])
            rows.append(i)
            cols.append(j)
            vals.append(v)
            if symmetric and i != j:
                rows.append(j)
                cols.append(i)
                vals.append(-v if skew else np.conj(v) if hermitian else v)
    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.asarray(vals, np.complex128), (m, n))


def load_matrix_market(path: str, dtype=np.float32, device=None) -> CSR:
    """Read a Matrix Market coordinate file into a CSR on ``device``.

    Symmetric/skew storage is expanded, duplicates are summed (the
    Matrix Market convention), rows arrive sorted by (row, col).
    ``.mtx.gz`` files are decompressed through a temporary file (the
    checked-in benchmark matrices under data/ ship gzipped).  Complex
    files give a complex64 CSR unless ``dtype`` is complex.
    """
    dev = _t.resolve_device(device)
    if path.endswith(".gz"):
        fd, tmp = tempfile.mkstemp(suffix=".mtx")
        try:
            with gzip.open(path, "rb") as src, os.fdopen(fd, "wb") as dst:
                shutil.copyfileobj(src, dst)
            return load_matrix_market(tmp, dtype=dtype, device=dev)
        finally:
            os.unlink(tmp)
    try:
        rows, cols, vals, (m, n) = native.mm_read(path)
    except ValueError as e:
        if "complex" not in str(e):
            raise
        rows, cols, vals, (m, n) = _mm_read_complex(path)
        if not np.issubdtype(np.dtype(dtype), np.complexfloating):
            dtype = np.complex64
    if np.iscomplexobj(vals):
        # the native sort permutes f64 values: complex values follow the
        # same (row, col) order by a lexsort
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        rowptr = np.zeros(m + 1, np.int64)
        np.add.at(rowptr[1:], rows, 1)
        rowptr = np.cumsum(rowptr)
        acc_dtype = np.complex128
    else:
        rows, cols, vals, rowptr = native.coo_to_csr(m, rows, cols, vals)
        acc_dtype = np.float64
    # coalesce duplicates (summing) on the sorted stream
    if len(rows):
        key_head = np.concatenate(
            [[True], (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])])
        group = np.cumsum(key_head) - 1
        out_vals = np.zeros(group[-1] + 1, dtype=acc_dtype)
        np.add.at(out_vals, group, vals)
        u_rows = rows[key_head]
        u_cols = cols[key_head]
        rowptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(rowptr[1:], u_rows, 1)
        rowptr = np.cumsum(rowptr)
    else:
        out_vals = vals
        u_cols = cols
    return CSR.from_arrays(out_vals.astype(dtype), rowptr, u_cols, (m, n),
                           nnz=len(out_vals), device=dev)


def save_matrix_market(path: str, a) -> None:
    """Write a container to Matrix Market coordinate general format
    (``complex general`` for complex values); the live entries, read to
    the host."""
    from spblas_tpu_torch.formats.convert import to_coo
    coo = to_coo(a)
    nnz = int(coo.nnz)
    rows = _t.to_numpy(coo.rowind)[:nnz]
    cols = _t.to_numpy(coo.colind)[:nnz]
    vals = _t.to_numpy(coo.values)[:nnz]
    m, n = coo.shape
    is_cx = np.iscomplexobj(vals)
    field = "complex" if is_cx else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{m} {n} {nnz}\n")
        if is_cx:
            for i, j, v in zip(rows, cols, vals):
                f.write(f"{i + 1} {j + 1} "
                        f"{v.real:.17g} {v.imag:.17g}\n")
        else:
            for i, j, v in zip(rows, cols, vals):
                f.write(f"{i + 1} {j + 1} {v:.17g}\n")

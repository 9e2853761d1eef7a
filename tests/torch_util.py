"""Shared helpers of the ``test_torch_*`` files: carry the JAX package's
containers and plans across as numpy, and the per-row dot-product
tolerance the port is held to.

Tolerance: |y_port - y_ref|_i <= 64 * eps_f32 * scale * (|A| . |x|)_i —
the dot-product form of ``tests/util.py::assert_close``'s 64*eps model,
since the two packages sum each row in different orders; for a product
with a dense matrix B, per entry: |C - C_ref|_ij <= 64 * eps_f32 * scale
* (|A| . |B|)_ij.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu_torch.utils import interop

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a ``test_torch_*`` module runs (the suite
    runs six workers at once), restored after it, so that a worker that
    only imports the module keeps its own setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_csr(a):
    """The JAX CSR ``a`` as a port CSR on the CPU (same capacity)."""
    return interop.csr_from_numpy(np.asarray(a.values), np.asarray(a.rowptr),
                                  np.asarray(a.colind), int(a.nnz), a.shape,
                                  device="cpu")


def abs_dot(a, x) -> np.ndarray:
    """(|A| . |x|) per row in float64, from the JAX CSR's live entries."""
    m, _ = a.shape
    nnz = int(a.nnz)
    rowptr = np.asarray(a.rowptr).astype(np.int64)
    rows = np.repeat(np.arange(m), np.diff(np.minimum(rowptr, nnz)))
    cols = np.asarray(a.colind)[:nnz]
    w = (np.abs(np.asarray(a.values)[:nnz]).astype(np.float64)
         * np.abs(to_np(x)[cols]).astype(np.float64))
    return np.bincount(rows, weights=w, minlength=m)


def to_np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.detach()
        if y.dtype == torch.bfloat16:
            y = y.float()
        return y.resolve_conj().numpy()
    return np.asarray(y)


def assert_rows_close(y, y_ref, a, x, scale=1.0, factor=64, eps=EPS32,
                      err_msg=""):
    """|y - y_ref|_i <= factor*eps*|scale|*(|A|.|x|)_i for the JAX CSR
    ``a`` and the operand ``x``."""
    y = to_np(y).astype(np.complex128)
    y_ref = to_np(y_ref).astype(np.complex128)
    assert y.shape == y_ref.shape, f"shape {y.shape} vs {y_ref.shape}"
    bound = factor * eps * abs(scale) * abs_dot(a, x)
    err = np.abs(y - y_ref)
    bad = err > bound
    worst = int(np.argmax(err - bound))
    assert not bad.any(), (
        f"{err_msg} {bad.sum()} rows out of bound; worst row {worst}: "
        f"err {err[worst]}, bound {bound[worst]}")


def abs_matmul(a, b) -> np.ndarray:
    """(|A| . |B|) in float64, from the JAX CSR's live entries and a dense
    (n, k) operand."""
    m, _ = a.shape
    nnz = int(a.nnz)
    rowptr = np.asarray(a.rowptr).astype(np.int64)
    rows = np.repeat(np.arange(m), np.diff(np.minimum(rowptr, nnz)))
    cols = np.asarray(a.colind)[:nnz]
    b = np.abs(to_np(b)).astype(np.float64)
    out = np.zeros((m, b.shape[1]))
    np.add.at(out, rows, np.abs(np.asarray(a.values)[:nnz])
              .astype(np.float64)[:, None] * b[cols])
    return out


def assert_entries_close(c, c_ref, a, b, scale=1.0, factor=64, eps=EPS32,
                         err_msg=""):
    """|C - C_ref|_ij <= factor*eps*|scale|*(|A|.|B|)_ij for the JAX CSR
    ``a`` and the dense operand ``b``."""
    c = to_np(c).astype(np.complex128)
    c_ref = to_np(c_ref).astype(np.complex128)
    assert c.shape == c_ref.shape, f"shape {c.shape} vs {c_ref.shape}"
    bound = factor * eps * abs(scale) * abs_matmul(a, b)
    err = np.abs(c - c_ref)
    bad = err > bound
    worst = np.unravel_index(int(np.argmax(err - bound)), err.shape)
    assert not bad.any(), (
        f"{err_msg} {bad.sum()} entries out of bound; worst {worst}: "
        f"err {err[worst]}, bound {bound[worst]}")


def permuted_csr(a, seed):
    """The JAX CSR ``a`` under a seeded symmetric random permutation (a
    band so scrambled reaches the RCM rung)."""
    m = a.shape[0]
    nnz = int(a.nnz)
    inv = np.empty(m, np.int64)
    inv[np.random.default_rng(seed).permutation(m)] = np.arange(m)
    rowptr = np.minimum(np.asarray(a.rowptr).astype(np.int64), nnz)
    rows = inv[np.repeat(np.arange(m), np.diff(rowptr))]
    cols = inv[np.asarray(a.colind)[:nnz]]
    order = np.lexsort((cols, rows))
    rp = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))])
    return sp.CSR.from_arrays(np.asarray(a.values)[:nnz][order], rp,
                              cols[order], (m, m), nnz=nnz)


def block_dense_csr(m, n, nblocks, seed):
    """Dense 8x128 blocks of standard normal values at seeded places, as
    a JAX CSR (a matrix the BSR rung takes)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for _ in range(nblocks):
        i, j = rng.integers(m // 8), rng.integers(n // 128)
        dense[i * 8:(i + 1) * 8, j * 128:(j + 1) * 128] = \
            rng.standard_normal((8, 128))
    return sp.CSR.from_dense(dense)


def csr_dense(c) -> np.ndarray:
    """Dense (m, n) of a JAX or port CSR's live entries, duplicates
    summed, in complex128."""
    m, n = c.shape
    nnz = int(c.nnz)
    rowptr = np.minimum(to_np(c.rowptr).astype(np.int64), nnz)
    rows = np.repeat(np.arange(m), np.diff(rowptr))
    out = np.zeros((m, n), np.complex128)
    np.add.at(out, (rows, to_np(c.colind)[:nnz].astype(np.int64)),
              to_np(c.values)[:nnz])
    return out


def abs_spgemm(a, b, d=None, alpha=1.0, beta=1.0) -> np.ndarray:
    """|alpha| (|A| . |B|) + |beta| |D| in float64, dense, from JAX (or
    port) CSRs."""
    out = abs(alpha) * (np.abs(csr_dense(a)) @ np.abs(csr_dense(b)))
    if d is not None:
        out = out + abs(beta) * np.abs(csr_dense(d))
    return out


def assert_spgemm_close(c, c_ref, bound, factor=64, eps=EPS32,
                        err_msg=""):
    """|C - C_ref|_ij <= factor*eps*bound_ij per entry, with ``bound``
    from :func:`abs_spgemm`: the SpGEMM form of the dot-product model,
    since the two sides sum each entry's products in different
    orders."""
    got, want = csr_dense(c), csr_dense(c_ref)
    err = np.abs(got - want)
    lim = factor * eps * bound
    bad = err > lim
    worst = np.unravel_index(int(np.argmax(err - lim)), err.shape)
    assert not bad.any(), (
        f"{err_msg} {bad.sum()} entries out of bound; worst {worst}: "
        f"err {err[worst]}, bound {lim[worst]}")

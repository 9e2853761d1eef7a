"""spblas_tpu_torch BSR container and block kernels against the JAX
package: the same seeded numpy blocks through ``spblas_tpu``'s BSR and
its Pallas kernels (interpret mode, as ``tests/test_bsr.py`` runs them)
and through the port's BSR and the plain versions of its CUDA kernels.

Tolerance: per entry 64 * eps_f32 * (|A| . |B|) (``tests/torch_util.py``),
since the two sides sum in different orders."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu.formats.bsr import BSR as JBSR
from spblas_tpu.formats.convert import bsr_to_csr as jax_bsr_to_csr
from spblas_tpu.kernels.bsr_pallas import bsr_spmm as jax_bsr_spmm
from spblas_tpu.kernels.bsr_pallas import bsr_spmv as jax_bsr_spmv
from spblas_tpu.kernels.bsr_spgemm import (bsr_spgemm_compute as
                                           jax_bsr_spgemm_compute,
                                           bsr_spgemm_numeric as
                                           jax_bsr_spgemm_numeric)

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import bsr_spgemm as tbs
from spblas_tpu_torch.formats.convert import to_csr as port_to_csr
from spblas_tpu_torch.kernels import bsr_kernels as bk
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    EPS32, assert_entries_close, assert_rows_close, one_torch_thread, to_np)

# (m, n, block shape, stored blocks): the chooser's 8x128 blocks, and
# the 8x8 and 128x128 blocks the base path receives
SHAPES = {"8x128": (64, 512, (8, 128), 20),
          "8x8": (64, 48, (8, 8), 12),
          "128x128": (256, 384, (128, 128), 3)}


def _block_dense(m, n, bh, bw, nblocks, seed, empty_rows=()):
    """Seeded blocks of standard normal values; the block rows in
    ``empty_rows`` stay empty."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for _ in range(nblocks):
        i, j = rng.integers(m // bh), rng.integers(n // bw)
        if i in empty_rows:
            continue
        dense[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw] = \
            rng.standard_normal((bh, bw))
    return dense


def _pair(dense, block_shape, capacity=None):
    """The JAX BSR and the port's BSR (on the CPU) of one dense matrix."""
    a = JBSR.from_dense(dense, block_shape, capacity=capacity)
    b = tsp.BSR.from_dense(dense, block_shape, capacity=capacity,
                           device="cpu")
    return a, b


def _arrays_equal(b, a):
    for t, j in ((b.values, a.values), (b.block_rowptr, a.block_rowptr),
                 (b.block_colind, a.block_colind)):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
    assert b.nnz_blocks == int(a.nnz_blocks) and b.shape == a.shape
    assert b.block_shape == a.block_shape and b.capacity == a.capacity


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bsr_from_dense_matches_jax(name):
    m, n, bs, nb = SHAPES[name]
    dense = _block_dense(m, n, *bs, nb, seed=0)
    a, b = _pair(dense, bs)
    _arrays_equal(b, a)
    assert b.block_rowptr.dtype == torch.int32
    assert b.block_colind.dtype == torch.int32
    np.testing.assert_array_equal(to_np(b.todense()), dense)
    np.testing.assert_array_equal(to_np(b.block_row_ids()),
                                  np.asarray(a.block_row_ids()))


def test_bsr_from_csr_and_back_matches_jax():
    dense = _block_dense(64, 512, 8, 128, 20, seed=1)
    jcsr = sp.CSR.from_dense(dense)
    a = JBSR.from_csr(jcsr, (8, 128), capacity=64)
    b = tsp.BSR.from_csr(tsp.CSR.from_dense(dense, device="cpu"), (8, 128),
                         capacity=64)
    _arrays_equal(b, a)
    ja, tb = jax_bsr_to_csr(a), port_to_csr(b)
    tb.validate()
    for t, j in ((tb.values, ja.values), (tb.rowptr, ja.rowptr),
                 (tb.colind, ja.colind)):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
    assert tb.nnz == int(ja.nnz)


def test_interop_bsr_keeps_bits():
    dense = _block_dense(64, 48, 8, 8, 12, seed=2)
    a = JBSR.from_dense(dense, (8, 8), capacity=32)
    b = interop.bsr_from_numpy(np.asarray(a.values),
                               np.asarray(a.block_rowptr),
                               np.asarray(a.block_colind), a.nnz_blocks,
                               a.shape, a.block_shape, device="cpu")
    _arrays_equal(b, a)


def _check_spmv(a, b, dense, x):
    y = bk.bsr_spmv(b, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert_rows_close(y, jax_bsr_spmv(a, jnp.asarray(x), interpret=True),
                      sp.CSR.from_dense(dense), x)


def _check_spmm(a, b, dense, bmat):
    c = bk.bsr_spmm(b, torch.from_numpy(bmat))
    assert c.dtype == torch.float32 and c.shape == (dense.shape[0],
                                                    bmat.shape[1])
    assert_entries_close(c, jax_bsr_spmm(a, jnp.asarray(bmat),
                                         interpret=True),
                         sp.CSR.from_dense(dense), bmat)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bsr_spmv_matches_jax(name):
    m, n, bs, nb = SHAPES[name]
    dense = _block_dense(m, n, *bs, nb, seed=3)
    a, b = _pair(dense, bs)
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    _check_spmv(a, b, dense, x)


@pytest.mark.parametrize("name,k", [("8x128", 128), ("8x128", 33),
                                    ("8x8", 33), ("128x128", 64)])
def test_bsr_spmm_matches_jax(name, k):
    m, n, bs, nb = SHAPES[name]
    dense = _block_dense(m, n, *bs, nb, seed=5)
    a, b = _pair(dense, bs)
    bmat = np.random.default_rng(6).standard_normal((n, k)).astype(
        np.float32)
    _check_spmm(a, b, dense, bmat)


def test_bsr_empty_block_rows_write_zeros():
    """Block rows with no stored block come out as exact zeros (the
    kernels' outputs come from torch.empty)."""
    dense = _block_dense(64, 512, 8, 128, 30, seed=7, empty_rows=(0, 3, 7))
    a, b = _pair(dense, (8, 128))
    assert int((b.block_rowptr[1:] == b.block_rowptr[:-1]).sum()) >= 3
    rng = np.random.default_rng(8)
    x = rng.standard_normal(512).astype(np.float32)
    bmat = rng.standard_normal((512, 40)).astype(np.float32)
    _check_spmv(a, b, dense, x)
    _check_spmm(a, b, dense, bmat)
    for i in (0, 3, 7):
        rows = slice(i * 8, (i + 1) * 8)
        assert not bk.bsr_spmv(b, torch.from_numpy(x))[rows].any()
        assert not bk.bsr_spmm(b, torch.from_numpy(bmat))[rows].any()


def test_bsr_capacity_padding_is_not_read():
    """Blocks past nnz_blocks are bounded out by block_rowptr: the port
    agrees with JAX on a capacity-padded BSR, and garbage written into
    the padding changes nothing."""
    dense = _block_dense(64, 512, 8, 128, 10, seed=9)
    a, b = _pair(dense, (8, 128), capacity=64)
    assert b.capacity == 64 > b.nnz_blocks
    rng = np.random.default_rng(10)
    x = rng.standard_normal(512).astype(np.float32)
    bmat = rng.standard_normal((512, 16)).astype(np.float32)
    _check_spmv(a, b, dense, x)
    _check_spmm(a, b, dense, bmat)
    junk = b.values.clone()
    junk[b.nnz_blocks:] = 1e30
    cols = b.block_colind.clone()
    cols[b.nnz_blocks:] = 3
    g = dataclasses.replace(b, values=junk, block_colind=cols)
    np.testing.assert_array_equal(to_np(bk.bsr_spmv(g, torch.from_numpy(x))),
                                  to_np(bk.bsr_spmv(b, torch.from_numpy(x))))
    np.testing.assert_array_equal(
        to_np(bk.bsr_spmm(g, torch.from_numpy(bmat))),
        to_np(bk.bsr_spmm(b, torch.from_numpy(bmat))))


def test_bsr_f64_and_complex_take_their_dtype():
    """The base path computes in result_type(A, x): float64 blocks stay
    float64; a complex operand runs as real planes."""
    dense = _block_dense(64, 48, 8, 8, 12, seed=11).astype(np.float64)
    b = tsp.BSR.from_dense(dense, (8, 8), device="cpu")
    rng = np.random.default_rng(12)
    x = rng.standard_normal(48)
    y = tsp.multiply(b, torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(to_np(y), dense @ x, rtol=1e-12, atol=1e-12)
    xc = (rng.standard_normal(48) + 1j * rng.standard_normal(48)).astype(
        np.complex64)
    bc = tsp.BSR.from_dense(dense.astype(np.float32) * (1 - 2j), (8, 8),
                            device="cpu")
    yc = tsp.multiply(tsp.conjugated(bc), torch.from_numpy(xc))
    assert yc.dtype == torch.complex64
    want = (dense * (1 + 2j)) @ xc.astype(np.complex128)
    np.testing.assert_allclose(to_np(yc), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_bsr_base_path_through_multiply_matches_jax(op):
    """multiply on a scaled BSR (no matrix_opt) takes the block kernels
    in both packages."""
    dense = _block_dense(64, 512, 8, 128, 20, seed=13)
    a, b = _pair(dense, (8, 128))
    rng = np.random.default_rng(14)
    rhs = (rng.standard_normal(512) if op == "spmv"
           else rng.standard_normal((512, 24))).astype(np.float32)
    got = tsp.multiply(tsp.scaled(2.0, b), torch.from_numpy(rhs))
    want = sp.multiply(sp.scaled(2.0, a), jnp.asarray(rhs))
    ref = sp.CSR.from_dense(dense)
    if op == "spmv":
        assert_rows_close(got, want, ref, rhs, scale=2.0)
    else:
        assert_entries_close(got, want, ref, rhs, scale=2.0)


def test_bsr_kernel_wrappers_check_operands():
    dense = _block_dense(64, 48, 8, 8, 12, seed=15)
    b = tsp.BSR.from_dense(dense, (8, 8), device="cpu")
    x = torch.zeros(48)
    with pytest.raises(TypeError, match="float32/float64"):
        bk.bsr_spmv_blocks(b.values, b.block_rowptr, b.block_colind,
                           x.double())
    with pytest.raises(TypeError, match="int32"):
        bk.bsr_spmv_blocks(b.values, b.block_rowptr.long(), b.block_colind,
                           x)
    with pytest.raises(ValueError, match="bad shapes"):
        bk.bsr_spmm_blocks(b.values, b.block_rowptr, b.block_colind, x)
    with pytest.raises(ValueError, match="bsr_spmv"):
        bk.bsr_spmv(b, torch.zeros(47))


# ------------------------------------------------------------------ #
# block SpGEMM
# ------------------------------------------------------------------ #

# tests/test_bsr.py's block SpGEMM shapes: (A: m, k, block, stored
# blocks, seed; B: n, block, stored blocks, seed)
SPGEMM_SHAPES = {"8x128_128x128": ((64, 512, (8, 128), 16, 1),
                                   (384, (128, 128), 10, 2)),
                 "reuse_8x128": ((32, 256, (8, 128), 8, 3),
                                 (256, (128, 128), 4, 4))}


def _spgemm_pair(name, empty_rows=()):
    (m, k, ablk, na, sa), (n, bblk, nb, sb) = SPGEMM_SHAPES[name]
    da = _block_dense(m, k, *ablk, na, seed=sa, empty_rows=empty_rows)
    db = _block_dense(k, n, *bblk, nb, seed=sb)
    ja, ta = _pair(da, ablk)
    jb, tb = _pair(db, bblk)
    return da, db, ja, jb, ta, tb


def _assert_blocks_close(c, c_ref, da, db, scale=1.0):
    """Per entry 64 * eps_f32 * |scale| * (|A| . |B|) on the dense
    products."""
    bound = 64 * EPS32 * abs(scale) * (np.abs(da).astype(np.float64)
                                       @ np.abs(db))
    err = np.abs(to_np(c).astype(np.float64) - np.asarray(c_ref,
                                                          np.float64))
    assert (err <= bound).all(), f"{(err > bound).sum()} entries out"


@pytest.mark.parametrize("name", list(SPGEMM_SHAPES))
def test_bsr_spgemm_matches_jax(name):
    """The block-symbolic plan bit-equal to JAX's, and the numeric
    (plain version of the kernel) against JAX's Pallas kernel in
    interpret mode."""
    da, db, ja, jb, ta, tb = _spgemm_pair(name, empty_rows=(2,))
    jp = jax_bsr_spgemm_compute(ja, jb)
    tp = tbs.bsr_spgemm_compute(ta, tb)
    for f in ("pair_ptr", "pair_a", "pair_b", "c_rowptr", "c_colind"):
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), f)
    assert tp.shape == jp.shape and tp.block_shape == jp.block_shape
    jc = jax_bsr_spgemm_numeric(jp, ja, jb, interpret=True)
    tc = tbs.bsr_spgemm_numeric(tp, ta, tb)
    assert tc.nnz_blocks == int(jc.nnz_blocks)
    assert tc.capacity == jc.capacity
    np.testing.assert_array_equal(to_np(tc.block_colind),
                                  np.asarray(jc.block_colind))
    _assert_blocks_close(tc.todense(), np.asarray(jc.todense()), da, db)
    # numeric reuse with new values over the same plan
    ta3 = dataclasses.replace(ta, values=ta.values * 3.0)
    _assert_blocks_close(tbs.bsr_spgemm_numeric(tp, ta3, tb).todense(),
                         3.0 * np.asarray(jc.todense()), da, db, 3.0)
    carried = interop.bsr_spgemm_plan_from_numpy(
        *(np.asarray(getattr(jp, f)) for f in
          ("pair_ptr", "pair_a", "pair_b", "c_rowptr", "c_colind")),
        jp.shape, jp.block_shape, device="cpu")
    np.testing.assert_array_equal(
        to_np(tbs.bsr_spgemm_numeric(carried, ta, tb).values),
        to_np(tc.values))


def test_bsr_spgemm_through_multiply_and_errors():
    """multiply on two BSR operands returns a BSR (alpha folded in);
    block and shape mismatches raise as in JAX; an empty product keeps
    the JAX layout."""
    da = _block_dense(64, 256, 8, 128, 10, seed=7)
    db = _block_dense(256, 256, 128, 128, 3, seed=8)
    ja, ta = _pair(da, (8, 128))
    jb, tb = _pair(db, (128, 128))
    c = tsp.multiply(tsp.scaled(2.0, ta), tb)
    assert isinstance(c, tsp.BSR) and c.block_shape == (8, 128)
    jc = sp.multiply(sp.scaled(2.0, ja), jb)
    _assert_blocks_close(c.todense(), np.asarray(jc.todense()), da, db, 2.0)
    _, bad = _pair(_block_dense(256, 256, 8, 128, 4, seed=6), (8, 128))
    with pytest.raises(ValueError, match="block mismatch"):
        tbs.bsr_spgemm_compute(ta, bad)
    with pytest.raises(ValueError, match="bsr_spgemm"):
        tbs.bsr_spgemm_compute(ta, ta)
    # A's stored blocks meet no stored block of B: C is empty
    _, tz = _pair(_block_dense(256, 256, 128, 128, 0, seed=9), (128, 128))
    ce = tbs.bsr_spgemm(ta, tz)
    assert ce.nnz_blocks == 0 and ce.values.shape == (1, 8, 128)
    assert not bool(ce.todense().any())


def test_bsr_spgemm_f64_and_complex_take_their_dtype():
    da = _block_dense(32, 256, 8, 128, 8, seed=3)
    db = _block_dense(256, 256, 128, 128, 4, seed=4)
    a64 = tsp.BSR.from_dense(da.astype(np.float64), (8, 128), device="cpu")
    b64 = tsp.BSR.from_dense(db.astype(np.float64), (128, 128),
                             device="cpu")
    c = tbs.bsr_spgemm(a64, b64)
    assert c.dtype == torch.float64
    np.testing.assert_allclose(to_np(c.todense()),
                               da.astype(np.float64) @ db, rtol=1e-12,
                               atol=1e-12)
    acx = dataclasses.replace(a64, values=(a64.values * (1 + 2j)).to(
        torch.complex128))
    ccx = tbs.bsr_spgemm(acx, b64)
    assert ccx.dtype == torch.complex128
    np.testing.assert_allclose(to_np(ccx.todense()),
                               (1 + 2j) * (da.astype(np.float64) @ db),
                               rtol=1e-12, atol=1e-12)


def test_bsr_spgemm_wrapper_checks_operands():
    _, _, _, _, ta, tb = _spgemm_pair("reuse_8x128")
    p = tbs.bsr_spgemm_compute(ta, tb)
    with pytest.raises(TypeError, match="int32"):
        tbs.bsr_spgemm_blocks(p.pair_ptr.long(), p.pair_a, p.pair_b,
                              ta.values, tb.values)
    with pytest.raises(TypeError, match="float32/float64"):
        tbs.bsr_spgemm_blocks(p.pair_ptr, p.pair_a, p.pair_b, ta.values,
                              tb.values.double())
    with pytest.raises(ValueError, match="bad shapes"):
        tbs.bsr_spgemm_blocks(p.pair_ptr, p.pair_a, p.pair_b, ta.values,
                              tb.values[:, :8])

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
from spblas_tpu_torch.kernels import banded, plans
from spblas_tpu_torch.kernels import bsr_kernels as bk
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    EPS32, assert_entries_close, assert_rows_close, one_torch_thread, to_np)

# (m, n, block shape, stored blocks): the chooser's 8x128 blocks, and
# the 8x8, 128x128 and 3x3 (3-D elasticity) blocks the base path receives
SHAPES = {"8x128": (64, 512, (8, 128), 20),
          "8x8": (64, 48, (8, 8), 12),
          "128x128": (256, 384, (128, 128), 3),
          "3x3": (48, 45, (3, 3), 40)}


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


def test_bsr_spmv_3x3_f64_matches_plain():
    """3x3 blocks (the small mapping on the card) in float64: within
    64 * eps_f64 * (|A| . |x|) per row of the dense product, and equal to
    the plain version, which the CPU wrapper runs."""
    m, n, bs, nb = SHAPES["3x3"]
    dense = _block_dense(m, n, *bs, nb, seed=16).astype(np.float64)
    b = tsp.BSR.from_dense(dense, bs, device="cpu")
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(n))
    y = bk.bsr_spmv(b, x)
    assert y.dtype == torch.float64 and y.shape == (m,)
    err = np.abs(to_np(y) - dense @ to_np(x))
    eps64 = np.finfo(np.float64).eps
    assert (err <= 64 * eps64 * (np.abs(dense) @ np.abs(to_np(x)))).all()
    assert torch.equal(y, bk.bsr_spmv_reference(b.values, b.block_rowptr,
                                                b.block_colind, x))


def test_bsr_plan_reads_x_in_place(monkeypatch):
    """The chooser's BSR pads its columns to whole blocks; ``plan_spmv``
    hands x to the kernel as it is, with no ``F.pad``, and the kernel
    reads zeros past its end: the same values as x padded."""
    rng = np.random.default_rng(18)
    dense = _block_dense(64, 500, 8, 128, 12, seed=19)
    dense[8:16, 384:500] = rng.standard_normal((8, 116))
    bsr, (m, n) = plans._try_bsr(tsp.CSR.from_dense(dense, device="cpu"))
    assert (m, n) == (64, 500) and bsr.shape == (64, 512)
    x = torch.from_numpy(rng.standard_normal(500).astype(np.float32))
    padded = torch.nn.functional.pad(x, (0, 12))
    want = bk.bsr_spmv(bsr, padded)
    args = (bsr.values, bsr.block_rowptr, bsr.block_colind)

    def no_pad(*a, **k):
        raise AssertionError("x was padded")

    monkeypatch.setattr(plans.F, "pad", no_pad)
    assert torch.equal(plans.plan_spmv(("bsr", (bsr, (m, n))), x), want)
    assert torch.equal(bk.bsr_spmv_blocks(*args, x),
                       bk.bsr_spmv_blocks(*args, padded))
    with pytest.raises(ValueError, match="bsr_spmv"):
        bk.bsr_spmv(bsr, x)


@pytest.mark.parametrize("block,itemsize,aligned,want", [
    ((8, 128), 4, True, (bk.SPMV_COLS, 4)),
    ((128, 128), 4, True, (bk.SPMV_COLS, 4)),
    ((12, 125), 4, True, (bk.SPMV_COLS, 1)),
    ((8, 8), 4, True, (bk.SPMV_SPAN, 4)),
    ((8, 8), 8, True, (bk.SPMV_SPAN, 2)),
    ((4, 2), 4, True, (bk.SPMV_SPAN, 2)),
    ((8, 8), 4, False, (bk.SPMV_COLS, 1)),
    ((3, 3), 4, True, (bk.SPMV_SMALL, 1)),
    ((3, 3), 8, True, (bk.SPMV_SMALL, 1)),
    ((5, 6), 4, False, (bk.SPMV_SMALL, 1))])
def test_spmv_mapping_by_block_shape(block, itemsize, aligned, want):
    """The host's pick of the SpMV kernel's mapping: 16-byte loads where
    bw and the pointers allow, a warp a block row for power-of-two blocks
    of at most 32 loads and for other blocks of at most 32 elements (an
    element a lane), a warp an output row else."""
    assert bk.spmv_mapping(*block, itemsize, aligned) == want


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


@pytest.mark.parametrize("name,k,capacity,empty_rows", [
    ("8x128", 40, 64, (0, 3, 7)), ("8x8", 33, None, (1,)),
    ("128x128", 16, 8, (0,))])
def test_bsr_column_walk_matches_reference_and_jax(name, k, capacity,
                                                   empty_rows):
    """The f32 kernel's schedule (each block's product into its slot, by
    block column, then each block row's slots summed in order) equals
    the plain SpMM and JAX's, with empty block rows and capacity padding
    that holds garbage; the column list names each stored block once, in
    block-row order within a column."""
    m, n, bs, nb = SHAPES[name]
    dense = _block_dense(m, n, *bs, 3 * nb, seed=12, empty_rows=empty_rows)
    a, b = _pair(dense, bs, capacity=capacity)
    assert b.capacity > b.nnz_blocks
    junk = b.values.clone()
    junk[b.nnz_blocks:] = 1e30
    b = dataclasses.replace(b, values=junk)
    col_ptr, col_order = b.column_order
    assert b.column_order is b.column_order          # made once
    order = col_order[: b.nnz_blocks].long()
    assert sorted(order.tolist()) == list(range(b.nnz_blocks))
    cols = b.block_colind[order]
    assert bool((cols[1:] >= cols[:-1]).all())
    for j in range(n // bs[1]):
        blocks = col_order[col_ptr[j]:col_ptr[j + 1]]
        assert bool((b.block_colind[blocks.long()] == j).all())
        assert bool((blocks[1:] > blocks[:-1]).all())
    bmat = np.random.default_rng(13).standard_normal((n, k)).astype(
        np.float32)
    bt = torch.from_numpy(bmat)
    walk = bk.bsr_spmm_columns_reference(b.values, b.block_rowptr,
                                         b.block_colind, bt, b.column_order)
    ref = bk.bsr_spmm_reference(b.values, b.block_rowptr, b.block_colind, bt)
    csr = sp.CSR.from_dense(dense)
    assert_entries_close(walk, ref, csr, bmat)
    assert_entries_close(walk, jax_bsr_spmm(a, jnp.asarray(bmat),
                                            interpret=True), csr, bmat)
    for i in empty_rows:
        assert not walk[i * bs[0]:(i + 1) * bs[0]].any()


@pytest.mark.parametrize("cuts", ["columns", "rows"])
def test_bsr_spmm_scratch_budget_cuts_give_the_same_values(cuts):
    """Past the slot-scratch budget the f32 call walks k in column phases
    of whole 64-column k-tiles, and, where one such phase alone passes
    it, ranges of block rows too; every slot and every row sum stays the
    one the whole call computes, so a cut call gives the same values as
    the unsplit one (and each cut's scratch is within the budget)."""
    m, n, bs, nb = SHAPES["8x128"]
    dense = _block_dense(m, n, *bs, 3 * nb, seed=31, empty_rows=(2, 5))
    _, b = _pair(dense, bs, capacity=64)
    k = 200
    bt = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (n, k)).astype(np.float32))
    cap, bh, _ = b.values.shape
    # room for every slot at 64 columns; or for the fullest block row's
    # slots at 64 columns, and not for all of them: block-row ranges
    per_block = bh * 4 * 64
    budget = (cap * per_block if cuts == "columns"
              else int(torch.diff(b.block_rowptr).max()) * per_block + 1)
    col_ptr, col_order = b.column_order
    got = bk.spmm_phases(b.block_rowptr, b.block_colind, col_ptr, col_order,
                         cap, bh, k, n // bs[1], budget)
    assert len(got) > 1
    for r0, r1, e0, rp, cp, co, p0, p1 in got:
        assert int(rp[0]) == 0 and int(rp[-1]) <= int(co.shape[0])
        assert p0 % 64 == 0 and (p1 == k or (p1 - p0) % 64 == 0)
        slots = int(co.shape[0]) if cuts == "rows" else cap
        assert slots * bh * (p1 - p0) * 4 <= budget
    if cuts == "rows":
        assert len({(r0, r1) for r0, r1, *_ in got}) > 1
    else:
        assert {(r0, r1) for r0, r1, *_ in got} == {(0, m // bs[0])}
    whole = bk.bsr_spmm_columns_reference(b.values, b.block_rowptr,
                                          b.block_colind, bt, b.column_order)
    cut = bk.bsr_spmm_cuts_reference(b.values, b.block_rowptr,
                                     b.block_colind, bt, b.column_order,
                                     budget)
    assert torch.equal(cut, whole)
    with pytest.raises(ValueError):
        bk.spmm_phases(b.block_rowptr, b.block_colind, col_ptr, col_order,
                       cap, bh, k, n // bs[1], bh * 4)


def test_low_end_operands_take_the_exact_kernels(monkeypatch):
    """The 3xTF32 gate (``tf32_exact``): blocks or panels with nonzero f32
    values below 2^-112 send the f32 BSR SpMM to the FMA kernel
    (``tc=False``), the block SpGEMM to the f64 kernel and the streamed
    band SpMM to the resident FMA kernel; other operands keep the tensor
    cores.  The routed results equal the plain sums."""
    m, n, bs, nb = SHAPES["8x128"]
    dense = _block_dense(m, n, *bs, 3 * nb, seed=41)
    _, b = _pair(dense, bs)
    tiny = dataclasses.replace(b, values=b.values * 2.0 ** -120)
    assert b.tf32_exact and not tiny.tf32_exact
    bmat = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (n, 24)).astype(np.float32)) * 2.0 ** 120
    seen = []

    def spy(*args, tc=True, **kw):
        seen.append(tc)
        return bk.bsr_spmm_reference(*args[:4])

    monkeypatch.setattr(bk, "bsr_spmm_blocks", spy)
    monkeypatch.setattr(bk._t, "on_cuda", lambda t: True)
    for op in (b, tiny):
        got = bk.bsr_spmm(op, bmat)
        assert torch.equal(got, bk.bsr_spmm_reference(
            op.values, op.block_rowptr, op.block_colind, bmat))
    assert seen == [True, False]
    monkeypatch.undo()

    dtypes = []
    real = tbs.bsr_spgemm_blocks

    def spgemm_spy(*args):
        dtypes.append(args[3].dtype)
        return real(*args)

    monkeypatch.setattr(tbs, "bsr_spgemm_blocks", spgemm_spy)
    bt = tsp.BSR.from_dense(dense.T.copy(), bs[::-1], device="cpu")
    for op in (b, tiny):
        tbs.bsr_spgemm(op, bt)
    assert dtypes == [torch.float32, torch.float64]

    calls = []
    band = banded.build_band_plan(tsp.CSR.from_dense(
        np.triu(np.tril(dense[:, :m], 3), -3), device="cpu"))
    monkeypatch.setattr(banded, "band_spmm_inplace",
                        lambda *a: calls.append("fma") or
                        banded.band_spmm_inplace_reference(*a))
    monkeypatch.setattr(banded, "band_spmm_stream_inplace",
                        lambda *a, amax: calls.append("tc") or
                        banded.band_spmm_inplace_reference(*a))
    for plan in (band, dataclasses.replace(
            band, panels=band.panels * 2.0 ** -120)):
        banded.band_spmm_stream(plan, bmat[:m])
    assert calls == ["tc", "fma"]


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

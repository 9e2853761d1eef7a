"""spblas_tpu_torch DCSR and ELL held to the JAX package on the same
seeded numpy inputs: the DCSR container, its generator and its round
trip bit-equal; the DCSR SpMV and SpMM base paths, the chooser through
``matrix_opt``, dense.DCSR and SpGEMM with a DCSR operand per row or
entry within 64*eps*(|A|.|x|) (the two packages sum in different
orders); the ELL geometry and plans bit-equal, their products within the
same limit."""

import jax
import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu import native as jax_native
from spblas_tpu.formats.dcsr import DCSR as JaxDCSR
from spblas_tpu.kernels import ell as jell
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch import native
from spblas_tpu_torch import views as tviews
from spblas_tpu_torch.formats.dcsr import DCSR
from spblas_tpu_torch.kernels import ell as tell
from spblas_tpu_torch.kernels import plans
from spblas_tpu_torch.ops.multiply import _kind
from spblas_tpu_torch.utils import generate as tgen
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    assert_entries_close, assert_rows_close, assert_same_container,
    assert_spgemm_close, abs_spgemm, one_torch_thread, port_csr, port_of,
    to_np)

# one shape for the DCSR cases, so the JAX side compiles it once
M, N, NNZ = 1000, 200, 400
_jax_multiply = jax.jit(sp.multiply)


def _dcsr(seed):
    return gen.generate_dcsr(M, N, NNZ, seed=seed)


def test_dcsr_roundtrip():
    """generate_dcsr draws the JAX arrays; row ids, to_csr, todense and
    from_csr (both row capacities) keep the JAX bits."""
    d = _dcsr(0)
    td = tgen.generate_dcsr(M, N, NNZ, seed=0, device="cpu")
    assert_same_container(td, d)
    assert td.nrows == int(d.nrows) < M // 8   # hypersparse
    assert td.row_capacity == d.row_capacity
    np.testing.assert_array_equal(to_np(td.row_ids()),
                                  np.asarray(d.row_ids()))
    back = d.to_csr()
    tback = td.to_csr()
    assert_same_container(tback, back)
    tback.validate()
    np.testing.assert_array_equal(to_np(td.todense()),
                                  np.asarray(d.todense()))
    for rcap in (None, 512):
        assert_same_container(DCSR.from_csr(tback, row_capacity=rcap),
                              JaxDCSR.from_csr(back, row_capacity=rcap))
    # values and colind alias the CSR's
    d2 = DCSR.from_csr(tback)
    assert d2.values is tback.values and d2.colind is tback.colind
    with pytest.raises(TypeError, match="takes a CSR"):
        DCSR.from_csr(td)


def test_dcsr_is_sparse():
    """A DCSR is a sparse operand for every view test and for multiply's
    dispatch (not a dense matrix)."""
    td = port_of(_dcsr(1))
    assert tviews.is_sparse(td) and tviews.is_sparse(tsp.scaled(2.0, td))
    assert not tviews.is_dense_matrix(td)
    assert _kind(td, torch.zeros(N)) == "spmv"
    assert _kind(td, td) == "spgemm"
    assert _kind(torch.zeros(3, M), td) == "dense_sparse"


def test_dcsr_spmv_spmm_base_paths():
    d = _dcsr(2)
    td = port_of(d)
    ref_csr = d.to_csr()
    x = gen.generate_vector(N, seed=3)
    b = gen.generate_dense(N, 5, seed=4)
    y = tsp.multiply(td, torch.from_numpy(x))
    assert_rows_close(y, _jax_multiply(d, x), ref_csr, x)
    c = tsp.multiply(tsp.scaled(2.0, td), torch.from_numpy(b))
    assert_entries_close(c, _jax_multiply(sp.scaled(2.0, d), b),
                         ref_csr, b, scale=2.0)


def test_dcsr_through_matrix_opt():
    """matrix_opt(DCSR): the chooser reads it through to_csr (SELL on
    the CPU) for SpMV and SpMM, and a dense.DCSR product goes through
    to_csr before the lazy flip."""
    d = _dcsr(5)
    td = port_of(d)
    ref_csr = d.to_csr()
    x = gen.generate_vector(N, seed=6)
    opt = tsp.matrix_opt(td)
    y = tsp.multiply(tsp.scaled(2.0, opt), torch.from_numpy(x))
    assert opt._plans["matvec"][0] == "sell"
    assert_rows_close(y, _jax_multiply(sp.scaled(2.0, d), x),
                      ref_csr, x, scale=2.0)
    b = gen.generate_dense(N, 4, seed=7)
    c = tsp.multiply(tsp.scaled(2.0, opt), torch.from_numpy(b))
    assert_entries_close(c, _jax_multiply(sp.scaled(2.0, d), b),
                         ref_csr, b, scale=2.0)
    left = gen.generate_dense(3, M, seed=8)
    c = tsp.multiply(torch.from_numpy(left), tsp.scaled(2.0, td))
    want = np.asarray(sp.multiply(left, sp.scaled(2.0, d)))
    np.testing.assert_allclose(to_np(c), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_dcsr_spgemm():
    """SpGEMM with a DCSR on either side reaches the structure engine
    through to_csr: the JAX structure exactly, entries within the
    SpGEMM form of the limit."""
    d = gen.generate_dcsr(M, M, NNZ, seed=9)
    a = gen.generate_csr(M, M, 2_000, seed=10)
    for left, right in ((d, a), (a, d)):
        c = tsp.multiply(port_of(left), port_of(right))
        ref = sp.multiply(left, right)
        assert c.nnz == int(ref.nnz)
        np.testing.assert_array_equal(to_np(c.rowptr),
                                      np.asarray(ref.rowptr))
        assert_spgemm_close(c, ref, abs_spgemm(left.to_csr()
                                               if left is d else left,
                                               right.to_csr()
                                               if right is d else right))


def _ell_csr():
    """Rows of unequal length, m not a multiple of the row padding, and
    capacity padding past nnz."""
    return gen.generate_csr(203, 150, 900, seed=11, capacity=2048)


@pytest.mark.parametrize("width", [0, 40])
def test_ell_geometry_matches_jax(width):
    a = _ell_csr()
    args = (203, 208, int(a.nnz), np.asarray(a.rowptr),
            np.asarray(a.colind), width)
    got = native.ell_geometry(*args)
    want = jax_native.ell_geometry(*args)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_ell_plan_spmv_spmm_and_refresh():
    a = _ell_csr()
    pa = port_csr(a)
    jp = jell.build_ell_plan(a)
    tp = tell.build_ell_plan(pa)
    for f in ("values", "cols", "gather_idx", "valid"):
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)))
    assert (tp.width, tp.m_pad, tp.shape) == (jp.width, jp.m_pad, jp.shape)
    # the JAX plan carried across is the same plan
    cp = interop.ell_plan_from_numpy(jp.values, jp.cols, jp.gather_idx,
                                     jp.valid, jp.shape, device="cpu")
    assert all(torch.equal(getattr(cp, f), getattr(tp, f))
               for f in ("values", "cols", "gather_idx", "valid"))
    x = gen.generate_vector(150, seed=12)
    b = gen.generate_dense(150, 6, seed=13)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    y = tell.ell_spmv(tp, tx)
    assert_rows_close(y, jell.ell_spmv(jp, x), a, x)
    assert torch.equal(plans.plan_spmv(("ell", tp), tx), y)
    c = tell.ell_spmm(tp, tb)
    assert_entries_close(c, jell.ell_spmm(jp, b), a, b)
    assert torch.equal(plans.plan_spmm(("ell", tp), tb), c)
    # new values on the same sparsity: the refreshed plan is a fresh one
    new = np.asarray(a.values) * -3
    fresh = tell.build_ell_plan(pa.update(new))
    refreshed = tp.refresh_values(torch.from_numpy(new))
    assert torch.equal(refreshed.values, fresh.values)
    np.testing.assert_array_equal(
        to_np(refreshed.values),
        np.asarray(jp.refresh_values(jax.numpy.asarray(new)).values))
    assert torch.equal(tell.ell_spmv(refreshed, tx),
                       tell.ell_spmv(fresh, tx))
    # ELL keeps the operand's dtype: a float64 x is not narrowed
    assert plans.plan_dtype_safe(("ell", tp), torch.float64)

"""spblas_tpu_torch transpose, scale, the conversions to CSC and COO and
the container API they call, held to the JAX package on the same seeded
numpy inputs: structures exact, values to the bit for real alpha and
within 64*eps*|alpha|*|a| per entry for complex alpha (the two
frameworks round a complex product differently).  The JAX side runs
under ``jax.jit`` (one compile a shape, not one per eager op)."""

import jax
import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu.formats.convert import to_coo as jax_to_coo
from spblas_tpu.formats.convert import to_csc as jax_to_csc
from spblas_tpu.formats.coo import csr_to_coo as jax_csr_to_coo
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.formats.coo import csc_to_coo, csr_to_coo

from tests.torch_util import (  # noqa: F401
    FORMATS, assert_dense_close, assert_same_container, csr_dense,
    format_operand, one_torch_thread, port_of, to_np)
from tests.util import DIMS, assert_close, dense_from_csr

_jax_transpose = jax.jit(sp.transpose)


@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_transpose_materialized(m, n, nnz):
    a = gen.generate_csr(m, n, nnz, seed=0)
    b = tsp.transpose(port_of(a))
    b.validate()
    assert b.shape == (n, m)
    assert_same_container(b, _jax_transpose(a))
    assert_close(to_np(b.todense()), dense_from_csr(a).T)


def test_transpose_inspect():
    a = gen.generate_csr(30, 50, 200, seed=1)
    info = tsp.transpose_inspect(port_of(a))
    ref = sp.transpose_inspect(a)
    assert info.result_shape == ref.result_shape == (50, 30)
    assert info.result_nnz == ref.result_nnz == 200
    assert info.result_capacity == ref.result_capacity


def test_transpose_scaled():
    a = gen.generate_csr(25, 35, 150, seed=2)
    b = tsp.transpose(tsp.scaled(2.0, port_of(a)))
    assert_same_container(b, _jax_transpose(sp.scaled(2.0, a)))
    assert_close(to_np(b.todense()), 2.0 * dense_from_csr(a).T)


def test_transpose_capacity_check():
    """The JAX text; a capacity that holds the nnz re-targets the
    padding as the JAX transpose does (``with_capacity`` of its
    result), both ways."""
    a = gen.generate_csr(10, 10, 50, seed=3)
    pa = port_of(a)
    with pytest.raises(RuntimeError, match=r"transpose: output capacity "
                       r"too small \(transpose_impl.hpp capacity check\)"):
        tsp.transpose(pa, capacity=10)
    ref = _jax_transpose(a)
    for cap in (50, 200):
        assert_same_container(tsp.transpose(pa, capacity=cap),
                              ref.with_capacity(cap))


def test_scale():
    a = gen.generate_csr(20, 20, 100, seed=4)
    b = tsp.scale(3.0, port_of(a))
    assert_same_container(b, sp.scale(3.0, a))
    x = gen.generate_vector(10, seed=5)
    np.testing.assert_array_equal(to_np(tsp.scale(2.0, torch.from_numpy(x))),
                                  np.asarray(sp.scale(2.0, x)))
    # every container scales its values alone
    d = gen.generate_dcsr(40, 30, 60, seed=6)
    assert_same_container(tsp.scale(-0.5, port_of(d)), sp.scale(-0.5, d))


def test_transpose_complex_alpha_conjugated():
    """transpose(scaled(alpha, conjugated(A))) for complex64: the
    structure exact; the values within 64*eps*|alpha|*|a| for complex
    alpha, to the bit for real alpha."""
    a = gen.generate_csr(60, 45, 400, seed=7, complex_=True)
    pa = port_of(a)
    for alpha in (0.75 - 1.5j, -2.0):
        got = tsp.transpose(tsp.scaled(alpha, tsp.conjugated(pa)))
        ref = _jax_transpose(sp.scaled(alpha, sp.conjugated(a)))
        assert_same_container(got, ref, values=isinstance(alpha, float))
        assert_dense_close(csr_dense(got), csr_dense(ref),
                           abs(alpha) * np.abs(csr_dense(ref)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_to_csc_and_to_coo_from_every_format(fmt):
    """to_csc from every format, to_coo from CSR, CSC and COO, bit-equal
    to the JAX conversions (the CSC operand's rows are unsorted within
    its columns); to_coo of a DCSR or BSR raises as in JAX."""
    a = format_operand(fmt, 64, 48, 120, seed=12)
    pa = port_of(a)
    c = tsp.to_csc(pa)
    c.validate()
    # the JAX BSR expands its blocks on the host: not traceable
    assert_same_container(c, (jax_to_csc if fmt == "bsr"
                              else jax.jit(jax_to_csc))(a))
    if fmt in ("dcsr", "bsr"):
        for conv, arg in ((tsp.to_coo, pa), (jax_to_coo, a)):
            with pytest.raises(TypeError, match="cannot convert"):
                conv(arg)
        return
    o = tsp.to_coo(pa)
    o.validate()
    assert_same_container(o, jax.jit(jax_to_coo)(a))


def _jax_api(a, new):
    """The JAX container calls of :func:`test_container_api_matches_jax`,
    one compiled program."""
    c = jax_to_csc(a)
    return (a.entry_mask(), a.row_lengths(), a.with_capacity(300),
            a.with_capacity(1024), a.update(new), jax_csr_to_coo(a), c,
            c.entry_mask(), c.col_lengths(), c.update(new), jax_to_coo(c))


def test_container_api_matches_jax():
    a = gen.generate_csr(50, 40, 300, seed=13, capacity=512)
    pa = port_of(a)
    new = np.asarray(a.values) * 2
    (mask, lens, a300, a1024, a_new, a_coo, c, c_mask, c_lens, c_new,
     c_coo) = jax.jit(_jax_api)(a, new)
    np.testing.assert_array_equal(to_np(pa.entry_mask()), np.asarray(mask))
    np.testing.assert_array_equal(to_np(pa.row_lengths()), np.asarray(lens))
    assert pa.index_dtype == torch.int32
    assert_same_container(pa.with_capacity(300), a300)
    assert_same_container(pa.with_capacity(1024), a1024)
    assert_same_container(pa.update(new), a_new)
    # the COO views of a CSR and a CSC: row-major, padding rows 0
    o = csr_to_coo(pa)
    o.validate()
    assert_same_container(o, a_coo)
    pc = port_of(c)
    np.testing.assert_array_equal(to_np(pc.entry_mask()),
                                  np.asarray(c_mask))
    np.testing.assert_array_equal(to_np(pc.col_lengths()),
                                  np.asarray(c_lens))
    assert_same_container(pc.update(new), c_new)
    assert_same_container(csc_to_coo(pc), c_coo)
    dense = dense_from_csr(a)
    got = tsp.CSC.from_dense(dense, device="cpu")
    assert_same_container(got, sp.CSC.from_dense(dense))
    assert got.device == torch.device("cpu")

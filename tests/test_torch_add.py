"""spblas_tpu_torch SpADD held to the JAX package on the same seeded
numpy inputs: the cases of tests/test_add.py, every format pair of
tests/test_format_coverage.py, the two-phase reuse, the capacity raises
and operands whose COO entries repeat a (row, col).

Tolerances: structures exact; values to the bit for real alpha and
canonical operands (each output slot sums at most one entry of A and one
of B, so both packages add the same two numbers); within
64*eps*(|alpha||A| + |beta||B|) per entry otherwise (complex products
round differently, and three or more terms a slot may be summed in
another order where the JAX sort is not stable).  The JAX numeric runs
compiled, as in the JAX package; its structure pass is compiled there.
"""

import jax
import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu.formats.convert import to_csr as jax_to_csr
from spblas_tpu.info import OperationInfo as JaxInfo
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp

from tests.torch_util import (  # noqa: F401
    FORMATS, assert_dense_close, assert_same_container, csr_dense,
    format_operand, one_torch_thread, port_of, to_np)
from tests.util import SQUARE_DIMS, dense_from_csr


def _dense(a) -> np.ndarray:
    return csr_dense(jax_to_csr(a)).real


@jax.jit
def _jax_fill(plan, a, b):
    return sp.add_compute(JaxInfo(result_shape=plan.shape, result_nnz=0,
                                  plan=plan), a, b)


def _jax_add_compute(info, a, b):
    """The JAX numeric fill of ``info`` (one compile a shape)."""
    return _jax_fill(info.plan, a, b)


def _same_add(c, ref, values=True):
    """The port's sum ``c`` against the JAX sum ``ref``: the same union
    structure, nnz and capacity, the values bit-equal if asked."""
    c.validate()
    assert_same_container(c, ref, values=values)


def test_add_vectors():
    x = gen.generate_vector(100, seed=0)
    y = gen.generate_vector(100, seed=1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(to_np(tsp.add(tx, ty)),
                                  np.asarray(sp.add(x, y)))
    np.testing.assert_array_equal(
        to_np(tsp.add(tsp.scaled(2.0, tx), ty)),
        np.asarray(sp.add(sp.scaled(2.0, x), y)))


def test_add_dense():
    a = gen.generate_dense(30, 40, seed=2)
    b = gen.generate_dense(30, 40, seed=3)
    np.testing.assert_array_equal(
        to_np(tsp.add(torch.from_numpy(a), torch.from_numpy(b))),
        np.asarray(sp.add(a, b)))


@pytest.mark.parametrize("m,n,nnz", SQUARE_DIMS)
def test_add_csr_two_phase(m, n, nnz):
    a = gen.generate_csr(m, n, nnz, seed=4)
    b = gen.generate_csr(m, n, nnz, seed=5)
    info = tsp.add_inspect(port_of(a), port_of(b))
    ref_info = sp.add_inspect(a, b)
    union = np.count_nonzero((dense_from_csr(a) != 0)
                             | (dense_from_csr(b) != 0))
    assert info.result_nnz == ref_info.result_nnz == union
    assert info.result_capacity == ref_info.result_capacity
    c = tsp.add_compute(info, port_of(a), port_of(b))
    _same_add(c, _jax_add_compute(ref_info, a, b))


def test_add_csr_scaled():
    a = gen.generate_csr(50, 50, 300, seed=6)
    b = gen.generate_csr(50, 50, 300, seed=7)
    c = tsp.add(tsp.scaled(2.0, port_of(a)), tsp.scaled(-1.0, port_of(b)))
    info = sp.add_inspect(a, b)
    _same_add(c, _jax_add_compute(info, sp.scaled(2.0, a),
                                  sp.scaled(-1.0, b)))


def test_add_sparse_dense():
    a = gen.generate_csr(20, 30, 100, seed=8)
    b = gen.generate_dense(20, 30, seed=9)
    c = tsp.add(port_of(a), torch.from_numpy(b))
    np.testing.assert_array_equal(to_np(c), np.asarray(sp.add(a, b)))
    # dense on the left, a scaled sparse operand on the right
    c = tsp.add(torch.from_numpy(b), tsp.scaled(0.5, port_of(a)))
    np.testing.assert_array_equal(to_np(c),
                                  np.asarray(sp.add(b, sp.scaled(0.5, a))))


def test_add_shape_mismatch_raises():
    a = gen.generate_csr(10, 10, 20, seed=10)
    b = gen.generate_csr(10, 11, 20, seed=11)
    with pytest.raises(ValueError, match="add shape mismatch"):
        tsp.add(port_of(a), port_of(b))
    with pytest.raises(ValueError, match="add shape mismatch"):
        tsp.add(torch.zeros(3), torch.zeros(4))


@pytest.mark.parametrize("fmt_a", FORMATS)
@pytest.mark.parametrize("fmt_b", ["csr", "bsr", "dcsr"])
def test_add_any_format_pair(fmt_a, fmt_b):
    """Every sparse container reaches the union add through to_csr."""
    m, n = 64, 48
    a = format_operand(fmt_a, m, n, 120, seed=10)
    b = format_operand(fmt_b, m, n, 140, seed=11)
    c = tsp.add(port_of(a), port_of(b))
    # the JAX BSR expands its blocks on the host (not traceable): the
    # compiled fill takes its CSR, as JAX's own add_compute would make it
    ja, jb = (jax_to_csr(t) if f == "bsr" else t
              for t, f in ((a, fmt_a), (b, fmt_b)))
    _same_add(c, _jax_add_compute(sp.add_inspect(a, b), ja, jb))
    np.testing.assert_allclose(csr_dense(c).real, _dense(a) + _dense(b),
                               rtol=1e-6, atol=1e-6)


def test_add_two_phase_reuse():
    """One inspection, then fills with new values on the same structure
    (numeric reuse), each bit-equal to the JAX fill and to the one-shot
    add; a fill gives the same bits again."""
    a = gen.generate_csr(60, 60, 500, seed=20)
    b = gen.generate_csr(60, 60, 400, seed=21)
    pa, pb = port_of(a), port_of(b)
    info = tsp.add_inspect(pa, pb)
    ref_info = sp.add_inspect(a, b)
    rng = np.random.default_rng(22)
    for _ in range(2):
        va = rng.standard_normal(a.capacity).astype(np.float32)
        vb = rng.standard_normal(b.capacity).astype(np.float32)
        va[a.nnz:] = 0
        vb[b.nnz:] = 0
        ja, jb = a.update(va), b.update(vb)
        ta, tb = pa.update(va), pb.update(vb)
        c = tsp.add_compute(info, tsp.scaled(1.5, ta), tb)
        ref = _jax_add_compute(ref_info, sp.scaled(1.5, ja), jb)
        _same_add(c, ref)
        assert_same_container(tsp.add(tsp.scaled(1.5, ta), tb), ref)
        assert torch.equal(tsp.add_compute(info, tsp.scaled(1.5, ta),
                                           tb).values, c.values)


def test_add_capacity_raises():
    a = gen.generate_csr(40, 40, 200, seed=23)
    b = gen.generate_csr(40, 40, 200, seed=24)
    pa, pb = port_of(a), port_of(b)
    info = tsp.add_inspect(pa, pb)
    for inspect in (tsp.add_inspect, sp.add_inspect):
        with pytest.raises(RuntimeError, match="add: result capacity too "
                           "small"):
            inspect(*((pa, pb) if inspect is tsp.add_inspect else (a, b)),
                    c_capacity=info.result_nnz - 1)
    small = tsp.CSR.from_arrays(np.zeros(1, np.float32), np.zeros(41),
                                np.zeros(1), (40, 40), nnz=0, device="cpu")
    with pytest.raises(RuntimeError, match="add_compute: user capacity"):
        tsp.add_compute(info, pa, pb, c=small)
    # a user capacity that fits re-targets the padding, as in JAX
    ref_info = sp.add_inspect(a, b)
    user = small.with_capacity(2048)
    c = tsp.add_compute(info, pa, pb, c=user)
    assert c.capacity == 2048
    _same_add(c, _jax_add_compute(ref_info, a, b).with_capacity(2048))
    # an explicit c_capacity at inspection
    c = tsp.add_compute(tsp.add_inspect(pa, pb, c_capacity=1000), pa, pb)
    _same_add(c, _jax_add_compute(sp.add_inspect(a, b, c_capacity=1000),
                                  a, b))


def _repeated_coo(m, n, slots, reps, seed):
    """A JAX COO whose ``slots`` distinct (row, col) entries each appear
    ``reps`` times, row-major, with random values."""
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(m * n, size=slots, replace=False))
    rows = np.repeat(flat // n, reps)
    cols = np.repeat(flat % n, reps)
    vals = rng.uniform(-100, 100, slots * reps).astype(np.float32)
    return sp.COO.from_arrays(vals, rows, cols, (m, n))


def test_add_coo_repeated_entries():
    """Three entries a slot: the union structure exact, every slot
    within the limit of JAX's sum and of the float64 sum, and the same
    bits from two fills."""
    a = _repeated_coo(50, 40, 150, 2, seed=25)
    b = gen.generate_csr(50, 40, 300, seed=26)
    pa, pb = port_of(a), port_of(b)
    info = tsp.add_inspect(pa, pb)
    assert info.plan.max_run >= 3
    c = tsp.add_compute(info, tsp.scaled(2.0, pa), pb)
    ref = _jax_add_compute(sp.add_inspect(a, b), sp.scaled(2.0, a), b)
    _same_add(c, ref, values=False)
    abs_sum = np.zeros(a.shape)
    ra = np.asarray(a.rowind)[:int(a.nnz)]
    ca = np.asarray(a.colind)[:int(a.nnz)]
    np.add.at(abs_sum, (ra, ca),
              2.0 * np.abs(np.asarray(a.values)[:int(a.nnz)]))
    bound = abs_sum + np.abs(csr_dense(b))
    assert_dense_close(csr_dense(c), csr_dense(ref), bound)
    assert_dense_close(csr_dense(c), 2.0 * csr_dense(jax_to_csr(a))
                       + csr_dense(b), bound)
    again = tsp.add_compute(info, tsp.scaled(2.0, pa), pb)
    assert torch.equal(again.values, c.values)


def test_add_complex_alpha():
    """complex64 operands under a complex alpha and a conjugation."""
    a = gen.generate_csr(40, 30, 250, seed=27, complex_=True)
    b = gen.generate_csr(40, 30, 250, seed=28, complex_=True)
    alpha, beta = 0.5 + 2j, -1.25
    c = tsp.add(tsp.scaled(alpha, tsp.conjugated(port_of(a))),
                tsp.scaled(beta, port_of(b)))
    ref = _jax_add_compute(sp.add_inspect(a, b),
                           sp.scaled(alpha, sp.conjugated(a)),
                           sp.scaled(beta, b))
    _same_add(c, ref, values=False)
    assert_dense_close(csr_dense(c), csr_dense(ref),
                       abs(alpha) * np.abs(csr_dense(a))
                       + abs(beta) * np.abs(csr_dense(b)))

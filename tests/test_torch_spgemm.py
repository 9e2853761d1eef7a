"""spblas_tpu_torch two-phase SpGEMM against the JAX package: the same
seeded operands through ``spblas_tpu``'s ``spgemm_compute`` /
``spgemm_fill`` (its XLA numeric) and through the port's, with the
port's ROUTE2-mul engines forced on (``SPBLAS_FORCE_ROUTE_SPGEMM``, the
kernels' plain versions on the CPU) and off.  C's structure (rowptr,
colind, result_nnz and the stream's slot numbers) is compared bit for
bit; the values per entry within 64 * eps_f32 * (|alpha| |A|.|B| +
|beta| |D|) (``tests/torch_util.py``), since the two sides sum each
entry's products in different orders.  Also the ESC building blocks
(``backend/engine.py``) against JAX's, the error contract, and the
plan-size gates of the engine chooser."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spblas_tpu as sp
from spblas_tpu.backend import engine as jengine
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.backend import engine as tengine
from spblas_tpu_torch.kernels.route2 import Route2MulPlan
from spblas_tpu_torch.kernels.route_mul_paned import Route2MulPanedPlan
from spblas_tpu_torch.utils import generate as tgen

from tests.torch_util import (  # noqa: F401
    abs_spgemm, assert_spgemm_close, csr_dense, one_torch_thread,
    port_csr, to_np)

ENGINES = {"none": None, "resident": Route2MulPlan,
           "paned": Route2MulPanedPlan}


@pytest.fixture
def engine(request, monkeypatch):
    """Force the port's SpGEMM engine on (resident or paned) or leave it
    off, as the parameter names; the JAX side always takes its XLA
    numeric."""
    for k in ("SPBLAS_FORCE_ROUTE_SPGEMM", "SPBLAS_FORCE_PANED_SPGEMM",
              "SPBLAS_ROUTE_SPGEMM", "SPBLAS_NO_ROUTE_SPGEMM"):
        monkeypatch.delenv(k, raising=False)
    if request.param != "none":
        monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    if request.param == "paned":
        monkeypatch.setenv("SPBLAS_FORCE_PANED_SPGEMM", "1")
    return request.param


def _ops(*shapes_seeds):
    return [gen.generate_csr(m, n, nnz, seed=s) for m, n, nnz, s in
            shapes_seeds]


def _jax_fill(a, b, d=None, alpha=1.0, beta=1.0, c_capacity=None):
    info = sp.spgemm_compute(sp.scaled(alpha, a), b,
                             d_view=None if d is None else
                             sp.scaled(beta, d), c_capacity=c_capacity,
                             reuse=False)
    return info, sp.spgemm_fill(info, sp.scaled(alpha, a), b,
                                d_view=None if d is None else
                                sp.scaled(beta, d))


def _assert_structure(ti, ji):
    assert ti.result_nnz == ji.result_nnz
    assert ti.result_shape == ji.result_shape
    for f in ("c_rowptr", "c_colind", "slot"):
        np.testing.assert_array_equal(to_np(getattr(ti.plan, f)),
                                      np.asarray(getattr(ji.plan, f)), f)


@pytest.mark.parametrize("m,k,n,nnz", [(1, 1, 1, 1), (40, 50, 30, 300),
                                       (137, 100, 90, 1200),
                                       (64, 64, 64, 512)])
def test_structure_and_values_match_jax(m, k, n, nnz):
    a, b = _ops((m, k, nnz, 0), (k, n, nnz, 1))
    ji, jc = _jax_fill(a, b)
    ti = tsp.multiply_compute(port_csr(a), port_csr(b))
    _assert_structure(ti, ji)
    tc = tsp.multiply_fill(ti, port_csr(a), port_csr(b))
    assert tc.nnz == ti.result_nnz and tc.capacity == ti.result_capacity
    tc.validate()
    assert_spgemm_close(tc, jc, abs_spgemm(a, b))


@pytest.mark.parametrize("engine", list(ENGINES), indirect=True)
def test_two_phase_fused_and_reuse_match_jax(engine):
    """3-argument, fused 4-argument C = 2AB - 0.25D, and a numeric rerun
    with new values, each against JAX's spgemm_fill."""
    a, b, d = _ops((350, 350, 3200, 31), (350, 350, 3200, 32),
                   (350, 350, 1500, 33))
    ta, tb, td = port_csr(a), port_csr(b), port_csr(d)
    ji, jc = _jax_fill(a, b)
    st = tsp.SpgemmState()
    ti = tsp.multiply_symbolic_compute(st, ta, tb)
    want = ENGINES[engine]
    assert (ti.plan.route is None if want is None
            else isinstance(ti.plan.route, want))
    _assert_structure(ti, ji)
    assert_spgemm_close(tsp.multiply_numeric(st, ta, tb), jc,
                        abs_spgemm(a, b))

    jd_info, jdc = _jax_fill(a, b, d, alpha=2.0, beta=-0.25)
    st = tsp.SpgemmState()
    tdc = tsp.multiply_fused(st, tsp.scaled(2.0, ta), tb,
                             tsp.scaled(-0.25, td))
    _assert_structure(st.info, jd_info)
    assert_spgemm_close(tdc, jdc, abs_spgemm(a, b, d, 2.0, -0.25))
    # numeric reuse with new A values, same sparsity
    a3 = dataclasses.replace(a, values=a.values * 3.0)
    ta3 = dataclasses.replace(ta, values=ta.values * 3.0)
    _, j3 = _jax_fill(a3, b, d, alpha=2.0, beta=-0.25)
    t3 = st.numeric(tsp.scaled(2.0, ta3), tb, d=tsp.scaled(-0.25, td))
    assert_spgemm_close(t3, j3, abs_spgemm(a3, b, d, 2.0, -0.25))
    # the null-D shortcut
    t4 = tsp.multiply_fused(tsp.SpgemmState(), ta, tb, None)
    assert_spgemm_close(t4, jc, abs_spgemm(a, b))


@pytest.mark.parametrize("engine", ["none", "resident"], indirect=True)
def test_user_capacity_and_with_capacity(engine):
    a, b = _ops((120, 120, 900, 16), (120, 120, 900, 17))
    ta, tb = port_csr(a), port_csr(b)
    _, jc = _jax_fill(a, b)
    info = tsp.multiply_compute(ta, tb, c_capacity=8192)
    assert info.result_capacity == 8192
    assert tsp.multiply_fill(info, ta, tb).capacity == 8192
    info = tsp.multiply_compute(ta, tb)
    big = info.plan.c_capacity * 2
    c_user = tsp.CSR(values=torch.zeros(big), rowptr=info.plan.c_rowptr,
                     colind=torch.zeros(big, dtype=torch.int32),
                     nnz=info.result_nnz, shape=info.plan.shape)
    # re-targeting keeps the engine (the extra capacity is zero padding)
    plan2 = info.plan.with_capacity(big)
    assert (plan2.route is None) == (engine == "none")
    assert plan2.with_capacity(info.plan.c_capacity).c_capacity == \
        info.plan.c_capacity
    c = tsp.multiply_fill(info, ta, tb, c=c_user)
    assert c.capacity == big and c.colind.shape == (big,)
    assert_spgemm_close(c, jc, abs_spgemm(a, b))
    # symbolic_fill with user capacity: the zero-valued structure
    st = tsp.SpgemmState()
    st.symbolic_compute(ta, tb)
    s = tsp.multiply_symbolic_fill(st, ta, tb, c_user)
    assert s.capacity == big and s.nnz == info.result_nnz
    assert not bool(s.values.any())
    assert_spgemm_close(st.numeric(ta, tb), jc, abs_spgemm(a, b))


def test_csc_result_chunked_and_transposed_operand():
    a, b = _ops((30, 40, 300, 5), (40, 35, 300, 6))
    ta, tb = port_csr(a), port_csr(b)
    bound = abs_spgemm(a, b)
    _, jc = _jax_fill(a, b)
    c = tsp.spgemm_csc(ta, tb)
    assert isinstance(c, tsp.CSC) and c.shape == (30, 35)
    want = csr_dense(jc)
    got = to_np(c.todense()).astype(np.complex128)
    assert (np.abs(got - want) <= 64 * 1.2e-7 * bound).all()
    a2, b2 = _ops((137, 100, 1200, 10), (100, 90, 900, 11))
    _, jc2 = _jax_fill(a2, b2, alpha=2.0)
    for chunk in (16, 50, 200):
        c2 = tsp.spgemm_chunked(tsp.scaled(2.0, port_csr(a2)),
                                port_csr(b2), rows_per_chunk=chunk)
        c2.validate()
        assert_spgemm_close(c2, jc2, abs_spgemm(a2, b2, alpha=2.0))
    # A stored transposed: C = A^T B
    at = gen.generate_csr(40, 30, 300, seed=3)
    jt = sp.multiply(sp.transposed(at), b)
    tt = tsp.multiply(tsp.transposed(port_csr(at)), tb)
    np.testing.assert_array_equal(to_np(tt.rowptr), np.asarray(jt.rowptr))
    assert (np.abs(csr_dense(tt) - csr_dense(jt))
            <= 64 * 1.2e-7 * (np.abs(csr_dense(at)).T
                              @ np.abs(csr_dense(b)))).all()


@pytest.mark.parametrize("fmt", ["csc", "coo"])
def test_csc_and_coo_operands(fmt):
    """A in CSC or COO canonicalises to CSR on both sides."""
    b = gen.generate_csr(50, 30, 350, seed=2)
    if fmt == "csc":
        ja = gen.generate_csc(40, 50, 300, seed=1)
        nnz = int(ja.nnz)
        ta = tsp.CSC.from_arrays(np.asarray(ja.values), np.asarray(ja.colptr),
                                 np.asarray(ja.rowind), ja.shape, nnz=nnz,
                                 device="cpu")
    else:
        ja = gen.generate_coo(40, 50, 300, seed=1)
        nnz = int(ja.nnz)
        ta = tsp.COO.from_arrays(np.asarray(ja.values), np.asarray(ja.rowind),
                                 np.asarray(ja.colind), ja.shape, nnz=nnz,
                                 device="cpu")
    a = sp.to_csr(ja)
    jc = sp.multiply(ja, b)
    tc = tsp.multiply(ta, port_csr(b))
    np.testing.assert_array_equal(to_np(tc.rowptr), np.asarray(jc.rowptr))
    assert_spgemm_close(tc, jc, abs_spgemm(a, b))


@pytest.mark.parametrize("engine", ["resident"], indirect=True)
def test_f64_complex_and_grad_take_the_torch_numeric(engine):
    """With the engine built, f64 or complex fill-time values and values
    that require grad take the dtype-preserving torch numeric."""
    a, b = _ops((60, 60, 400, 41), (60, 60, 400, 42))
    ta, tb = port_csr(a), port_csr(b)
    info = tsp.multiply_compute(ta, tb)
    assert isinstance(info.plan.route, Route2MulPlan)
    want = csr_dense(a) @ csr_dense(b)
    a64 = dataclasses.replace(ta, values=ta.values.double())
    c64 = tsp.multiply_fill(info, a64, tb)
    assert c64.dtype == torch.float64
    bound = np.abs(csr_dense(a)) @ np.abs(csr_dense(b))
    assert (np.abs(csr_dense(c64) - want) <= 64 * 1.2e-7 * bound).all()
    # a complex scale at fill time
    cx = tsp.multiply_fill(info, tsp.scaled(1j, ta), tb)
    assert cx.dtype.is_complex
    assert (np.abs(csr_dense(cx) - 1j * want) <= 64 * 1.2e-7 * bound).all()
    # complex operands: no engine at compute time, the JAX result
    ac = gen.generate_csr(60, 60, 400, seed=43, complex_=True)
    bc = gen.generate_csr(60, 60, 400, seed=44, complex_=True)
    ci = tsp.multiply_compute(port_csr(ac), port_csr(bc))
    assert ci.plan.route is None
    assert_spgemm_close(tsp.multiply_fill(ci, port_csr(ac), port_csr(bc)),
                        sp.multiply(ac, bc), abs_spgemm(ac, bc))
    # grad through the values
    va = ta.values.clone().requires_grad_(True)
    c = tsp.multiply_fill(info, dataclasses.replace(ta, values=va), tb)
    c.values.sum().backward()
    # d(sum C)/dA_ik = sum_j B_kj over A's live entries
    rows_b = csr_dense(b).sum(axis=1).real
    cols = to_np(ta.colind)[: ta.nnz]
    np.testing.assert_allclose(to_np(va.grad)[: ta.nnz], rows_b[cols],
                               rtol=1e-5, atol=1e-3)


def test_errors_raise_as_in_jax(monkeypatch):
    a, b, d = _ops((20, 30, 100, 14), (30, 20, 100, 15),
                   (20, 20, 50, 16))
    ta, tb, td = port_csr(a), port_csr(b), port_csr(d)
    with pytest.raises(ValueError, match="dimension mismatch"):
        tsp.multiply_compute(ta, ta)
    with pytest.raises(ValueError, match="dimension mismatch"):
        tsp.spgemm_chunked(ta, ta, 8)
    with pytest.raises(ValueError, match="D shape"):
        tsp.spgemm_compute(ta, tb, d_view=tb)
    info = tsp.multiply_compute(ta, tb)
    with pytest.raises(RuntimeError, match="ran out of memory"):
        tsp.multiply_compute(ta, tb, c_capacity=max(info.result_nnz // 2,
                                                    1))
    with pytest.raises(ValueError, match="no D structure"):
        tsp.spgemm_fill(info, ta, tb, d_view=td)
    info_d = tsp.spgemm_compute(ta, tb, d_view=td)
    with pytest.raises(ValueError, match="D addend"):
        tsp.spgemm_fill(info_d, ta, tb)
    small = tsp.CSR(values=torch.zeros(4), rowptr=info.plan.c_rowptr,
                    colind=torch.zeros(4, dtype=torch.int32), nnz=0,
                    shape=info.plan.shape)
    with pytest.raises(RuntimeError, match="user capacity"):
        tsp.multiply_fill(info, ta, tb, c=small)
    st = tsp.SpgemmState()
    with pytest.raises(RuntimeError, match="before symbolic_compute"):
        st.numeric(ta, tb)
    with pytest.raises(RuntimeError, match="before symbolic_compute"):
        st.symbolic_fill(ta, tb)
    st.symbolic_compute(ta, tb)
    with pytest.raises(RuntimeError, match="user capacity"):
        st.symbolic_fill(ta, tb, small)
    # the ROUTE v1 engine's selector builds the engine, whose fill
    # matches JAX's product (and raises as the others on a short C)
    from spblas_tpu_torch.kernels.route_mul import RouteMulPlan
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    monkeypatch.setenv("SPBLAS_ROUTE_SPGEMM", "1")
    info_v1 = tsp.multiply_compute(ta, tb)
    assert isinstance(info_v1.plan.route, RouteMulPlan)
    _assert_structure(info_v1, sp.multiply_compute(a, b))
    assert_spgemm_close(tsp.multiply_fill(info_v1, ta, tb),
                        sp.multiply(a, b), abs_spgemm(a, b))
    with pytest.raises(RuntimeError, match="user capacity"):
        tsp.multiply_fill(info_v1, ta, tb, c=small)


def test_engine_gates(monkeypatch):
    """CPU operands take no engine unless forced; the opt-out, the
    paned expansion and chunk budgets, and complex values refuse it."""
    for k in ("SPBLAS_FORCE_ROUTE_SPGEMM", "SPBLAS_FORCE_PANED_SPGEMM",
              "SPBLAS_ROUTE_SPGEMM", "SPBLAS_NO_ROUTE_SPGEMM"):
        monkeypatch.delenv(k, raising=False)
    a, b = _ops((80, 80, 600, 21), (80, 80, 600, 22))
    ta, tb = port_csr(a), port_csr(b)
    assert tsp.multiply_compute(ta, tb).plan.route is None
    assert tsp.spgemm_compute(ta, tb, reuse=False).plan.route is None
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    assert isinstance(tsp.multiply_compute(ta, tb).plan.route,
                      Route2MulPlan)
    assert tsp.spgemm_compute(ta, tb, reuse=False).plan.route is None
    monkeypatch.setenv("SPBLAS_NO_ROUTE_SPGEMM", "1")
    assert tsp.multiply_compute(ta, tb).plan.route is None
    monkeypatch.delenv("SPBLAS_NO_ROUTE_SPGEMM")
    monkeypatch.setenv("SPBLAS_FORCE_PANED_SPGEMM", "1")
    assert isinstance(tsp.multiply_compute(ta, tb).plan.route,
                      Route2MulPanedPlan)
    monkeypatch.setenv("SPBLAS_MUL_CHUNK_BUDGET", "0")
    assert tsp.multiply_compute(ta, tb).plan.route is None
    monkeypatch.delenv("SPBLAS_MUL_CHUNK_BUDGET")
    monkeypatch.setenv("SPBLAS_MUL_EXPANSION_BUDGET", "10")
    assert tsp.multiply_compute(ta, tb).plan.route is None


def test_bench_2k_plan_has_the_jax_record_numbers(monkeypatch):
    """C = A·A on bench.py's section_spgemm matrix (2,000^2, 40,000
    entries, seed 0): the resident engine with the JAX record's
    result_nnz (725,545) and chunk count (2,150), no aux chunk, and
    g_a = g_b = 32."""
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    monkeypatch.delenv("SPBLAS_FORCE_PANED_SPGEMM", raising=False)
    a = tgen.generate_csr(2000, 2000, 40_000, seed=0, device="cpu")
    info = tsp.multiply_compute(a, a)
    r = info.plan.route
    assert info.result_nnz == 725_545
    assert isinstance(r, Route2MulPlan)
    assert (r.nchunks, r.n_aux_chunks, r.g_a, r.g_b) == (2150, 0, 32, 32)
    assert r.dist_max == 4 and abs(r.fill - 0.364) < 5e-4


def test_esc_engine_matches_jax():
    """lexsort_coo, coalesce_sorted, compress and symbolic_compress on a
    seeded stream with invalid entries (sentinel row m)."""
    rng = np.random.default_rng(7)
    m, n, e = 50, 40, 3000
    rows = rng.integers(0, m, e).astype(np.int32)
    cols = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.8
    rows[~valid] = m
    cols[~valid] = 0
    vals = rng.standard_normal(e).astype(np.float32)
    jr, jc, jv, jval = jengine.lexsort_coo(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(valid))
    tr, tc, tv, tval = tengine.lexsort_coo(
        torch.from_numpy(rows), torch.from_numpy(cols), n,
        torch.from_numpy(vals), torch.from_numpy(valid))
    np.testing.assert_array_equal(to_np(tr), np.asarray(jr))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    jh, js, jn, jrp = jengine.coalesce_sorted(jr, jc, jval, m)
    th, ts, tn, trp = tengine.coalesce_sorted(tr, tc, tval, m)
    for t, j in ((th, jh), (ts, js), (trp, jrp)):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
    assert int(tn) == int(jn)
    cap = int(jn) + 5
    out_j = jengine.compress(jr, jc, jv, jval, m, cap)
    out_t = tengine.compress(tr, tc, tv, tval, m, cap)
    for t, j in zip(out_t[1:4], out_j[1:4]):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
    np.testing.assert_allclose(to_np(out_t[0]), np.asarray(out_j[0]),
                               rtol=1e-5, atol=1e-5)
    srp, snnz = tengine.symbolic_compress(tr, tc, tval, m)
    np.testing.assert_array_equal(to_np(srp), np.asarray(jrp))
    assert int(snnz) == int(jn)


def test_multiply_routes_and_spgemm_one_shot():
    """multiply on two sparse operands is the one-shot SpGEMM (a CSR),
    in the operands' dtype, with views folded."""
    a, b = _ops((64, 64, 512, 6), (64, 64, 512, 6))
    ta = port_csr(a)
    c = tsp.multiply(tsp.scaled(2.0, ta), ta)
    jc = sp.multiply(sp.scaled(2.0, a), a)
    assert isinstance(c, tsp.CSR) and c.dtype == torch.float32
    np.testing.assert_array_equal(to_np(c.colind), np.asarray(jc.colind))
    assert_spgemm_close(c, jc, abs_spgemm(a, a, alpha=2.0))
    assert_spgemm_close(tsp.spgemm(ta, ta), sp.spgemm(a, a),
                        abs_spgemm(a, a))

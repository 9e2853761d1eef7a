"""spblas_tpu_torch SpMM end to end against the JAX package: the band
SpMM kernels' plain versions against the interpret-mode Pallas kernels,
the RCM permuted band, ``plan_spmm`` for every plan kind, and the main
path ``multiply(scaled(2.0, matrix_opt(A)), B)``, dense·sparse and the
base paths, on the same seeded numpy inputs.

Tolerance: per entry 64 * eps_f32 * scale * (|A| . |B|)
(``tests/torch_util.py``), since the two packages sum in different
orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu import native as jnative
from spblas_tpu.kernels import banded as jbanded
from spblas_tpu.kernels import plans as jplans
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch import native as tnative
from spblas_tpu_torch.kernels import banded as tbanded
from spblas_tpu_torch.kernels import plans as tplans
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    assert_entries_close, assert_rows_close, block_dense_csr,
    one_torch_thread, permuted_csr, port_csr, to_np)


def _dense(n, k, seed, complex_=False):
    return gen.generate_dense(n, k, seed=seed, complex_=complex_)


def _complex_band(m, n, bandwidth, seed):
    """A banded JAX CSR with complex64 values from two seeded f32 value
    sets over the same structure."""
    a = gen.generate_banded_csr(m, n, bandwidth, seed=seed)
    imag = gen.generate_banded_csr(m, n, bandwidth, seed=seed + 1).values
    return dataclasses.replace(a, values=(a.values + 1j * imag).astype(
        jnp.complex64))


# every structured kind of the CUDA ladder, and SELL, with the matrix
# that reaches it (the JAX TPU ladder gives the same kind)
KIND_MATRICES = {
    "band": lambda: gen.generate_banded_csr(700, 700, 31, seed=9),
    "bsr": lambda: block_dense_csr(128, 1024, 40, seed=1),
    "band_perm": lambda: permuted_csr(
        gen.generate_banded_csr(1500, 1500, 21, seed=2), seed=3),
    "dia": lambda: gen.generate_stencil_csr((60, 60), seed=4),
    "band_cx": lambda: _complex_band(900, 1000, 15, seed=5),
    "sell": lambda: gen.generate_csr(600, 600, 4800, seed=6),
}


def test_band_spmm_stream_matches_resident_and_jax():
    """The 700x32 shape of tests/test_kernels.py: both port kernels'
    plain version against JAX's resident and streamed kernels."""
    a = gen.generate_banded_csr(700, 700, 31, seed=9)
    jplan = jbanded.build_band_plan(a)
    tplan = tbanded.build_band_plan(port_csr(a))
    np.testing.assert_array_equal(to_np(tplan.panels),
                                  np.asarray(jplan.panels))
    b = np.random.default_rng(10).standard_normal((700, 32)).astype(
        np.float32)
    c_res = tbanded.band_spmm(tplan, torch.from_numpy(b))
    c_str = tbanded.band_spmm_stream(tplan, torch.from_numpy(b))
    np.testing.assert_array_equal(to_np(c_res), to_np(c_str))
    assert c_res.dtype == torch.float32 and c_res.shape == (700, 32)
    for want in (jbanded.band_spmm(jplan, jnp.asarray(b), interpret=True),
                 jbanded.band_spmm_stream(jplan, jnp.asarray(b),
                                          interpret=True)):
        assert_entries_close(c_str, want, a, b)


def test_band_spmm_bf16_panels_match_jax():
    a = gen.generate_banded_csr(500, 620, 12, seed=11)
    jplan = jbanded.build_band_plan(a, dtype=jnp.bfloat16)
    tplan = tbanded.build_band_plan(port_csr(a), dtype=torch.bfloat16)
    np.testing.assert_array_equal(to_np(tplan.panels),
                                  np.asarray(jplan.panels).astype(np.float32))
    b = np.random.default_rng(12).standard_normal((620, 9)).astype(
        np.float32)
    c = tbanded.band_spmm(tplan, torch.from_numpy(b))
    want = jbanded.band_spmm(jplan, jnp.asarray(b), interpret=True)
    # both sides multiply the same bf16 panel values in f32
    ref = dataclasses.replace(a, values=jnp.asarray(
        np.asarray(a.values).astype(jnp.bfloat16).astype(np.float32)))
    assert_entries_close(c, want, ref, b)


def test_band_spmm_padded_checks_operands():
    panels = torch.zeros(256, 136)
    with pytest.raises(ValueError, match="bp rows"):
        tbanded.band_spmm_padded(panels, torch.zeros(263, 4))
    with pytest.raises(TypeError, match="bp must be float32"):
        tbanded.band_spmm_stream_padded(panels, torch.zeros(264, 4).double())
    with pytest.raises(ValueError, match="contiguous"):
        tbanded.band_spmm_padded(panels, torch.zeros(4, 264).T)


def test_rcm_and_permuted_band_plan_bit_equal_to_jax():
    """The port's native RCM gives JAX's permutation and half-width, and
    the permuted band plan's arrays are JAX's, bit for bit (the carried
    plan too)."""
    a = KIND_MATRICES["band_perm"]()
    m, nnz = a.shape[0], int(a.nnz)
    args = (m, nnz, np.asarray(a.rowptr).astype(np.int64),
            np.asarray(a.colind))
    jperm, jh = jnative.rcm(*args)
    tperm, th = tnative.rcm(*args)
    np.testing.assert_array_equal(tperm, jperm)
    assert th == jh and th < 40
    jp = jbanded.build_permuted_band_plan(a)
    tp = tbanded.build_permuted_band_plan(port_csr(a))
    carried = interop.permuted_band_plan_from_numpy(
        np.asarray(jp.band.panels), jp.band.pad_l, jp.band.shape,
        np.asarray(jp.perm), np.asarray(jp.rank), device="cpu")
    for p in (tp, carried):
        np.testing.assert_array_equal(to_np(p.band.panels),
                                      np.asarray(jp.band.panels))
        np.testing.assert_array_equal(to_np(p.perm), np.asarray(jp.perm))
        np.testing.assert_array_equal(to_np(p.rank), np.asarray(jp.rank))
        assert p.band.pad_l == jp.band.pad_l and p.shape == jp.shape
    x = gen.generate_vector(m, seed=13)
    assert_rows_close(tbanded.permuted_band_spmv(tp, torch.from_numpy(x)),
                      jbanded.permuted_band_spmv(jp, jnp.asarray(x),
                                                 interpret=True), a, x)


def _gates(monkeypatch):
    monkeypatch.setattr(jplans, "_on_tpu", lambda: True)
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)


@pytest.mark.parametrize("kind", sorted(KIND_MATRICES))
def test_plan_spmm_matches_jax(kind, monkeypatch):
    """With both gates forced, build_matmul_plan gives JAX's kind and
    plan_spmm JAX's result (Pallas kernels in interpret mode)."""
    _gates(monkeypatch)
    a = KIND_MATRICES[kind]()
    jk, jp = jplans.build_matmul_plan(a)
    tk, tp = tplans.build_matmul_plan(port_csr(a))
    assert tk == jk == kind
    cx = kind == "band_cx"
    b = _dense(a.shape[1], 5, seed=14, complex_=cx)
    c = tplans.plan_spmm((tk, tp), torch.from_numpy(b))
    assert c.dtype == (torch.complex64 if cx else torch.float32)
    assert_entries_close(c, jplans.plan_spmm((jk, jp), jnp.asarray(b)), a, b)


def test_plan_spmm_streams_b_past_the_resident_limit(monkeypatch):
    """A band plan takes the streamed kernel once the resident padded B
    passes the 6 MB switch, the resident one below it."""
    calls = []
    for name in ("band_spmm_inplace", "band_spmm_stream_inplace"):
        fn = getattr(tbanded, name)
        monkeypatch.setattr(tbanded, name,
                            lambda *a, fn=fn, name=name, **kw: (
                                calls.append(name), fn(*a, **kw))[1])
    a = gen.generate_banded_csr(700, 700, 31, seed=9)
    plan = ("band", tbanded.build_band_plan(port_csr(a)))
    tplans.plan_spmm(plan, torch.zeros(700, 8))
    monkeypatch.setattr(tplans, "_BAND_RESIDENT_B_BYTES", 1024)
    b = _dense(700, 8, seed=15)
    c = tplans.plan_spmm(plan, torch.from_numpy(b))
    assert calls == ["band_spmm_inplace", "band_spmm_stream_inplace"]
    assert_entries_close(c, sp.multiply(a, jnp.asarray(b)), a, b)


ROUTE_CASES = {
    "route": (lambda: gen.generate_csr(1500, 1500, 12_000, seed=23), {}),
    "route_cx": (lambda: gen.generate_csr(1500, 1500, 12_000, seed=24,
                                          complex_=True), {}),
    "route1": (lambda: gen.generate_rmat_csr(2048, 2048 * 16, seed=5), {}),
    "route1_sorted": (lambda: gen.generate_rmat_csr(2048, 2048 * 16,
                                                    seed=5),
                      {"_SORTED_DISPATCH_NS": -10 ** 12}),
    "route_paned": (lambda: gen.generate_csr(1500, 1500, 12_000, seed=23),
                    {"_ROUTE_VMEM_ROWS": 10}),
}


@pytest.mark.parametrize("kind", sorted(ROUTE_CASES))
def test_plan_spmm_replays_route_plans_with_warning(kind, monkeypatch):
    """A matvec ROUTE plan fed to plan_spmm warns and replays the SpMV
    kernel per column; the result matches JAX's base-path SpMM."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    make, patches = ROUTE_CASES[kind]
    for name, value in patches.items():
        monkeypatch.setattr(tplans, name, value)
    a = make()
    plan = tplans.build_matvec_plan(port_csr(a))
    assert plan[0] == kind
    cx = kind == "route_cx"
    b = _dense(a.shape[1], 3, seed=16, complex_=cx)
    with pytest.warns(UserWarning, match="replaying the SpMV kernel"):
        c = tplans.plan_spmm(plan, torch.from_numpy(b))
    assert c.shape == (a.shape[0], 3)
    assert_entries_close(c, sp.multiply(a, jnp.asarray(b)), a, b)


@pytest.mark.parametrize("kind", sorted(KIND_MATRICES))
def test_main_path_spmm_matches_jax(kind, monkeypatch):
    """The slice end to end: multiply(scaled(2.0, matrix_opt(A)), B) with
    both gates forced, each kind against JAX's."""
    _gates(monkeypatch)
    a = KIND_MATRICES[kind]()
    cx = kind == "band_cx"
    b = _dense(a.shape[1], 6, seed=17, complex_=cx)
    opt = tsp.matrix_opt(port_csr(a))
    c = tsp.multiply(tsp.scaled(2.0, opt), torch.from_numpy(b))
    assert opt._plans["matmul"][0] == kind
    want = sp.multiply(sp.scaled(2.0, sp.matrix_opt(a)), jnp.asarray(b))
    assert_entries_close(c, want, a, b, scale=2.0)


def test_structured_plan_serves_matvec_and_matmul(monkeypatch):
    """A structured plan built for SpMV serves SpMM (and the other way
    round) without a second inspection; a ROUTE matvec plan does not:
    SpMM builds its own SELL plan."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    a = KIND_MATRICES["bsr"]()
    opt = tsp.matrix_opt(port_csr(a))
    x = torch.from_numpy(gen.generate_vector(a.shape[1], seed=18))
    tsp.multiply(opt, x)
    plan = opt._plans["matvec"]
    tsp.multiply(opt, torch.from_numpy(_dense(a.shape[1], 4, seed=19)))
    assert list(opt._plans) == ["matvec"] and plan[0] == "bsr"
    opt2 = tsp.matrix_opt(port_csr(KIND_MATRICES["band"]()))
    tsp.multiply(opt2, torch.from_numpy(_dense(700, 4, seed=20)))
    tsp.multiply(opt2, torch.from_numpy(gen.generate_vector(700, seed=21)))
    assert list(opt2._plans) == ["matmul"]
    u = gen.generate_csr(1500, 1500, 12_000, seed=23)
    opt3 = tsp.matrix_opt(port_csr(u))
    tsp.multiply(opt3, torch.from_numpy(gen.generate_vector(1500, seed=22)))
    tsp.multiply(opt3, torch.from_numpy(_dense(1500, 2, seed=23)))
    assert opt3._plans["matvec"][0] == "route"
    assert opt3._plans["matmul"][0] == "sell"


def _port_format(a, fmt):
    """The JAX CSR ``a`` as a port container of format ``fmt`` on the
    CPU, beside the JAX container of the same format."""
    m, n = a.shape
    dense = np.asarray(a.todense())
    if fmt == "csr":
        return a, port_csr(a)
    if fmt == "csc":
        j = sp.to_csc(a)
        return j, tsp.CSC.from_arrays(
            np.asarray(j.values), np.asarray(j.colptr), np.asarray(j.rowind),
            (m, n), nnz=int(j.nnz), device="cpu")
    if fmt == "coo":
        j = sp.to_coo(a)
        return j, tsp.COO.from_arrays(
            np.asarray(j.values), np.asarray(j.rowind), np.asarray(j.colind),
            (m, n), nnz=int(j.nnz), device="cpu")
    from spblas_tpu.formats.bsr import BSR as JBSR
    return (JBSR.from_dense(dense, (8, 8)),
            tsp.BSR.from_dense(dense, (8, 8), device="cpu"))


@pytest.mark.parametrize("opt", [False, True])
@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "bsr"])
def test_sparse_dense_matches_jax(fmt, opt):
    a = gen.generate_csr(96, 80, 900, seed=24)
    ja, ta = _port_format(a, fmt)
    if opt:
        ja, ta = sp.matrix_opt(ja), tsp.matrix_opt(ta)
    b = _dense(80, 7, seed=25)
    c = tsp.multiply(tsp.scaled(3.0, ta), tsp.scaled(0.5, torch.from_numpy(b)))
    want = sp.multiply(sp.scaled(3.0, ja), sp.scaled(0.5, jnp.asarray(b)))
    assert c.shape == (96, 7)
    assert_entries_close(c, want, a, b, scale=1.5)


@pytest.mark.parametrize("opt", [False, True])
@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "bsr"])
def test_dense_sparse_matches_jax(fmt, opt):
    """D @ A through the transpose identity, for every format, with and
    without matrix_opt, under a complex scale and conjugation."""
    a = gen.generate_csr(96, 80, 900, seed=26, complex_=True)
    ja, ta = _port_format(a, fmt)
    if opt:
        ja, ta = sp.matrix_opt(ja), tsp.matrix_opt(ta)
    d = _dense(5, 96, seed=27, complex_=True)
    alpha = 0.5 - 1.5j
    c = tsp.multiply(torch.from_numpy(d),
                     tsp.scaled(alpha, tsp.conjugated(ta)))
    want = sp.multiply(jnp.asarray(d), sp.scaled(alpha, sp.conjugated(ja)))
    assert c.shape == (5, 80) and c.dtype == torch.complex64
    # row i of C is column i of (conj(A)^T D^T)
    at = sp.to_csr(sp.transposed(a))
    assert_entries_close(c.T, np.asarray(want).T, at, d.T, scale=abs(alpha))


def test_dense_sparse_reuses_the_flipped_plan(monkeypatch):
    """dense·sparse on a matrix_opt handle inspects the flipped matrix
    once: a second call reuses its plan."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    a = gen.generate_banded_csr(700, 700, 31, seed=9)
    opt = tsp.matrix_opt(port_csr(a))
    d = torch.from_numpy(_dense(3, 700, seed=28))
    c1 = tsp.multiply(d, opt)
    plan = opt.flipped()._plans["matmul"]
    c2 = tsp.multiply(d, tsp.scaled(2.0, opt))
    assert opt.flipped()._plans["matmul"] is plan and plan[0] == "band"
    assert tsp.transposed(opt).flipped() is opt
    np.testing.assert_array_equal(to_np(c2), 2 * to_np(c1))
    want = sp.multiply(jnp.asarray(to_np(d)), sp.matrix_opt(a))
    assert_entries_close(c1.T, np.asarray(want).T,
                         sp.to_csr(sp.transposed(a)), to_np(d).T)


def test_tf32_setting_does_not_reach_the_dense_products(monkeypatch):
    """Dense·dense and SELL's wide-bucket einsum compute in float64 (so
    no TF32 setting reaches them): with TF32 allowed, every matmul they
    make sees float64 operands and the results are unchanged."""
    dd_a, dd_b = _dense(48, 64, seed=29), _dense(64, 16, seed=30)
    hub = gen.generate_rmat_csr(512, 512 * 16, seed=5)
    hb = _dense(512, 8, seed=31)
    topt = tsp.matrix_opt(port_csr(hub))

    def run():
        return (tsp.multiply(torch.from_numpy(dd_a), torch.from_numpy(dd_b)),
                tsp.multiply(topt, torch.from_numpy(hb)))

    assert max(b.values.shape[1] for b in tplans.build_matmul_plan(
        port_csr(hub))[1].buckets) > 64
    before = run()
    seen = []
    for name in ("matmul", "einsum"):
        fn = getattr(torch, name)

        def spy(*args, fn=fn):
            seen.extend(t.dtype for t in args if isinstance(t, torch.Tensor))
            return fn(*args)
        monkeypatch.setattr(torch, name, spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        after = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen and set(seen) == {torch.float64}
    for x, y in zip(before, after):
        np.testing.assert_array_equal(to_np(x), to_np(y))
    assert_entries_close(after[0], sp.multiply(jnp.asarray(dd_a),
                                               jnp.asarray(dd_b)),
                         sp.CSR.from_dense(dd_a), dd_b, factor=128)
    assert_entries_close(after[1], sp.multiply(hub, jnp.asarray(hb)), hub,
                         hb)


def test_requires_grad_takes_the_base_path(monkeypatch):
    """B (or the values) requiring grad sends the optimized matrix to the
    differentiable base path: no plan is built, and the gradient matches
    jax.grad."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    a = gen.generate_banded_csr(700, 700, 31, seed=9)
    b = _dense(700, 4, seed=32)
    w = _dense(700, 4, seed=33)

    def loss_jax(bj):
        c = sp.multiply(sp.scaled(2.0, sp.matrix_opt(a)), bj)
        return jnp.sum(c * jnp.asarray(w))

    g_jax = jax.jit(jax.grad(loss_jax))(jnp.asarray(b))
    bt = torch.from_numpy(b).requires_grad_(True)
    opt = tsp.matrix_opt(port_csr(a))
    c = tsp.multiply(tsp.scaled(2.0, opt), bt)
    (c * torch.from_numpy(w)).sum().backward()
    assert opt._plans == {}
    assert_entries_close(bt.grad, g_jax, sp.to_csr(sp.transposed(a)), w,
                         scale=2.0)
    pa = port_csr(a)
    pa = dataclasses.replace(pa, values=pa.values.clone().requires_grad_())
    opt = tsp.matrix_opt(pa)
    tsp.multiply(opt, torch.from_numpy(b)).sum().backward()
    assert opt._plans == {} and pa.values.grad is not None


def test_spmm_errors():
    a = port_csr(gen.generate_csr(30, 40, 100, seed=34))
    with pytest.raises(ValueError, match="dimension mismatch"):
        tsp.multiply(a, torch.zeros(30, 3))
    with pytest.raises(ValueError, match="dimension mismatch"):
        tsp.multiply(tsp.matrix_opt(a), torch.zeros(41, 2))
    # sparse·sparse is SpGEMM now, with its own dimension check
    with pytest.raises(ValueError, match="spgemm dimension mismatch"):
        tsp.multiply(a, a)

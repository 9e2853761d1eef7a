"""spblas_tpu_torch SpMV end to end against the JAX package: the main
path ``multiply(scaled(2.0, matrix_opt(A)), x)``, the plan chooser, the
base paths, errors and gradients, on the same seeded numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu.kernels import plans as jplans
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import plans as tplans

from tests.torch_util import (  # noqa: F401
    abs_spgemm, assert_rows_close, assert_spgemm_close, block_dense_csr,
    permuted_csr, port_csr, one_torch_thread)

MATRICES = {
    "banded": lambda: gen.generate_banded_csr(2000, 2000, 17, seed=1),
    "banded_rect": lambda: gen.generate_banded_csr(1500, 2100, 12, seed=2),
    "stencil2d": lambda: gen.generate_stencil_csr((60, 60), seed=3),
    "stencil3d": lambda: gen.generate_stencil_csr((12, 13, 14), seed=4),
    "fem": lambda: gen.generate_fem_graph_csr(30, 120, seed=5),
    "uniform": lambda: gen.generate_csr(1200, 1200, 9600, seed=6),
    "block_dense": lambda: block_dense_csr(256, 1024, 60, seed=27),
    "permuted_band": lambda: permuted_csr(
        gen.generate_banded_csr(1600, 1600, 17, seed=28), seed=29),
}


def _main_path_jax(a, x):
    return sp.multiply(sp.scaled(2.0, sp.matrix_opt(a)), jnp.asarray(x))


def _main_path_port(a, x):
    return tsp.multiply(tsp.scaled(2.0, tsp.matrix_opt(port_csr(a))),
                        torch.from_numpy(x))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_main_path_matches_jax(name):
    a = MATRICES[name]()
    x = gen.generate_vector(a.shape[1], seed=7)
    y_port = _main_path_port(a, x)
    assert y_port.dtype == torch.float32
    assert_rows_close(y_port, _main_path_jax(a, x), a, x, scale=2.0)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_chooser_kind_matches_jax_on_cpu(name):
    a = MATRICES[name]()
    assert tplans.build_matvec_plan(port_csr(a))[0] == \
        jplans.build_matvec_plan(a)[0]


@pytest.mark.parametrize("name,kind", [("banded", "band"),
                                       ("banded_rect", "band"),
                                       ("stencil2d", "dia"),
                                       ("stencil3d", "dia"),
                                       ("fem", "dia"),
                                       ("block_dense", "bsr"),
                                       ("permuted_band", "band_perm")])
def test_chooser_kind_matches_jax_with_gates_forced(name, kind, monkeypatch):
    """The JAX TPU gate and the port's CUDA probe both forced on: the
    structured kinds agree, and so do their results (the port's plain
    kernel versions against the interpret-mode Pallas kernels)."""
    monkeypatch.setattr(jplans, "_on_tpu", lambda: True)
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    a = MATRICES[name]()
    jk, jp = jplans.build_matvec_plan(a)
    tk, tp = tplans.build_matvec_plan(port_csr(a))
    assert tk == jk == kind
    x = gen.generate_vector(a.shape[1], seed=8)
    assert_rows_close(tplans.plan_spmv((tk, tp), torch.from_numpy(x)),
                      jplans.plan_spmv((jk, jp), jnp.asarray(x)), a, x)


def test_cuda_ladder_skips_unported_rungs(monkeypatch):
    """The CUDA ladder once skipped the BSR and RCM-band rungs by name;
    both are ported, so no rung is skipped now.  With the CUDA probe and
    JAX's TPU gate forced, every matrix takes JAX's kind for matvec and
    for matmul, the block-dense and permuted-band matrices included, and
    the structured plans serve both ops."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    monkeypatch.setattr(jplans, "_on_tpu", lambda: True)
    assert not hasattr(tplans, "UNPORTED_KINDS")
    kinds = set()
    for name, make in MATRICES.items():
        a = make()
        b = port_csr(a)
        for build in ("build_matvec_plan", "build_matmul_plan"):
            kind = getattr(tplans, build)(b)[0]
            assert kind == getattr(jplans, build)(a)[0], (name, build)
            kinds.add(kind)
    assert {"bsr", "band_perm", "band", "dia", "route", "sell"} <= kinds


GENERAL = {
    "uniform_f32": (lambda: gen.generate_csr(1500, 1500, 12_000, seed=23),
                    "route"),
    "uniform_c64": (lambda: gen.generate_csr(1500, 1500, 12_000, seed=24,
                                             complex_=True), "route_cx"),
    # the same f32 values held in float64 by the port
    "uniform_f64": (lambda: gen.generate_csr(1500, 1500, 12_000, seed=25),
                    "sell"),
    # hub fraction above 0.15: ROUTE v1
    "rmat": (lambda: gen.generate_rmat_csr(2048, 2048 * 16, seed=5),
             "route1"),
}


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_cuda_ladder_general_kinds(name, monkeypatch):
    """With the CUDA probe forced, the general rungs: f32 takes route,
    complex64 route_cx, hub-heavy rows route1, float64 SELL; each result
    matches JAX's base path."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    make, kind = GENERAL[name]
    a = make()
    b = port_csr(a)
    if name == "uniform_f64":
        b = dataclasses.replace(b, values=b.values.double())
    x = gen.generate_vector(a.shape[1], seed=26, complex_=b.dtype.is_complex)
    opt = tsp.matrix_opt(b)
    y = tsp.multiply(tsp.scaled(2.0, opt), torch.from_numpy(x))
    assert opt._plans["matvec"][0] == kind
    assert y.dtype == b.dtype
    want = sp.multiply(sp.scaled(2.0, a), jnp.asarray(x))
    assert_rows_close(y, want, a, x, scale=2.0)


def test_structured_kinds_are_shared_names():
    assert set(tplans.STRUCTURED_KINDS) == set(jplans.STRUCTURED_KINDS)
    assert {"band", "dia"} <= set(tplans.STRUCTURED_KINDS)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "dense"])
def test_base_paths_match_jax_with_padded_capacity(fmt):
    m, n, nnz = 300, 250, 2000
    x = gen.generate_vector(n, seed=9)
    if fmt == "csr":
        a = gen.generate_csr(m, n, nnz, seed=10, capacity=4096)
        b = port_csr(a)
        ref = a
    elif fmt == "csc":
        a = gen.generate_csc(m, n, nnz, seed=10, capacity=4096)
        b = tsp.CSC.from_arrays(np.asarray(a.values), np.asarray(a.colptr),
                                np.asarray(a.rowind), a.shape, nnz=nnz,
                                capacity=4096, device="cpu")
        ref = sp.to_csr(a)
    elif fmt == "coo":
        a = gen.generate_coo(m, n, nnz, seed=10, capacity=4096)
        b = tsp.COO.from_arrays(np.asarray(a.values), np.asarray(a.rowind),
                                np.asarray(a.colind), a.shape, nnz=nnz,
                                capacity=4096, device="cpu")
        ref = sp.to_csr(a)
    else:
        ref = gen.generate_csr(m, n, nnz, seed=10)
        a = ref.todense()
        b = torch.from_numpy(np.array(a))
    y_jax = sp.spmv(sp.scaled(2.0, a), jnp.asarray(x))
    y_port = tsp.spmv(tsp.scaled(2.0, b), torch.from_numpy(x))
    assert_rows_close(y_port, y_jax, ref, x, scale=2.0)


def test_conjugated_complex_matches_jax():
    a = gen.generate_csr(200, 150, 900, seed=11, complex_=True)
    x = gen.generate_vector(150, seed=12, complex_=True)
    b = port_csr(a)
    alpha = 0.5 - 1.5j
    y_jax = sp.multiply(sp.scaled(alpha, sp.conjugated(sp.matrix_opt(a))),
                        sp.conjugated(jnp.asarray(x)))
    y_port = tsp.multiply(
        tsp.scaled(alpha, tsp.conjugated(tsp.matrix_opt(b))),
        tsp.conjugated(torch.from_numpy(x)))
    assert y_port.dtype == torch.complex64
    assert_rows_close(y_port, y_jax, a, x, scale=abs(alpha))


def test_transposed_csr_matches_jax():
    a = gen.generate_csr(220, 180, 1500, seed=13)
    x = gen.generate_vector(220, seed=14)
    y_jax = sp.multiply(sp.transposed(sp.matrix_opt(a)), jnp.asarray(x))
    y_port = tsp.multiply(tsp.transposed(tsp.matrix_opt(port_csr(a))),
                          torch.from_numpy(x))
    at = sp.to_csr(sp.transposed(a))
    assert_rows_close(y_port, y_jax, at, x)


def test_f64_operand_takes_the_dtype_preserving_path(monkeypatch):
    """A float64 x on a band plan takes the base path in float64."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    a = MATRICES["banded"]()
    x = gen.generate_vector(2000, seed=15, dtype=np.float64)
    opt = tsp.matrix_opt(port_csr(a))
    y = tsp.multiply(opt, torch.from_numpy(x))
    assert opt._plans["matvec"][0] == "band" and y.dtype == torch.float64
    dense = np.asarray(a.todense()).astype(np.float64)
    assert_rows_close(y, dense @ x, a, x, eps=np.finfo(np.float64).eps)


def test_dimension_mismatch_raises():
    a = port_csr(gen.generate_csr(30, 40, 100, seed=16))
    with pytest.raises(ValueError, match="dimension mismatch"):
        tsp.multiply(a, torch.zeros(30))
    with pytest.raises(ValueError, match="dimension mismatch"):
        tsp.multiply(tsp.matrix_opt(a), torch.zeros(41))


def test_not_ported_ops_raise_with_roadmap_item(monkeypatch):
    """Nothing on the multiply surface raises as unported any more:
    SpGEMM (item 10), SpMM and dense·sparse (item 9) run, and the ROUTE
    v1 SpGEMM engine (``SPBLAS_ROUTE_SPGEMM=1``) is built at
    compute time and its fill matches JAX."""
    from spblas_tpu_torch.kernels.route_mul import RouteMulPlan
    ja = gen.generate_csr(30, 30, 100, seed=17)
    a = port_csr(ja)
    c = tsp.multiply(a, a)
    assert isinstance(c, tsp.CSR) and c.shape == (30, 30)
    assert_spgemm_close(c, sp.multiply(ja, ja), abs_spgemm(ja, ja))
    assert tsp.multiply_compute(a, a).result_nnz == c.nnz
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    monkeypatch.setenv("SPBLAS_ROUTE_SPGEMM", "1")
    info = tsp.multiply_compute(a, a)
    assert isinstance(info.plan.route, RouteMulPlan)
    c1 = tsp.multiply_fill(info, tsp.scaled(2.0, a), a)
    assert c1.nnz == info.result_nnz == c.nnz
    assert_spgemm_close(c1, sp.multiply(sp.scaled(2.0, ja), ja),
                        abs_spgemm(ja, ja, alpha=2.0))
    assert tsp.multiply(a, torch.zeros(30, 4)).shape == (30, 4)
    assert tsp.multiply(torch.zeros(4, 30), a).shape == (4, 30)


def test_two_phase_protocol_matches_jax():
    a = gen.generate_csr(64, 48, 300, seed=18)
    x = gen.generate_vector(48, seed=19)
    b = port_csr(a)
    ji = sp.multiply_compute(a, jnp.asarray(x))
    ti = tsp.multiply_compute(b, torch.from_numpy(x))
    assert ti.result_shape == ji.result_shape == (64,)
    assert tsp.multiply_inspect(b, torch.zeros(48, 3)).result_shape == \
        (64, 3)
    y = tsp.multiply_fill(ti, b, torch.from_numpy(x))
    assert_rows_close(y, sp.multiply_fill(ji, a, jnp.asarray(x)), a, x)


def test_debug_validation(monkeypatch):
    a = port_csr(gen.generate_csr(30, 30, 100, seed=20))
    a.colind[3] = 99        # out of range, behind the constructor's back
    monkeypatch.setenv("SPBLAS_DEBUG", "1")
    with pytest.raises(ValueError, match="colind out of range"):
        tsp.multiply(a, torch.zeros(30))


@pytest.mark.parametrize("name", ["banded", "stencil2d", "uniform"])
def test_grad_through_x_matches_jax(name):
    """x.requires_grad sends the optimized matrix to the differentiable
    base path; the gradient matches jax.grad."""
    a = MATRICES[name]()
    x = gen.generate_vector(a.shape[1], seed=21)
    w = gen.generate_vector(a.shape[0], seed=22)

    def loss_jax(xj):
        return jnp.sum(_main_path_jax(a, xj) * jnp.asarray(w))

    # jit: one compile in place of one per primitive of the eager trace
    g_jax = jax.jit(jax.grad(loss_jax))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    opt = tsp.matrix_opt(port_csr(a))
    y = tsp.multiply(tsp.scaled(2.0, opt), xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert opt._plans == {}          # no plan was built or run
    # dx = 2 A^T w: row j of A^T against |w|
    assert_rows_close(xt.grad, g_jax, sp.to_csr(sp.transposed(a)), w,
                      scale=2.0)

"""spblas_tpu_torch SpMV end to end against the JAX package: the main
path ``multiply(scaled(2.0, matrix_opt(A)), x)``, the plan chooser, the
base paths, errors and gradients, on the same seeded numpy inputs."""

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
    assert_rows_close, port_csr, one_torch_thread)

MATRICES = {
    "banded": lambda: gen.generate_banded_csr(2000, 2000, 17, seed=1),
    "banded_rect": lambda: gen.generate_banded_csr(1500, 2100, 12, seed=2),
    "stencil2d": lambda: gen.generate_stencil_csr((60, 60), seed=3),
    "stencil3d": lambda: gen.generate_stencil_csr((12, 13, 14), seed=4),
    "fem": lambda: gen.generate_fem_graph_csr(30, 120, seed=5),
    "uniform": lambda: gen.generate_csr(1200, 1200, 9600, seed=6),
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
                                       ("fem", "dia")])
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
    """With the CUDA probe forced, a general matrix skips the ROUTE/BSR/
    RCM rungs by name and lands on SELL, no matrix gets an unported
    kind, and plan_spmv has no path for one."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    kinds = {name: tplans.build_matvec_plan(port_csr(make()))[0]
             for name, make in MATRICES.items()}
    assert kinds["uniform"] == "sell"
    assert not set(kinds.values()) & set(tplans.UNPORTED_KINDS)
    for k in tplans.UNPORTED_KINDS:
        with pytest.raises(ValueError, match="unknown plan kind"):
            tplans.plan_spmv((k, None), torch.zeros(3))


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


def test_not_ported_ops_raise_with_roadmap_item():
    a = port_csr(gen.generate_csr(30, 30, 100, seed=17))
    with pytest.raises(NotImplementedError, match="item 9"):
        tsp.multiply(a, torch.zeros(30, 4))
    with pytest.raises(NotImplementedError, match="item 10"):
        tsp.multiply(a, a)
    with pytest.raises(NotImplementedError, match="item 10"):
        tsp.multiply_compute(a, a)
    with pytest.raises(NotImplementedError, match="item 9"):
        tsp.multiply(torch.zeros(4, 30), a)


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

"""spblas_tpu_torch.solvers held to spblas_tpu.solvers on the same seeded
numpy inputs (the four cases of tests/test_solvers.py), the JAX side
under ``jax.jit``.

Tolerances: both ``cg`` runs stop at ||r|| <= tol ||b|| (tol 1e-6, f32),
so on these SPD operators (eigenvalues in [1.6, 2.4]) their iterates
agree within 1e-5 of max |x|, and their iteration counts within one
step (the two packages sum in different orders, so the counts are not
compared bit for bit); ``jacobi`` runs a fixed count of contractions, so
its iterates agree within 1e-5 of max |x|; ``power_method`` draws v0
from different generators, so the eigenvalues are compared (1e-3
relative, as the JAX test holds it to float64) and each eigenpair's
residual ||Av - lam v||.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spblas_tpu import solvers as jsolvers
from spblas_tpu.formats.csr import CSR as JaxCSR

import spblas_tpu_torch as tsp
from spblas_tpu_torch import solvers

from tests.torch_util import one_torch_thread, port_csr  # noqa: F401


def _spd_banded(m, seed=0):
    """SPD tridiagonal-ish: 2I + band/4 symmetric (tests/test_solvers.py)."""
    rng = np.random.default_rng(seed)
    off = rng.uniform(0.05, 0.2, m - 1).astype(np.float32)
    dense = np.diag(np.full(m, 2.0, np.float32))
    dense += np.diag(off, 1) + np.diag(off, -1)
    return dense


def _pair(dense):
    a = JaxCSR.from_dense(dense)
    return a, port_csr(a)


@pytest.mark.parametrize("opt", [False, True], ids=["csr", "matrix_opt"])
def test_cg_solves_spd(opt):
    m = 200
    dense = _spd_banded(m)
    ja, ta = _pair(dense)
    b = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    jres = jax.jit(lambda v: jsolvers.cg(ja, v, tol=1e-6, maxiter=500))(
        jnp.asarray(b))
    op = tsp.matrix_opt(ta) if opt else ta
    tres = solvers.cg(op, torch.from_numpy(b), tol=1e-6, maxiter=500)
    x = tres.x.numpy()
    assert np.abs(dense @ x - b).max() < 1e-3
    assert int(tres.iterations) < 500
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    jx = np.asarray(jres.x)
    assert np.abs(x - jx).max() <= 1e-5 * np.abs(jx).max()
    np.testing.assert_allclose(float(tres.residual_norm),
                               float(jres.residual_norm), rtol=0.5)


def test_cg_with_matvec_callable():
    m = 100
    dense = _spd_banded(m, seed=2)
    b = np.ones(m, np.float32)
    jres = jsolvers.cg(lambda v: jnp.asarray(dense) @ v, jnp.asarray(b),
                       tol=1e-6)
    td = torch.from_numpy(dense)
    tres = solvers.cg(lambda v: td @ v, torch.from_numpy(b), tol=1e-6)
    assert np.abs(dense @ tres.x.numpy() - b).max() < 1e-3
    jx = np.asarray(jres.x)
    assert np.abs(tres.x.numpy() - jx).max() <= 1e-5 * np.abs(jx).max()


def test_power_method_dominant_eigenvalue():
    m = 120
    dense = _spd_banded(m, seed=3)
    ja, ta = _pair(dense)
    jres = jax.jit(lambda: jsolvers.power_method(ja, m, iters=300))()
    tres = solvers.power_method(ta, m, iters=300)
    lam_true = np.linalg.eigvalsh(dense.astype(np.float64)).max()
    lam = float(tres.eigenvalue)
    np.testing.assert_allclose(lam, lam_true, rtol=1e-3)
    np.testing.assert_allclose(lam, float(jres.eigenvalue), rtol=1e-3)
    v = tres.eigenvector.numpy().astype(np.float64)
    jv = np.asarray(jres.eigenvector).astype(np.float64)
    assert abs(np.linalg.norm(v) - 1) < 1e-5
    res = np.linalg.norm(dense @ v - lam * v)
    jres_n = np.linalg.norm(dense @ jv - float(jres.eigenvalue) * jv)
    assert res <= 2 * jres_n + 1e-4
    # the carry keeps the operator's dtype, and a seeded generator
    # gives the same pair again
    g = torch.Generator().manual_seed(0)
    again = solvers.power_method(ta, m, iters=300, generator=g)
    assert again.eigenvector.dtype == torch.float32
    assert torch.equal(again.eigenvector, tres.eigenvector)


def test_jacobi_reduces_residual():
    m = 150
    dense = _spd_banded(m, seed=4)
    ja, ta = _pair(dense)
    b = np.random.default_rng(5).standard_normal(m).astype(np.float32)
    diag = np.diag(dense).copy()
    jx = np.asarray(jax.jit(lambda v, d: jsolvers.jacobi(
        ja, v, d, iters=200, omega=0.9))(jnp.asarray(b), jnp.asarray(diag)))
    x = solvers.jacobi(tsp.matrix_opt(ta), torch.from_numpy(b),
                       torch.from_numpy(diag), iters=200,
                       omega=0.9).numpy()
    r0 = np.abs(b).max()
    assert np.abs(dense @ x - b).max() < 1e-3 * r0
    assert np.abs(x - jx).max() <= 1e-5 * np.abs(jx).max()


@pytest.mark.parametrize("tol, maxiter", [(1e-30, 100), (1e-6, 500)],
                         ids=["to_maxiter", "converged"])
def test_cg_reads_the_flag_once_per_32_iterations(monkeypatch, tol,
                                                  maxiter):
    """The convergence flag reaches the host once every CHECK_EVERY
    iterations at most, and ``iterations`` is what a loop that tests
    every step returns."""
    m = 200
    dense = _spd_banded(m, seed=6)
    _, ta = _pair(dense)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(m)
                         .astype(np.float32))
    reads = []
    real = solvers._host_flag
    monkeypatch.setattr(solvers, "_host_flag",
                        lambda f: reads.append(1) or real(f))
    res = solvers.cg(ta, b, tol=tol, maxiter=maxiter)
    k = int(res.iterations)
    assert len(reads) <= math.ceil(maxiter / solvers.CHECK_EVERY)
    assert len(reads) == min(math.ceil(maxiter / solvers.CHECK_EVERY),
                             math.ceil(k / solvers.CHECK_EVERY) + 1)
    # the loop that tests every step
    mv = lambda v: tsp.spmv(ta, v)   # noqa: E731
    x = torch.zeros_like(b)
    r = b - mv(x)
    p = r
    rs = torch.vdot(r, r).real
    tol2 = torch.tensor(tol) ** 2 * torch.vdot(b, b).real
    want = 0
    while bool(rs > tol2) and want < maxiter:
        ap = mv(p)
        alpha = rs / torch.vdot(p, ap).real
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.vdot(r, r).real
        p = r + (rs_new / rs) * p
        rs = rs_new
        want += 1
    assert k == want
    assert torch.equal(res.x, x)


def test_cg_f64_and_complex_operators():
    """Float64 and complex128 operators iterate in their own dtype, with
    vdot(...).real as JAX's do."""
    m = 80
    dense = _spd_banded(m, seed=8).astype(np.float64)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(m)
    a64 = tsp.CSR.from_dense(dense, device="cpu")
    res = solvers.cg(a64, torch.from_numpy(b), tol=1e-12, maxiter=200)
    assert res.x.dtype == torch.float64
    np.testing.assert_allclose(dense @ res.x.numpy(), b, atol=1e-9)
    herm = dense + 1j * (np.triu(dense, 1) - np.tril(dense, -1)) * 0.1
    bc = b + 1j * rng.standard_normal(m)
    ac = tsp.CSR.from_dense(herm, device="cpu")
    res = solvers.cg(ac, torch.from_numpy(bc), tol=1e-12, maxiter=200)
    assert res.x.dtype == torch.complex128
    np.testing.assert_allclose(herm @ res.x.numpy(), bc, atol=1e-9)

"""spblas_tpu_torch's ``band_spmv_ad`` held to ``jax.grad`` of the JAX
package's ``band_spmv_ad`` (the Pallas band kernel with its custom VJP,
run in interpret mode on the CPU) on bit-equal band plans, f32 and bf16
panels.

Both losses are sum(w * y) for one seeded w, so both backward passes
start from the same dy = w.  Tolerances: dx = A^T w sums each column's
products in a different order in the two packages, so per entry
|dx - dx_jax|_j <= 64 eps_f32 (|A|^T |w|)_j; d(panels)[g, c] = w[g] *
xp[(g // 128) * 128 + c] is one f32 product (then cast to the panels'
dtype) in both, so it is bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spblas_tpu.kernels import banded as jbanded
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import band_spmv_ad, banded
from spblas_tpu_torch.utils import interop

from tests.torch_util import EPS32, one_torch_thread, port_csr  # noqa: F401

M = 300


def _loss(plan, x, w):
    return jnp.sum(jbanded.band_spmv_ad(plan, x) * w)


_jax_grad = jax.jit(jax.grad(_loss, argnums=(0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_spmv_ad_matches_jax_grad(dtype):
    a = gen.generate_banded_csr(M, M, 11, seed=0)
    jplan = jbanded.build_band_plan(
        a, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(M).astype(np.float32)
    w = rng.standard_normal(M).astype(np.float32)
    gplan, gx = _jax_grad(jplan, jnp.asarray(x), jnp.asarray(w))
    tplan = interop.band_plan_from_numpy(np.asarray(jplan.panels),
                                         jplan.pad_l, jplan.shape,
                                         device="cpu")
    panels = tplan.panels.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = band_spmv_ad(dataclasses.replace(tplan, panels=panels), xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert panels.grad.dtype == panels.dtype
    assert torch.equal(panels.grad, interop.band_plan_from_numpy(
        np.asarray(gplan.panels), jplan.pad_l, jplan.shape,
        device="cpu").panels)
    # A's values as the panels hold them (bf16 rounds them)
    dense = torch.from_numpy(np.asarray(a.todense())).to(
        panels.dtype).double().numpy()
    bound = 64 * EPS32 * (np.abs(dense).T @ np.abs(w))
    err = np.abs(xt.grad.numpy().astype(np.float64) - np.asarray(gx))
    assert (err <= bound).all(), float((err - bound).max())


def test_band_spmv_ad_forward_is_the_kernel_and_grads_are_optional(
        monkeypatch):
    """The forward runs the band kernel's wrapper (its plain version on
    the CPU); x alone, or the panels alone, may require grad."""
    a = gen.generate_banded_csr(M, M, 11, seed=2)
    plan = banded.build_band_plan(port_csr(a))
    calls = []
    real = banded.band_spmv_padded
    monkeypatch.setattr(banded, "band_spmv_padded",
                        lambda *p: calls.append(1) or real(*p))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(M)
                         .astype(np.float32))
    y = band_spmv_ad(plan, x)
    assert calls == [1]
    assert torch.equal(y, banded.band_spmv(plan, x))
    xg = x.clone().requires_grad_(True)
    band_spmv_ad(plan, xg).sum().backward()
    dense = np.asarray(a.todense()).astype(np.float64)
    np.testing.assert_allclose(xg.grad.numpy(), dense.sum(0), rtol=1e-5,
                               atol=1e-5)
    pg = plan.panels.clone().requires_grad_(True)
    band_spmv_ad(dataclasses.replace(plan, panels=pg), x).sum().backward()
    i, j = 5, 7
    c = j - (i // 128) * 128 + plan.pad_l
    assert float(pg.grad[i, c]) == float(x[j])


def test_grad_through_matrix_opt_takes_the_base_path(monkeypatch):
    """An x that requires grad takes the differentiable base path past a
    cached plan (``plans.transform_safe``; this narrow band takes
    ``dia``), as in the JAX package; the gradient is A^T (dL/dy)."""
    from spblas_tpu_torch.kernels import plans
    a = gen.generate_banded_csr(M, M, 11, seed=4)
    opt = tsp.matrix_opt(port_csr(a))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(M)
                         .astype(np.float32))
    tsp.multiply(opt, x)
    assert opt._plans["matvec"][0] == "dia"
    monkeypatch.setattr(plans, "plan_spmv", lambda *p: pytest.fail(
        "the plan path ran under grad"))
    xg = x.clone().requires_grad_(True)
    (tsp.multiply(opt, xg) ** 2).sum().backward()
    dense = np.asarray(a.todense()).astype(np.float64)
    want = 2 * dense.T @ (dense @ x.numpy().astype(np.float64))
    np.testing.assert_allclose(xg.grad.numpy(), want, rtol=1e-4, atol=1e-3)

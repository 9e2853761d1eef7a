"""spblas_tpu_torch DIA plan and SpMV against the JAX package: bit-equal
plans, the fused kernel's plain version against ``_dia_spmv_pallas`` in
interpret mode, and the torch-op chain against the JAX chain; the
in-place kernel's plain version (x read in place, m rows) against the
padded one's bits, and its operand checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spblas_tpu.kernels import dia as jdia
from spblas_tpu.utils import generate as gen

from spblas_tpu_torch.kernels import dia as tdia
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    assert_rows_close, port_csr, one_torch_thread)

MATRICES = {
    "stencil2d": lambda: gen.generate_stencil_csr((40, 50), seed=1),
    "stencil3d": lambda: gen.generate_stencil_csr((9, 10, 11), seed=2),
    "banded": lambda: gen.generate_banded_csr(3000, 3000, 9, seed=3),
    "fem": lambda: gen.generate_fem_graph_csr(20, 30, seed=4),
    # wide rectangle: n far beyond the padded rows
    "wide": lambda: gen.generate_banded_csr(500, 40_000, 7, seed=5),
    "tall": lambda: gen.generate_banded_csr(2500, 900, 5, seed=6),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_build_dia_plan_bit_equal(name):
    a = MATRICES[name]()
    jp = jdia.build_dia_plan(a)
    tp = tdia.build_dia_plan(port_csr(a))
    assert tp.offsets == jp.offsets and tp.shape == jp.shape
    assert tuple(tp.diags.shape) == tuple(jp.diags.shape)
    np.testing.assert_array_equal(tp.diags.numpy().view(np.int32),
                                  np.asarray(jp.diags).view(np.int32))
    assert tdia.dia_fill_fraction(port_csr(a)) == jdia.dia_fill_fraction(a)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_plain_matches_pallas_interpret(name):
    """The port's plain fused DIA on the JAX plan's own diagonals against
    ``_dia_spmv_pallas`` (interpret mode on the CPU)."""
    a = MATRICES[name]()
    jp = jdia.build_dia_plan(a)
    tp = interop.dia_plan_from_numpy(np.asarray(jp.diags), jp.offsets,
                                     jp.shape, device="cpu")
    x = gen.generate_vector(a.shape[1], seed=7)
    y_jax = jdia._dia_spmv_pallas(jp, jnp.asarray(x))
    y_port = tdia.dia_spmv_fused(tp, torch.from_numpy(x))
    assert y_port.dtype == torch.float32 and y_port.shape == (a.shape[0],)
    assert_rows_close(y_port, y_jax, a, x)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_chain_matches_jax(name):
    """Off the kernel gate (here: a CPU tensor) both run the shift chain."""
    a = MATRICES[name]()
    tp = tdia.build_dia_plan(port_csr(a))
    x = gen.generate_vector(a.shape[1], seed=8)
    y_jax = jdia.dia_spmv(jdia.build_dia_plan(a), jnp.asarray(x))
    y_port = tdia.dia_spmv(tp, torch.from_numpy(x))
    assert_rows_close(y_port, y_jax, a, x)


def test_pad_x_matches_jax_padding():
    """x2 has the JAX wrapper's length and layout: pad_lo zeros, x, then
    zeros to a whole number of 128-lane rows past the last shifted read."""
    a = gen.generate_stencil_csr((40, 50), seed=1)
    tp = tdia.build_dia_plan(port_csr(a))
    x = torch.arange(1, 2001, dtype=torch.float32)
    x2, pad_lo = tdia.pad_x(tp, x)
    assert pad_lo == 50
    rows_out = tp.diags.shape[1]
    max_q = (50 + 50) // 128
    assert x2.shape[0] == (rows_out + max_q + 256 + 8) * 128
    assert (x2[:50] == 0).all() and (x2[2050:] == 0).all()
    assert torch.equal(x2[50:2050], x)


def test_kernel_gate_matches_jax_conditions(monkeypatch):
    """The JAX gate (dia.py:104-111) with the card in place of the TPU."""
    a = gen.generate_stencil_csr((30, 30), seed=9)
    p32 = tdia.build_dia_plan(port_csr(a))
    x = torch.zeros(900)
    assert not tdia._kernel_gate(p32, x)          # CPU tensor: chain
    monkeypatch.setattr(tdia._t, "on_cuda", lambda t: True)
    assert tdia._kernel_gate(p32, x)
    assert tdia._kernel_gate(p32, x.bfloat16())
    assert not tdia._kernel_gate(p32, x.double())
    p64 = tdia.DiaPlan(p32.diags.double(), p32.offsets, p32.shape)
    assert not tdia._kernel_gate(p64, x)
    many = tdia.DiaPlan(torch.zeros(33, 256, 128), tuple(range(33)),
                        (900, 900))
    assert not tdia._kernel_gate(many, x)
    far = tdia.DiaPlan(torch.zeros(1, 256, 128), (2_500_001 - 900,),
                       (900, 900))
    assert not tdia._kernel_gate(far, x)


@pytest.mark.parametrize("bad", ["dtype", "offsets", "short", "shape"])
def test_dia_wrapper_rejects_bad_operands(bad):
    a = gen.generate_stencil_csr((20, 20), seed=10)
    plan = tdia.build_dia_plan(port_csr(a))
    x2, pad_lo = tdia.pad_x(plan, torch.zeros(400))
    if bad == "dtype":
        x2 = x2.double()
    elif bad == "offsets":
        plan = tdia.DiaPlan(plan.diags, plan.offsets[:-1], plan.shape)
    elif bad == "short":
        x2 = x2[: plan.diags.shape[1] * 128]
    else:
        plan = tdia.DiaPlan(plan.diags.reshape(plan.ndiag, -1, 64),
                            plan.offsets, plan.shape)
    with pytest.raises((TypeError, ValueError)):
        tdia.dia_spmv_padded(plan, x2, pad_lo)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_inplace_reference_is_padded_reference(name, dtype):
    """The in-place kernel's plain version gives the padded one's bits
    over ``pad_x``, cut to m rows, x in f32 and in bf16; the gated path
    returns it in x's dtype and launches nothing on the CPU."""
    a = MATRICES[name]()
    plan = tdia.build_dia_plan(port_csr(a))
    x = torch.from_numpy(gen.generate_vector(a.shape[1], seed=11)).to(dtype)
    m = a.shape[0]
    want = tdia.dia_spmv_reference(plan.diags, plan.offsets,
                                   *tdia.pad_x(plan, x))[:m]
    got = tdia.dia_spmv_inplace_reference(plan, x)
    assert got.dtype == torch.float32 and got.shape == (m,)
    assert torch.equal(got, want)
    before = tdia.dia_spmv_padded.launches
    assert torch.equal(tdia.dia_spmv_inplace(plan, x), want)
    fused = tdia.dia_spmv_fused(plan, x)
    assert tdia.dia_spmv_padded.launches == before
    assert fused.dtype == dtype and torch.equal(fused, want.to(dtype))


@pytest.mark.parametrize("bad", ["x_dtype", "x_short", "diags_dtype",
                                 "too_many", "strided", "offsets"])
def test_dia_inplace_rejects_bad_operands(bad):
    a = gen.generate_stencil_csr((20, 20), seed=10)
    plan = tdia.build_dia_plan(port_csr(a))
    x = torch.zeros(400)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "x_short":
        x = x[:-1]
    elif bad == "diags_dtype":
        plan = tdia.DiaPlan(plan.diags.double(), plan.offsets, plan.shape)
    elif bad == "too_many":
        plan = tdia.DiaPlan(torch.zeros(33, 256, 128), tuple(range(33)),
                            (400, 400))
    elif bad == "strided":
        x = torch.zeros(800)[::2]
    else:
        plan = tdia.DiaPlan(plan.diags, plan.offsets[:-1], plan.shape)
    with pytest.raises((TypeError, ValueError)):
        tdia.dia_spmv_inplace(plan, x)

"""The band SpMM forms that read B in place, against the JAX package on
the same seeded numpy inputs: the resident kernel's offset read (pad_l
> 0, B's rows below and above the window length L), its row index (the
permuted band), the complex pass over both planes of a complex band
(complex and real B), bf16 panels, and the plan paths that reach them
in one launch with no padded or gathered copy of B.  On the CPU the
wrappers run their plain versions, which these tests hold.

Tolerance: per entry 64 * eps_f32 * (|A| . |B|) (``tests/torch_util.py``),
since the two packages sum in different orders."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spblas_tpu.kernels import banded as jbanded
from spblas_tpu.kernels import plans as jplans
from spblas_tpu.utils import generate as gen

from spblas_tpu_torch.kernels import banded as tbanded
from spblas_tpu_torch.kernels import plans as tplans

from tests.torch_util import (  # noqa: F401
    assert_entries_close, one_torch_thread, permuted_csr, port_csr, to_np)

# (m, n, bandwidth): n below the window length L (700 < 800) and above
# it (1,200 > 1,056), both with pad_l 15
OFFSET_CASES = {"n_below_L": (700, 700), "n_above_L": (300, 1200)}


def _dense(n, k, seed, complex_=False):
    return gen.generate_dense(n, k, seed=seed, complex_=complex_)


def _complex_band():
    """A banded JAX CSR with complex64 values from two seeded f32 value
    sets over the same structure (``test_torch_spmm``'s band_cx matrix)."""
    a = gen.generate_banded_csr(900, 1000, 15, seed=5)
    imag = gen.generate_banded_csr(900, 1000, 15, seed=6).values
    return dataclasses.replace(a, values=(a.values + 1j * imag).astype(
        jnp.complex64))


def _permuted():
    return permuted_csr(gen.generate_banded_csr(1500, 1500, 21, seed=2),
                        seed=3)


@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_offset_read_matches_jax(case):
    """B read in place at pad_l > 0 equals JAX's padded (or trimmed) B
    product, and the padded form's bits."""
    m, n = OFFSET_CASES[case]
    a = gen.generate_banded_csr(m, n, 31, seed=40)
    jplan = jbanded.build_band_plan(a)
    tplan = tbanded.build_band_plan(port_csr(a))
    rows, w = tplan.panels.shape
    assert tplan.pad_l == 15 and (n < rows - 128 + w) == (case == "n_below_L")
    b = _dense(n, 6, seed=41)
    c = tbanded.band_spmm_inplace(tplan.panels, torch.from_numpy(b),
                                  tplan.pad_l, m)
    assert c.shape == (m, 6) and c.dtype == torch.float32
    padded = tbanded.band_spmm_padded(
        tplan.panels, tbanded.pad_b(tplan, torch.from_numpy(b)))[:m]
    np.testing.assert_array_equal(to_np(c), to_np(padded))
    assert_entries_close(c, jbanded.band_spmm(jplan, jnp.asarray(b),
                                              interpret=True), a, b)


def test_bf16_panels_offset_read_matches_jax():
    m, n = OFFSET_CASES["n_below_L"]
    a = gen.generate_banded_csr(m, n, 31, seed=40)
    jplan = jbanded.build_band_plan(a, dtype=jnp.bfloat16)
    tplan = tbanded.build_band_plan(port_csr(a), dtype=torch.bfloat16)
    b = _dense(n, 6, seed=42)
    c = tbanded.band_spmm(tplan, torch.from_numpy(b))
    want = jbanded.band_spmm(jplan, jnp.asarray(b), interpret=True)
    # both sides multiply the same bf16 panel values in f32
    ref = dataclasses.replace(a, values=jnp.asarray(
        np.asarray(a.values).astype(jnp.bfloat16).astype(np.float32)))
    assert_entries_close(c, want, ref, b)


def test_row_index_matches_jax_plan_spmm():
    """The permuted band's gather of B and scatter of C through perm, on
    the resident form, against JAX's ``plan_spmm`` on band_perm."""
    a = _permuted()
    jp = jbanded.build_permuted_band_plan(a)
    tp = tbanded.build_permuted_band_plan(port_csr(a))
    b = _dense(a.shape[1], 5, seed=43)
    c = tbanded.band_spmm_inplace(tp.band.panels, torch.from_numpy(b),
                                  tp.band.pad_l, a.shape[0], perm=tp.perm)
    assert c.shape == (a.shape[0], 5)
    assert_entries_close(c, jplans.plan_spmm(("band_perm", jp),
                                             jnp.asarray(b)), a, b)


@pytest.mark.parametrize("b_kind", ["complex", "real"])
def test_complex_pass_matches_jax(b_kind):
    """One pass over both planes against JAX's four real products, with
    a complex64 B and with a real one."""
    a = _complex_band()
    jp = jplans._build_band_cx(a)
    a_t = port_csr(a)
    tp = tplans._build_band_cx(a_t)
    cx = b_kind == "complex"
    b = _dense(a.shape[1], 4, seed=44, complex_=cx)
    c = tbanded.band_spmm_cx(tp[0].panels, tp[1].panels, torch.from_numpy(b),
                             tp[0].pad_l, a.shape[0])
    assert c.dtype == torch.complex64 and c.shape == (a.shape[0], 4)
    assert_entries_close(c, jplans.band_cx_spmm(jp, jnp.asarray(b)), a, b)


@pytest.mark.parametrize("kind", ["band", "band_perm", "band_cx"])
def test_plan_spmm_reads_b_in_place(kind, monkeypatch):
    """``plan_spmm`` on band, band_perm and band_cx reaches one call of
    the in-place wrapper (the complex pass for band_cx), and neither
    ``pad_b`` nor the permuted band's ``index_select`` gathers copy B."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    calls = []

    def spy(name, fn):
        return lambda *a, **kw: (calls.append(name), fn(*a, **kw))[1]

    def copy(*_):
        raise AssertionError("B copied before the kernel")

    monkeypatch.setattr(tbanded, "pad_b", copy)
    monkeypatch.setattr(tbanded, "_permuted_apply", copy)
    monkeypatch.setattr(tbanded, "band_spmm_inplace",
                        spy("inplace", tbanded.band_spmm_inplace))
    monkeypatch.setattr(tplans, "band_spmm_cx",
                        spy("cx", tbanded.band_spmm_cx))
    a = {"band": lambda: gen.generate_banded_csr(700, 700, 31, seed=40),
         "band_perm": _permuted, "band_cx": _complex_band}[kind]()
    plan = tplans.build_matmul_plan(port_csr(a))
    assert plan[0] == kind
    cx = kind == "band_cx"
    b = torch.from_numpy(_dense(a.shape[1], 3, seed=45, complex_=cx))
    c = tplans.plan_spmm(plan, b)
    assert calls == ["cx" if cx else "inplace"]
    assert c.shape == (a.shape[0], 3)


def test_inplace_forms_check_operands():
    panels = torch.zeros(256, 136)
    b = torch.zeros(200, 4)
    with pytest.raises(ValueError, match="perm must be"):
        tbanded.band_spmm_inplace(panels, b, 4, 200,
                                  perm=torch.arange(256))
    with pytest.raises(ValueError, match="m 300"):
        tbanded.band_spmm_inplace(panels, b, 4, 300)
    with pytest.raises(TypeError, match="b must be"):
        tbanded.band_spmm_stream_inplace(panels, b.double(), 4, 200)
    plan = tbanded.build_band_plan(port_csr(gen.generate_banded_csr(
        300, 300, 9, seed=46)))
    other = dataclasses.replace(plan, pad_l=plan.pad_l + 1)
    with pytest.raises(ValueError, match="band_cx planes differ"):
        tplans.band_cx_spmm((plan, other), torch.zeros(300, 1))

"""spblas_tpu_torch band-panel plan and SpMV against the JAX package:
bit-equal plans, and the kernel's plain version against the Pallas
kernel run in interpret mode on the same plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spblas_tpu.kernels import banded as jband
from spblas_tpu.utils import generate as gen

from spblas_tpu_torch.kernels import banded as tband
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    assert_rows_close, port_csr, to_np, one_torch_thread)

# (m, n, bandwidth): m not a multiple of 1024, n > m and n < m, odd and
# even half-bandwidths (half = bandwidth // 2)
SHAPES = [(1000, 1000, 18), (1100, 1500, 14), (2000, 1200, 22),
          (3000, 3000, 9)]


def _bits(a) -> np.ndarray:
    """Raw bits of a float32 or bfloat16 array, for exact comparison."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a.view(torch.int32)).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_build_band_plan_bit_equal(shape, bf16):
    m, n, bw = shape
    a = gen.generate_banded_csr(m, n, bw, seed=1)
    jp = jband.build_band_plan(a, dtype=jnp.bfloat16 if bf16 else None)
    tp = tband.build_band_plan(port_csr(a),
                               dtype=torch.bfloat16 if bf16 else None)
    assert tp.pad_l == jp.pad_l and tp.shape == jp.shape
    assert tuple(tp.panels.shape) == tuple(jp.panels.shape)
    np.testing.assert_array_equal(_bits(tp.panels), _bits(jp.panels))


def test_band_halfwidth_matches_jax():
    for m, n, bw in SHAPES:
        a = gen.generate_banded_csr(m, n, bw, seed=2)
        assert tband.band_halfwidth(port_csr(a)) == jband.band_halfwidth(a)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_band_plain_matches_pallas_interpret(shape, bf16):
    """The port's plain band SpMV on the JAX plan's own panels against
    ``band_spmv(..., interpret=True)``."""
    m, n, bw = shape
    a = gen.generate_banded_csr(m, n, bw, seed=3)
    jp = jband.build_band_plan(a, dtype=jnp.bfloat16 if bf16 else None)
    tp = interop.band_plan_from_numpy(np.asarray(jp.panels), jp.pad_l,
                                      jp.shape, device="cpu")
    x = gen.generate_vector(n, seed=4)
    y_jax = jband.band_spmv(jp, jnp.asarray(x), interpret=True)
    y_port = tband.band_spmv(tp, torch.from_numpy(x))
    assert y_port.dtype == torch.float32 and y_port.shape == (m,)
    # the error bound holds against the matrix as the panels store it
    a_ref = a if not bf16 else _bf16_values(a)
    assert_rows_close(y_port, y_jax, a_ref, x)


def _bf16_values(a):
    """``a`` with its values rounded to bfloat16, as bf16 panels hold
    them."""
    return a.update(a.values.astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("x_dtype", [np.float32, "bfloat16"])
def test_band_result_dtype_matches_jax(x_dtype):
    a = gen.generate_banded_csr(500, 500, 10, seed=5)
    jp = jband.build_band_plan(a)
    tp = tband.build_band_plan(port_csr(a))
    x = gen.generate_vector(500, seed=6)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if x_dtype == "bfloat16"
                                else torch.float32)
    y_jax = jband.band_spmv(jp, jx, interpret=True)
    y_port = tband.band_spmv(tp, tx)
    assert str(y_port.dtype).split(".")[-1] == str(y_jax.dtype)
    assert_rows_close(y_port, y_jax, a, to_np(tx))


def test_reference_is_the_padded_panel_sum():
    """band_spmv_reference against a loop over rows: y[r] = sum_c
    panels[r, c] * xp[(r // 128) * 128 + c]."""
    rng = np.random.default_rng(7)
    panels = rng.standard_normal((256, 140)).astype(np.float32)
    xp = rng.standard_normal(256 - 128 + 140).astype(np.float32)
    y = tband.band_spmv_reference(torch.from_numpy(panels),
                                  torch.from_numpy(xp)).numpy()
    want = np.array([panels[r].astype(np.float64)
                     @ xp[(r // 128) * 128:(r // 128) * 128 + 140]
                     for r in range(256)])
    bound = 64 * np.finfo(np.float32).eps * np.array(
        [np.abs(panels[r]) @ np.abs(xp[(r // 128) * 128:(r // 128) * 128
                                       + 140]) for r in range(256)])
    assert (np.abs(y - want) <= bound).all()


@pytest.mark.parametrize("bad", ["xp_dtype", "panel_dtype", "xp_short",
                                 "rows", "device"])
def test_band_wrapper_rejects_bad_operands(bad):
    panels = torch.zeros(256, 136)
    xp = torch.zeros(256 - 128 + 136)
    if bad == "xp_dtype":
        xp = xp.double()
    elif bad == "panel_dtype":
        panels = panels.half()
    elif bad == "xp_short":
        xp = xp[:-1]
    elif bad == "rows":
        panels = panels[:200]
    else:
        panels = panels.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tband.band_spmv_padded(panels, xp)


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


@pytest.mark.parametrize("op", ["spmv", "power"])
@pytest.mark.parametrize("bf16", [False, True])
def test_band_wrappers_take_unaligned_views(op, bf16):
    """Panels and xp views off 16-byte alignment (on the card the row
    kernel then takes its one-element loads) pass the wrapper checks and
    give the numpy float64 panel sums within 64 eps (|A||x|) a row."""
    a = gen.generate_banded_csr(640, 640, 22, seed=7)
    tp = tband.build_band_plan(port_csr(a),
                               dtype=torch.bfloat16 if bf16 else None)
    x = np.random.default_rng(8).standard_normal(640).astype(np.float32)
    xp = tband.pad_x(tp, torch.from_numpy(x))
    panels = tp.panels.float().numpy().astype(np.float64)
    w, h = tp.width, tp.pad_l
    iters = 1 if op == "spmv" else 2

    def step(p, v):
        return np.array([p[r] @ v[r // 128 * 128:r // 128 * 128 + w]
                         for r in range(p.shape[0])])

    want = absd = xp.numpy().astype(np.float64)
    for _ in range(iters):
        y, ya = step(panels, want), step(np.abs(panels), np.abs(absd))
        want, absd = np.zeros_like(want), np.zeros_like(absd)
        want[h:h + len(y)], absd[h:h + len(y)] = y, ya
    if op == "spmv":
        got = tband.band_spmv_padded(_unaligned(tp.panels), _unaligned(xp))
        want, absd = want[h:h + len(got)], absd[h:h + len(got)]
    else:
        got = tband.band_power_padded(_unaligned(tp.panels),
                                      _unaligned(xp), iters, h)
    bound = iters * 64 * np.finfo(np.float32).eps * absd
    assert (np.abs(got.numpy() - want) <= bound).all()


def _diags(m, offsets, seed):
    """Seeded diagonals (U[0.1, 1) / (0.55 * ndiag), zero out of range),
    the bench's device band construction."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.1, 1.0, (len(offsets), m)) / (0.55 * len(offsets))
    i = np.arange(m)[None, :]
    o = np.asarray(offsets)[:, None]
    return np.where((i + o >= 0) & (i + o < m), d, 0).astype(np.float32)


@pytest.mark.parametrize("m,half,bf16", [(700, 11, False), (2000, 50, False),
                                         (1000, 7, True)])
def test_band_plan_from_diags_bit_equal(m, half, bf16):
    """The panels laid out from DIA storage are JAX's bit for bit, and
    ``build_band_plan``'s on the same matrix as a CSR (pad_l = h both)."""
    offsets = tuple(range(-half, half + 1))
    d = _diags(m, offsets, seed=m)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jp = jband.band_plan_from_diags(jnp.asarray(d), offsets, (m, m),
                                    dtype=jdt)
    tp = tband.band_plan_from_diags(torch.from_numpy(d), offsets, (m, m),
                                    dtype=tdt)
    assert tp.pad_l == jp.pad_l == half and tp.shape == jp.shape
    np.testing.assert_array_equal(_bits(tp.panels), _bits(jp.panels))
    rows = np.repeat(np.arange(m), len(offsets))
    cols = rows + np.tile(offsets, m)
    keep = (cols >= 0) & (cols < m)
    vals = d.T.reshape(-1)[keep]
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows[keep],
                                                        minlength=m))])
    a = interop.csr_from_numpy(vals, rowptr, cols[keep], len(vals), (m, m),
                               device="cpu")
    bp = tband.build_band_plan(a, dtype=tdt)
    assert bp.pad_l == tp.pad_l
    np.testing.assert_array_equal(_bits(bp.panels), _bits(tp.panels))


def test_band_power_iterations_matches_jax():
    """``tests/test_kernels.py``'s case (m 700, bandwidth 11, values /
    11, 5 iterations) through JAX's Pallas kernel in interpret mode and
    the port's plain version, rtol 1e-4, atol 1e-5."""
    import dataclasses
    a = gen.generate_banded_csr(700, 700, 11, seed=0)
    a = dataclasses.replace(a, values=a.values / jnp.float32(11.0))
    jp = jband.build_band_plan(a)
    tp = interop.band_plan_from_numpy(np.asarray(jp.panels), jp.pad_l,
                                      jp.shape, device="cpu")
    x = np.random.default_rng(1).standard_normal(700).astype(np.float32)
    want = np.asarray(jband.band_power_iterations(jp, jnp.asarray(x), 5,
                                                  interpret=True))
    before = tband.band_power_padded.launches
    got = tband.band_power_iterations(tp, torch.from_numpy(x), 5)
    assert tband.band_power_padded.launches == before   # plain: no launch
    assert got.dtype == torch.float32 and got.shape == (700,)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-4, atol=1e-5)
    # and five chained plain band SpMVs, exactly
    y = torch.from_numpy(x)
    for _ in range(5):
        y = tband.band_spmv(tp, y)
    np.testing.assert_array_equal(to_np(got), to_np(y))


def test_band_power_iterations_edge_cases():
    """``iters <= 0`` returns x itself; a non-square plan raises, as in
    JAX; bf16 panels give an f32 result."""
    a = gen.generate_banded_csr(300, 300, 6, seed=4)
    tp = tband.build_band_plan(port_csr(a))
    x = torch.ones(300)
    assert tband.band_power_iterations(tp, x, 0) is x
    assert tband.band_power_iterations(tp, x, -2) is x
    rect = tband.build_band_plan(port_csr(gen.generate_banded_csr(
        300, 400, 6, seed=5)))
    with pytest.raises(ValueError, match="square"):
        tband.band_power_iterations(rect, torch.ones(400), 3)
    bp = tband.build_band_plan(port_csr(a), dtype=torch.bfloat16)
    y = tband.band_power_iterations(bp, x, 2)
    assert y.dtype == torch.float32 and bool(y.isfinite().all())

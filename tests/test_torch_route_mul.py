"""spblas_tpu_torch ROUTE v1 SpGEMM engine (``route_mul``) against the
JAX package: bit-equal plans on the streams of ``tests/test_route_mul.py``
and the empty stream, the kernel's plain version against the JAX
package's exact numpy simulator (``route_mul_numpy``) and the scatter
reference ``np.add.at(out, slots, A[sa] * B[sb])``, the prefix's no-wrap
property, the plan's expansion stream and the slot fill's plain version
(the CUDA numeric), and the ``SPBLAS_ROUTE_SPGEMM=1`` product end to
end.

JAX's Pallas ``route_mul`` runs in interpret mode once, on a small plan.
Tolerance: per slot 64 * eps_f32 * sum |A[sa] * B[sb]| over the slot's
entries (``tests/torch_util.py``'s dot-product form), since the plain
versions' ``index_add_`` (and the CUDA slot fill's lanes) sum a slot in
another order than the sequential simulator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu.kernels import route_mul as jrm
from spblas_tpu.kernels.route_mul_kernel import route_mul as jax_route_mul
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import mul_fill as tmf
from spblas_tpu_torch.kernels import route_mul as trm
from spblas_tpu_torch.kernels import route_mul_kernel as tk
from spblas_tpu_torch.kernels.route_mul import RouteMulPlan
from spblas_tpu_torch.utils import interop

from tests.torch_util import (EPS32, abs_spgemm, assert_spgemm_close,
                              one_torch_thread, port_csr, to_np)  # noqa: F401

ARRAYS = ("tile1", "tile2", "tile3", "a_base", "b_base", "o_base")
STATIC = ("g_a", "g_b", "a_rows", "b_rows", "out_rows", "capacity", "fill")

# tests/test_route_mul.py's streams: (slots, mean duplicates, a_len, b_len)
STREAMS = {"small": (500, 2, 300, 400),
           "multi_window": (3000, 3, 5000, 9000),
           "no_dups": (5000, 0, 200, 200),
           "heavy_dups": (100, 40, 50, 60)}


def _stream(n_slots, dup, a_len, b_len):
    """The seeded slot-sorted stream and A, B values of the JAX test."""
    rng = np.random.default_rng(n_slots + dup)
    slots = np.repeat(np.arange(n_slots), rng.poisson(dup, n_slots) + 1)
    ne = len(slots)
    sa = rng.integers(0, a_len, ne)
    sb = rng.integers(0, b_len, ne)
    A = rng.standard_normal(a_len).astype(np.float32)
    B = rng.standard_normal(b_len).astype(np.float32)
    return slots, sa, sb, A, B


def _plans(name):
    n_slots, dup, a_len, b_len = STREAMS[name]
    slots, sa, sb, A, B = _stream(n_slots, dup, a_len, b_len)
    jp = jrm.build_route_mul_plan(slots, sa, sb, a_len, b_len, n_slots)
    tp = trm.build_route_mul_plan(slots, sa, sb, a_len, b_len, n_slots,
                                  device="cpu")
    return jp, tp, (slots, sa, sb, A, B, n_slots)


# STREAMS and a dup-heavy stream at more slots: 2,048 runs of about 41
# products (the slot fill's middle tier on the card)
FILL_STREAMS = dict(STREAMS, dup40=(2048, 40, 50, 60))


def _port_plan(name):
    n_slots, dup, a_len, b_len = FILL_STREAMS[name]
    slots, sa, sb, A, B = _stream(n_slots, dup, a_len, b_len)
    tp = trm.build_route_mul_plan(slots, sa, sb, a_len, b_len, n_slots,
                                  device="cpu")
    return tp, (slots, sa, sb, A, B, n_slots)


def _assert_slots_close(got, want, slots, sa, sb, A, B, cap, err_msg=""):
    """|got - want| per slot within 64 eps of the slot's sum of |A B|."""
    absdot = np.zeros(cap)
    np.add.at(absdot, slots, np.abs(A[sa].astype(np.float64) * B[sb]))
    err = np.abs(to_np(got).astype(np.float64)
                 - np.asarray(want, np.float64))
    bad = err > 64 * EPS32 * absdot
    assert not bad.any(), f"{err_msg}: {bad.sum()} slots out of bound"


def _scatter(slots, sa, sb, A, B, cap):
    out = np.zeros(cap, np.float64)
    np.add.at(out, slots, A[sa].astype(np.float64) * B[sb])
    return out


@pytest.mark.parametrize("name", list(STREAMS))
def test_plan_bit_equal_and_plain_matches_simulator(name):
    jp, tp, (slots, sa, sb, A, B, cap) = _plans(name)
    for f in ARRAYS:
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), f)
    for f in STATIC:
        assert getattr(tp, f) == getattr(jp, f), f
    sim = jrm.route_mul_numpy(jp, A, B)
    # the port's own copy of the simulator agrees with JAX's exactly
    np.testing.assert_array_equal(trm.route_mul_numpy(tp, A, B), sim)
    before = tmf.mul_fill.launches
    got = tk.route_mul(tp, torch.from_numpy(A), torch.from_numpy(B))
    assert tmf.mul_fill.launches == before    # plain: no launch
    assert got.shape == (cap,) and got.dtype == torch.float32
    _assert_slots_close(got, sim, slots, sa, sb, A, B, cap, name)
    _assert_slots_close(got, _scatter(slots, sa, sb, A, B, cap), slots, sa,
                        sb, A, B, cap, name)


def test_empty_stream():
    z = np.zeros(0, np.int64)
    jp = jrm.build_route_mul_plan(z, z, z, 10, 10, 16)
    tp = trm.build_route_mul_plan(z, z, z, 10, 10, 16, device="cpu")
    for f in ARRAYS:
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), f)
    assert tp.nchunks == 1 and tp.fill == jp.fill == 0.0
    out = tk.route_mul(tp, torch.ones(10), torch.ones(10))
    np.testing.assert_array_equal(to_np(out), np.zeros(16, np.float32))


def test_tiles_never_wrap_the_prefix():
    """No packed tile sets dist >= d on a sublane below d (dist is the
    within-segment position of a scatter slot), so the Pallas kernel's
    wrapping roll and the zero-filling prefix of the simulator and the
    CUDA kernel agree."""
    for name in STREAMS:
        t3 = to_np(_plans(name)[1].tile3).astype(np.int64)
        dist = t3 & 7
        for d in (1, 2, 4):
            assert not (dist[:, :d, :] >= d).any(), name


def test_plain_matches_jax_interpret_kernel():
    """The small stream through JAX's Pallas ``route_mul`` in interpret
    mode and through the port's plain version."""
    jp, tp, (slots, sa, sb, A, B, cap) = _plans("small")
    want = np.asarray(jax_route_mul(jp, jnp.asarray(A), jnp.asarray(B),
                                    interpret=True))
    got = tk.route_mul(tp, torch.from_numpy(A), torch.from_numpy(B))
    _assert_slots_close(got, want, slots, sa, sb, A, B, cap)


def test_carried_plan_runs_as_built():
    """A JAX plan carried across as numpy equals the port's own, and the
    plain version gives the same slots over either."""
    jp, tp, (slots, sa, sb, A, B, cap) = _plans("multi_window")
    cp = interop.route_mul_plan_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in ARRAYS},
        {f: getattr(jp, f) for f in STATIC}, device="cpu")
    for f in ARRAYS:
        np.testing.assert_array_equal(to_np(getattr(cp, f)),
                                      to_np(getattr(tp, f)), f)
    args = (torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_array_equal(to_np(tk.route_mul(cp, *args)),
                                  to_np(tk.route_mul(tp, *args)))


def test_wrapper_rejects_bad_operands():
    _, tp, (_, _, _, A, B, _) = _plans("small")
    a2 = tk.pad_pane(torch.from_numpy(A), tp.a_rows)
    b2 = tk.pad_pane(torch.from_numpy(B), tp.b_rows)
    with pytest.raises(TypeError):
        tk.route_mul_padded(tp, a2.double(), b2)
    with pytest.raises(ValueError):
        tk.route_mul_padded(tp, a2[:-128], b2)


@pytest.mark.parametrize("beta", [None, 0.5])
def test_v1_engine_product_matches_jax(monkeypatch, beta):
    """``SPBLAS_ROUTE_SPGEMM=1`` (with the engine gate forced on the CPU)
    builds the v1 engine at compute time; its fills, plain and fused
    (C = 2 A B + beta D), match the JAX product within the per-entry
    bound, and result_nnz is JAX's."""
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    monkeypatch.setenv("SPBLAS_ROUTE_SPGEMM", "1")
    monkeypatch.delenv("SPBLAS_FORCE_PANED_SPGEMM", raising=False)
    ja = gen.generate_csr(200, 150, 1500, seed=31)
    jb = gen.generate_csr(150, 180, 1200, seed=32)
    ta, tb = port_csr(ja), port_csr(jb)
    if beta is None:
        info = tsp.multiply_compute(ta, tb)
        assert isinstance(info.plan.route, RouteMulPlan)
        c = tsp.multiply_fill(info, tsp.scaled(2.0, ta), tb)
        want = sp.multiply(sp.scaled(2.0, ja), jb)
        bound = abs_spgemm(ja, jb, alpha=2.0)
    else:
        jd = gen.generate_csr(200, 180, 900, seed=33)
        td = port_csr(jd)
        info = tsp.spgemm_compute(ta, tb, d_view=td)
        assert isinstance(info.plan.route, RouteMulPlan)
        c = tsp.spgemm_fill(info, tsp.scaled(2.0, ta), tb,
                            d_view=tsp.scaled(beta, td))
        want = sp.spgemm_fill(sp.spgemm_compute(ja, jb, d_view=jd),
                              sp.scaled(2.0, ja), jb,
                              d_view=sp.scaled(beta, jd))
        bound = abs_spgemm(ja, jb, jd, alpha=2.0, beta=beta)
    assert info.result_nnz == int(want.nnz)
    assert_spgemm_close(c, want, bound)


@pytest.mark.parametrize("name", list(FILL_STREAMS))
def test_plan_keeps_its_expansion_stream(name):
    """The plan keeps the slot-sorted stream it was packed from, as
    ``build_slot_stream`` makes it from the same stream."""
    tp, (slots, sa, sb, A, B, cap) = _port_plan(name)
    want = tmf.build_slot_stream(slots, sa, sb, len(A), len(B), "cpu")
    ex = tp.expansion
    for f in ("sa", "sb", "run_start"):
        assert torch.equal(getattr(ex, f), getattr(want, f)), f
    assert (ex.a_len, ex.b_len, ex.nslots) == (want.a_len, want.b_len,
                                               want.nslots)
    # the longest run picks the CUDA kernel with or without its middle tier
    assert ex.longest == want.longest == int(np.bincount(slots).max())
    assert ex.nslots <= tp.capacity


@pytest.mark.parametrize("name", list(FILL_STREAMS))
def test_slot_fill_matches_simulator_and_tile_walker(name):
    """The slot fill's plain version over the plan's stream (the CUDA
    numeric's computation) against the exact numpy simulator, the plain
    tile walker and the scatter reference, per slot."""
    tp, (slots, sa, sb, A, B, cap) = _port_plan(name)
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    got = tmf.mul_fill_reference(tp.expansion, a, b, tp.capacity)
    assert got.shape == (cap,) and got.dtype == torch.float32
    walker = tk.route_mul_padded(tp, tk.pad_pane(a, tp.a_rows),
                                 tk.pad_pane(b, tp.b_rows)).view(-1)[:cap]
    for want, what in ((trm.route_mul_numpy(tp, A, B), "simulator"),
                       (to_np(walker), "walker"),
                       (_scatter(slots, sa, sb, A, B, cap), "scatter")):
        _assert_slots_close(got, want, slots, sa, sb, A, B, cap,
                            f"{name} vs {what}")
    if name == "dup40":
        assert np.bincount(slots).max() > 32    # runs past the owner cut


def test_carried_plan_has_no_stream_and_cuda_refuses_it(monkeypatch):
    """A JAX plan carried across has no expansion stream: on CUDA tensors
    ``route_mul`` raises rather than fall back, and the tile walker runs
    on the CPU only."""
    jp, tp, (slots, sa, sb, A, B, cap) = _plans("multi_window")
    cp = interop.route_mul_plan_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in ARRAYS},
        {f: getattr(jp, f) for f in STATIC}, device="cpu")
    assert cp.expansion is None and tp.expansion is not None
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    a2, b2 = tk.pad_pane(a, tp.a_rows), tk.pad_pane(b, tp.b_rows)
    monkeypatch.setattr(tk._t, "on_cuda", lambda t: True)
    with pytest.raises(ValueError, match="no expansion stream"):
        tk.route_mul(cp, a, b)
    with pytest.raises(ValueError, match="CPU only"):
        tk.route_mul_padded(tp, a2, b2)


def test_cuda_numeric_is_one_fill_over_the_stream(monkeypatch):
    """On CUDA tensors ``route_mul`` is one call of the slot fill over
    ``plan.expansion`` into the plan's capacity: no pane padding and no
    zeroed out pane; its values are the CPU walker's within the bound."""
    tp, (slots, sa, sb, A, B, cap) = _port_plan("dup40")
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    want = tk.route_mul(tp, a, b)
    calls = []

    def fill(stream, a_arr, b_arr, capacity):
        calls.append((stream, capacity))
        return tmf.mul_fill_reference(stream, a_arr, b_arr, capacity)

    def no_pad(*args):
        raise AssertionError("a pane was padded")

    monkeypatch.setattr(tk, "mul_fill", fill)
    monkeypatch.setattr(tk, "pad_pane", no_pad)
    monkeypatch.setattr(tk._t, "on_cuda", lambda t: True)
    got = tk.route_mul(tp, a, b)
    monkeypatch.undo()
    assert len(calls) == 1 and calls[0][0] is tp.expansion
    assert calls[0][1] == tp.capacity
    _assert_slots_close(got, to_np(want), slots, sa, sb, A, B, cap)

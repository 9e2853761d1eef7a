"""spblas_tpu_torch ROUTE2-mul engines (the fused SpGEMM numeric,
resident and paned) against the JAX package: bit-equal plans on the
geometries of ``tests/test_route2_mul.py`` and
``tests/test_route_mul_paned.py``, the kernels' plain versions against
the JAX package's exact numpy simulator (``route2_mul_numpy``) and the
scatter reference ``np.add.at(out, slots, A[sa] * B[sb])``, the aux
levels' launch starts, the prefix's no-wrap property, and plans carried
across from JAX.

JAX's paned Pallas kernel is not run here (its interpret mode costs
tens of seconds a case); the tiny resident plan goes through JAX's
``route2_mul`` in interpret mode once.  Tolerance: per slot 64 * eps_f32
* sum |A[sa] * B[sb]| over the slot's entries — the dot-product form of
``tests/torch_util.py``, since the plain version's ``index_add_`` (and
the CUDA kernels' atomics) sum a slot in another order than the
sequential simulator."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spblas_tpu.kernels import route2 as jr2
from spblas_tpu.kernels import route_mul_paned as jmp
from spblas_tpu.kernels.route2_kernel import route2_mul as jax_route2_mul

from spblas_tpu_torch.kernels import route2 as tr2
from spblas_tpu_torch.kernels import route2_kernel as tk
from spblas_tpu_torch.kernels import route_mul_paned as tmp
from spblas_tpu_torch.utils import interop

from tests.torch_util import EPS32, one_torch_thread, to_np  # noqa: F401

MUL_ARRAYS = ("tile1", "tile2", "a_base", "b_base", "src_flag", "y_base")
MUL_STATIC = ("g_a", "g_b", "a_rows", "b_rows", "y_rows", "aux_rows",
              "n_aux_chunks", "capacity", "fill", "dist_max")
PANEL_ARRAYS = ("t1", "t2", "ab", "bb", "yb", "fl", "eva", "evb", "evw",
                "evs")
PANEL_STATIC = ("slots", "out_rows", "has_aux", "dist_max")
PANED_STATIC = ("g_a", "g_b", "a_rows", "b_rows_pad", "pane_rows",
                "capacity", "fill")

# tests/test_route2_mul.py's geometries: (entries, capacity, hub slot)
RESIDENT = {"uniform": (20_000, 4096, False),
            "hub": (5_500, 2048, True),     # 500-entry hub slot: aux level
            "tiny": (300, 1024, False)}
# tests/test_route_mul_paned.py's: (entries, capacity, panel_slots,
# pane_rows, hub slot)
PANED = {"panels_panes": (20_000, 4096, 1024, 256, False),
         "hub": (6_000, 2048, 1024, 512, True),
         "one_panel": (3_000, 1024, 1 << 20, 512, False)}


def _stream(n_ent, cap, hub, b_len):
    """The seeded slot-sorted expansion stream and A, B values of the
    JAX tests (A's last slot is the caller-owned constant 1)."""
    rng = np.random.default_rng(n_ent)
    if hub:
        slots = np.sort(np.concatenate(
            [np.zeros(500, np.int64), rng.integers(0, cap, n_ent - 500)]))
    else:
        slots = np.sort(rng.integers(0, cap, n_ent))
    a_len = 1501
    sa = rng.integers(0, a_len - 1, n_ent)
    sb = rng.integers(0, b_len, n_ent)
    A = rng.standard_normal(a_len).astype(np.float32)
    A[-1] = 1.0
    B = rng.standard_normal(b_len).astype(np.float32)
    return slots, sa, sb, a_len, A, B


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


def _resident(name):
    n_ent, cap, hub = RESIDENT[name]
    slots, sa, sb, a_len, A, B = _stream(n_ent, cap, hub, 1800)
    jp = jr2.build_route2_mul_plan(slots, sa, sb, a_len, 1800, cap)
    tp = tr2.build_route2_mul_plan(slots, sa, sb, a_len, 1800, cap,
                                   device="cpu")
    return jp, tp, (slots, sa, sb, A, B, cap)


def _paned(name):
    n_ent, cap, ps, pr, hub = PANED[name]
    slots, sa, sb, a_len, A, B = _stream(n_ent, cap, hub, 40_000)
    kw = dict(panel_slots=ps, pane_rows=pr)
    jp = jmp.build_route2_mul_paned_plan(slots, sa, sb, a_len, 40_000, cap,
                                         **kw)
    tp = tmp.build_route2_mul_paned_plan(slots, sa, sb, a_len, 40_000, cap,
                                         device="cpu", **kw)
    return jp, tp, (slots, sa, sb, A, B, cap)


@pytest.mark.parametrize("name", list(RESIDENT))
def test_mul_plan_bit_equal_and_plain_matches_simulator(name):
    jp, tp, (slots, sa, sb, A, B, cap) = _resident(name)
    for f in MUL_ARRAYS:
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), f)
    for f in MUL_STATIC:
        assert getattr(tp, f) == getattr(jp, f), f
    assert (tp.n_aux_chunks > 0) == (name == "hub")
    got = tk.route2_mul(tp, torch.from_numpy(A), torch.from_numpy(B))
    sim = jr2.route2_mul_numpy(jp, A, B)
    _assert_slots_close(got, sim, slots, sa, sb, A, B, cap, name)
    _assert_slots_close(got, _scatter(slots, sa, sb, A, B, cap), slots, sa,
                        sb, A, B, cap, name)
    # the port's own copy of the simulator agrees with JAX's exactly
    np.testing.assert_array_equal(tr2.route2_mul_numpy(tp, A, B), sim)


def test_mul_plain_matches_jax_interpret_kernel():
    """The 300-entry plan through JAX's Pallas ``route2_mul`` in
    interpret mode and through the port's plain version."""
    jp, tp, (slots, sa, sb, A, B, cap) = _resident("tiny")
    want = np.asarray(jax_route2_mul(jp, jnp.asarray(A), jnp.asarray(B),
                                     interpret=True))
    got = tk.route2_mul(tp, torch.from_numpy(A), torch.from_numpy(B))
    _assert_slots_close(got, want, slots, sa, sb, A, B, cap)


def test_mul_launch_starts_split_the_levels():
    """The hub plan's aux chunks read out-pane slots the flag-0 chunks
    wrote: as one launch they read zeros, as the builder's launches they
    read the partial sums."""
    _, tp, (slots, sa, sb, A, B, cap) = _resident("hub")
    first_aux = int(np.flatnonzero(to_np(tp.src_flag) == 1)[0])
    assert tp.launch_starts[:2] == (0, first_aux)
    assert first_aux % 8 == 0          # the flag transition's CB padding
    ref = _scatter(slots, sa, sb, A, B, cap)
    good = tk.route2_mul(tp, torch.from_numpy(A), torch.from_numpy(B))
    _assert_slots_close(good, ref, slots, sa, sb, A, B, cap)
    one = dataclasses.replace(tp, launch_starts=(0,))
    bad = tk.route2_mul(one, torch.from_numpy(A), torch.from_numpy(B))
    assert np.abs(to_np(bad) - ref).max() > 1.0


@pytest.mark.parametrize("kind", ["resident", "paned"])
def test_mul_tiles_never_wrap_the_prefix(kind):
    """No packed tile sets dist >= d on a sublane below d, so the TPU
    kernel's wrapping roll and the zero-filling prefix of the simulator
    and the CUDA kernel agree."""
    if kind == "resident":
        tiles = [to_np(_resident(n)[1].tile1) for n in RESIDENT]
    else:
        tiles = [to_np(p.t1) for n in PANED for p in _paned(n)[1].panels]
    for t1 in tiles:
        dist = (t1.astype(np.int64) >> tr2.B_DIST) & 7
        for d in (1, 2, 4):
            assert not (dist[:, :d, :] >= d).any()


@pytest.mark.parametrize("name", list(PANED))
def test_paned_plan_bit_equal_and_matches_scatter(name):
    jp, tp, (slots, sa, sb, A, B, cap) = _paned(name)
    assert len(tp.panels) == len(jp.panels)
    for f in PANED_STATIC:
        assert getattr(tp, f) == getattr(jp, f), f
    for jpn, tpn in zip(jp.panels, tp.panels):
        for f in PANEL_ARRAYS:
            np.testing.assert_array_equal(to_np(getattr(tpn, f)),
                                          np.asarray(getattr(jpn, f)), f)
        for f in PANEL_STATIC:
            assert getattr(tpn, f) == getattr(jpn, f), f
        # each chunk's B pane is the one the event streams load
        np.testing.assert_array_equal(to_np(tpn.pane), interop.
                                      paned_chunk_panes(
                                          to_np(tpn.fl), to_np(tpn.eva),
                                          to_np(tpn.evb), to_np(tpn.evs)))
    if name == "panels_panes":
        assert len(tp.panels) > 1 and tp.b_rows_pad // tp.pane_rows > 1
    if name == "hub":
        assert any(len(p.launch_starts) > 1 for p in tp.panels)
    got = tmp.route2_mul_paned(tp, torch.from_numpy(A), torch.from_numpy(B))
    assert got.shape == (cap,)
    _assert_slots_close(got, _scatter(slots, sa, sb, A, B, cap), slots, sa,
                        sb, A, B, cap, name)


def test_carried_plans_give_the_builders_metadata():
    """JAX plans carried across as numpy: the resident plan's and every
    panel's launch starts hold the builder's (a carried plan can only
    split more), the panes are the builder's, and the outputs agree."""
    jp, tp, (slots, sa, sb, A, B, cap) = _resident("hub")
    carried = interop.route2_mul_plan_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in MUL_ARRAYS},
        {f: getattr(jp, f) for f in MUL_STATIC}, device="cpu")
    assert set(tp.launch_starts) <= set(carried.launch_starts)
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    np.testing.assert_array_equal(to_np(tk.route2_mul(carried, a, b)),
                                  to_np(tk.route2_mul(tp, a, b)))

    jp, tp, (slots, sa, sb, A, B, cap) = _paned("hub")
    carried = interop.route2_mul_paned_plan_from_numpy(
        [({f: np.asarray(getattr(p, f)) for f in PANEL_ARRAYS},
          {f: getattr(p, f) for f in PANEL_STATIC}) for p in jp.panels],
        {f: getattr(jp, f) for f in PANED_STATIC}, device="cpu")
    for p, q in zip(tp.panels, carried.panels):
        np.testing.assert_array_equal(to_np(q.pane), to_np(p.pane))
        assert set(p.launch_starts) <= set(q.launch_starts)
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    np.testing.assert_array_equal(to_np(tmp.route2_mul_paned(carried, a, b)),
                                  to_np(tmp.route2_mul_paned(tp, a, b)))


def test_mul_wrappers_check_operands():
    _, tp, (slots, sa, sb, A, B, cap) = _resident("tiny")
    a2, b2 = tk.pack_mul_panes(tp, torch.from_numpy(A), torch.from_numpy(B))
    with pytest.raises(TypeError, match="float32"):
        tk.route2_mul_padded(tp, a2.double(), b2)
    with pytest.raises(ValueError, match="bad shapes"):
        tk.route2_mul_padded(tp, a2[:-1], b2)
    with pytest.raises(TypeError, match="int32"):
        tk.route2_mul_padded(dataclasses.replace(
            tp, y_base=tp.y_base.long()), a2, b2)
    _, pp, (slots, sa, sb, A, B, cap) = _paned("one_panel")
    a2, b2 = tmp.pack_mul_panes(pp, torch.from_numpy(A),
                                torch.from_numpy(B))
    with pytest.raises(ValueError, match="bad shapes"):
        tmp.route2_mul_paned_padded(pp, pp.panels[0], a2, b2[:-128])
    with pytest.raises(ValueError, match="whole B slabs"):
        tmp.build_route2_mul_paned_plan(slots, sa, sb, 1501, 40_000, cap,
                                        pane_rows=100, device="cpu")

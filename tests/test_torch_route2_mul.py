"""spblas_tpu_torch ROUTE2-mul engines (the fused SpGEMM numeric,
resident and paned) against the JAX package: bit-equal plans on the
geometries of ``tests/test_route2_mul.py`` and
``tests/test_route_mul_paned.py``, the kernels' plain versions against
the JAX package's exact numpy simulator (``route2_mul_numpy``) and the
scatter reference ``np.add.at(out, slots, A[sa] * B[sb])``, the aux
levels' launch starts, the prefix's no-wrap property, plans carried
across from JAX, and the resident and paned plans' expansion streams
(the slot fill's input, ``kernels/mul_fill.py``, which is the CUDA
numeric of both) with its plain segmented sum against the tile walker,
JAX's simulator and the scatter reference; the fill's hub segment cut
and its plain model.

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

from spblas_tpu_torch.kernels import mul_fill as tmf
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


def _stream(n_ent, cap, hub, b_len, hub_len=500):
    """The seeded slot-sorted expansion stream and A, B values of the
    JAX tests (A's last slot is the caller-owned constant 1)."""
    rng = np.random.default_rng(n_ent)
    if hub:
        slots = np.sort(np.concatenate(
            [np.zeros(hub_len, np.int64),
             rng.integers(0, cap, n_ent - hub_len)]))
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
    with pytest.raises(ValueError, match="bad shapes"):
        tmp.mul_fill(pp.expansion, torch.from_numpy(A),
                     torch.from_numpy(B)[:-128], pp.capacity)
    with pytest.raises(ValueError, match="whole B slabs"):
        tmp.build_route2_mul_paned_plan(slots, sa, sb, 1501, 40_000, cap,
                                        pane_rows=100, device="cpu")


def _panel_spans(tp):
    """[(s0, s1)) slot span of each panel of a paned plan."""
    spans, s0 = [], 0
    for p in tp.panels:
        spans.append((s0, s0 + p.slots))
        s0 += p.slots
    return spans


@pytest.mark.parametrize("name", list(PANED))
def test_paned_expansion_is_the_built_stream(name):
    """Per panel, the plan's expansion stream holds exactly the products
    of the stream it was built from whose slots lie in the panel, in
    order, and each slot's run starts where its products start."""
    jp, tp, (slots, sa, sb, A, B, cap) = _paned(name)
    ex = tp.expansion
    assert ex.nslots == int(slots[-1]) + 1 and ex.nslots <= cap
    assert (ex.a_len, ex.b_len) == (len(A), len(B))
    run = to_np(ex.run_start).astype(np.int64)
    np.testing.assert_array_equal(np.diff(run),
                                  np.bincount(slots, minlength=ex.nslots))
    for s0, s1 in _panel_spans(tp):
        sel = (slots >= s0) & (slots < s1)
        lo, hi = run[min(s0, ex.nslots)], run[min(s1, ex.nslots)]
        np.testing.assert_array_equal(to_np(ex.sa)[lo:hi], sa[sel])
        np.testing.assert_array_equal(to_np(ex.sb)[lo:hi], sb[sel])
    # a plan carried from JAX has no stream: the CUDA fill refuses it
    carried = interop.route2_mul_paned_plan_from_numpy(
        [({f: np.asarray(getattr(p, f)) for f in PANEL_ARRAYS},
          {f: getattr(p, f) for f in PANEL_STATIC}) for p in jp.panels],
        {f: getattr(jp, f) for f in PANED_STATIC}, device="cpu")
    assert carried.expansion is None


@pytest.mark.parametrize("name", list(PANED))
def test_plain_slot_fill_matches_walker_simulator_scatter(name):
    """The slot fill's plain version (one segmented sum over the stream)
    against the plain tile walker (``route2_mul_paned_reference`` panel
    by panel, concatenated and zero-padded to the capacity), JAX's numpy
    simulator of each panel's slot slice (``route2_mul_numpy`` on JAX's
    mul plan of it, as the paned builder packs each panel) and the
    scatter reference, hub slots included; the CPU wrapper runs it and
    launches nothing."""
    _, tp, (slots, sa, sb, A, B, cap) = _paned(name)
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    before = tmf.mul_fill.launches
    got = tmf.mul_fill(tp.expansion, a, b, tp.capacity)
    assert tmf.mul_fill.launches == before
    assert got.shape == (cap,) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        to_np(got), to_np(tmf.mul_fill_reference(tp.expansion, a, b, cap)))
    a2, b2 = tmp.pack_mul_panes(tp, a, b)
    walker = torch.cat([tmp.route2_mul_paned_reference(tp, p, a2, b2)
                        .view(-1)[:p.slots] for p in tp.panels])
    walker = torch.nn.functional.pad(walker, (0, cap - walker.shape[0]))
    sim = np.zeros(cap, np.float64)
    for s0, s1 in _panel_spans(tp):
        sel = (slots >= s0) & (slots < s1)
        if not sel.any():
            continue
        jp = jr2.build_route2_mul_plan(slots[sel] - s0, sa[sel], sb[sel],
                                       len(A), len(B), s1 - s0)
        sim[s0:s1] = jr2.route2_mul_numpy(jp, A, B)[: s1 - s0]
    for want, what in ((walker, "walker"), (sim, "simulator"),
                       (_scatter(slots, sa, sb, A, B, cap), "scatter")):
        _assert_slots_close(got, to_np(want) if torch.is_tensor(want)
                            else want, slots, sa, sb, A, B, cap,
                            f"{name} vs {what}")
    if name == "hub":
        assert np.bincount(slots).max() > 32    # a run past the warp cut


def test_slot_fill_checks_operands():
    _, tp, (slots, sa, sb, A, B, cap) = _paned("one_panel")
    ex = tp.expansion
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    with pytest.raises(TypeError, match="float32"):
        tmf.mul_fill(ex, a.double(), b, cap)
    with pytest.raises(ValueError, match="bad shapes"):
        tmf.mul_fill(ex, a[:-1], b, cap)
    with pytest.raises(ValueError, match="bad shapes"):
        tmf.mul_fill(ex, a, b, ex.nslots - 1)
    with pytest.raises(TypeError, match="int32"):
        tmf.mul_fill(dataclasses.replace(ex, sa=ex.sa.long()), a, b, cap)
    with pytest.raises(ValueError, match="nondecreasing"):
        tmf.build_slot_stream(slots[::-1], sa, sb, len(A), len(B), "cpu")


# RESIDENT and a stream whose hub slot passes the slot fill's hub cut
# (mul_fill.HUB_MIN): (entries, capacity, hub slot, hub entries)
FILL_RESIDENT = dict({k: v + (500,) for k, v in RESIDENT.items()},
                     long_hub=(9_000, 2048, True, 3_000))


def _port_resident(name):
    n_ent, cap, hub, hub_len = FILL_RESIDENT[name]
    slots, sa, sb, a_len, A, B = _stream(n_ent, cap, hub, 1800, hub_len)
    tp = tr2.build_route2_mul_plan(slots, sa, sb, a_len, 1800, cap,
                                   device="cpu")
    return tp, (slots, sa, sb, A, B, cap)


@pytest.mark.parametrize("name", list(FILL_RESIDENT))
def test_resident_expansion_is_the_built_stream(name):
    """The resident plan keeps exactly the products it was built from, in
    stream order, each slot's run starting where its products start, as
    ``build_slot_stream`` makes the stream."""
    tp, (slots, sa, sb, A, B, cap) = _port_resident(name)
    ex = tp.expansion
    np.testing.assert_array_equal(to_np(ex.sa), sa)
    np.testing.assert_array_equal(to_np(ex.sb), sb)
    np.testing.assert_array_equal(np.diff(to_np(ex.run_start)),
                                  np.bincount(slots, minlength=ex.nslots))
    assert ex.nslots == int(slots[-1]) + 1 <= tp.capacity
    assert (ex.a_len, ex.b_len) == (len(A), len(B))
    assert ex.longest == int(np.bincount(slots).max())
    want = tmf.build_slot_stream(slots, sa, sb, len(A), len(B), "cpu")
    for f in ("sa", "sb", "run_start"):
        assert torch.equal(getattr(ex, f), getattr(want, f)), f
    assert (ex.nseg > 0) == (name == "long_hub")


@pytest.mark.parametrize("name", list(FILL_RESIDENT))
def test_resident_slot_fill_matches_walker_simulator_scatter(name):
    """The slot fill's plain version over the resident plan's stream (the
    CUDA numeric's computation), and the plain model of its hub cut,
    against the plain tile walker, the port's numpy simulator and the
    scatter reference, per slot; the CPU wrapper launches nothing."""
    tp, (slots, sa, sb, A, B, cap) = _port_resident(name)
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    before = tmf.mul_fill.launches
    got = tmf.mul_fill(tp.expansion, a, b, tp.capacity)
    assert tmf.mul_fill.launches == before
    assert got.shape == (cap,) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        to_np(got), to_np(tmf.mul_fill_reference(tp.expansion, a, b, cap)))
    model = tmf.hub_fill_reference(tp.expansion, a, b, cap)
    walker = tk.route2_mul(tp, a, b)
    for y in (got, model):
        for want, what in ((to_np(walker), "walker"),
                           (tr2.route2_mul_numpy(tp, A, B), "simulator"),
                           (_scatter(slots, sa, sb, A, B, cap), "scatter")):
            _assert_slots_close(y, want, slots, sa, sb, A, B, cap,
                                f"{name} vs {what}")


def test_carried_resident_plan_has_no_stream_and_cuda_refuses_it(
        monkeypatch):
    """A JAX plan carried across has no expansion stream: on CUDA tensors
    ``route2_mul`` raises rather than fall back, and the tile walker runs
    on the CPU only."""
    jp, tp, (slots, sa, sb, A, B, cap) = _resident("hub")
    cp = interop.route2_mul_plan_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in MUL_ARRAYS},
        {f: getattr(jp, f) for f in MUL_STATIC}, device="cpu")
    assert cp.expansion is None and tp.expansion is not None
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    a2, b2 = tk.pack_mul_panes(tp, a, b)
    monkeypatch.setattr(tk._t, "on_cuda", lambda t: True)
    with pytest.raises(ValueError, match="no expansion stream"):
        tk.route2_mul(cp, a, b)
    with pytest.raises(ValueError, match="CPU only"):
        tk.route2_mul_padded(tp, a2, b2)


@pytest.mark.parametrize("name", ["uniform", "long_hub"])
def test_resident_cuda_numeric_is_one_fill_over_the_stream(monkeypatch,
                                                           name):
    """On CUDA tensors ``route2_mul`` is one call of the slot fill over
    ``plan.expansion`` into the plan's capacity: no pane padding, no
    zeroed out pane and no launch a level; its values are the CPU
    walker's within the bound."""
    tp, (slots, sa, sb, A, B, cap) = _port_resident(name)
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    want = tk.route2_mul(tp, a, b)
    calls = []

    def fill(stream, a_arr, b_arr, capacity):
        calls.append((stream, capacity))
        return tmf.hub_fill_reference(stream, a_arr, b_arr, capacity)

    def no_pad(*args):
        raise AssertionError("a pane was padded")

    monkeypatch.setattr(tk, "mul_fill", fill)
    monkeypatch.setattr(tk, "pack_mul_panes", no_pad)
    monkeypatch.setattr(tk, "pad_pane", no_pad)
    monkeypatch.setattr(tk._t, "on_cuda", lambda t: True)
    got = tk.route2_mul(tp, a, b)
    monkeypatch.undo()
    assert len(calls) == 1 and calls[0][0] is tp.expansion
    assert calls[0][1] == tp.capacity
    _assert_slots_close(got, to_np(want), slots, sa, sb, A, B, cap)


# runs a slot: runs at and below the hub cut (mul_fill.HUB_MIN, 1,024),
# past it by one, whole multiples of the segment and ragged ones;
# (runs, seg_len)
HUB_CUTS = {"none": ([3, 1024, 0, 17], 1024),
            "just_past": ([5, 1025, 2], 1024),
            "several": ([2048, 1, 4100, 0, 3000, 1024], 1024),
            "short_segments": ([1500, 7, 2600], 512),
            "ragged_segments": ([2048, 2049, 9], 700)}


@pytest.mark.parametrize("name", list(HUB_CUTS))
def test_hub_segments_cover_each_long_run_once(monkeypatch, name):
    """The hub cut lists exactly the runs longer than ``HUB_MIN``, in
    stream order, each cut into segments of ``seg_len`` (the last one
    shorter) that cover it once, in order; a stream with no such run has
    no hub tier; the plain model of the cut gives the segmented sum's
    slot values within the bound."""
    runs, seg_len = HUB_CUTS[name]
    hub_min = tmf.HUB_MIN
    slots = np.repeat(np.arange(len(runs)), runs)
    rng = np.random.default_rng(len(slots))
    sa = rng.integers(0, 300, len(slots))
    sb = rng.integers(0, 400, len(slots))
    monkeypatch.setattr(tmf, "HUB_SEG_LEN", seg_len)
    ex = tmf.build_slot_stream(slots, sa, sb, 300, 400, "cpu")
    run_start = np.concatenate([[0], np.cumsum(runs)])
    hubs = [s for s, r in enumerate(runs) if r > hub_min]
    # the slots' blocks keep the rest: their longest picks the tiers
    assert ex.longest_kept == max(r for r in runs if r <= hub_min)
    assert ex.longest == max(runs)
    if not hubs:
        assert ex.nseg == 0 and ex.hub_seg is None
        assert ex.hub_count is None and ex.hub_part is None
    else:
        seg = to_np(ex.hub_seg)
        assert seg.shape == (ex.nseg, 8) and not seg[:, 6:].any()
        assert list(dict.fromkeys(seg[:, 3])) == hubs       # in order
        for h, s in enumerate(hubs):
            rows = seg[seg[:, 3] == s]
            assert (rows[:, 2] == h).all()
            # contiguous, in order, covering [run_start[s], run_start[s+1])
            np.testing.assert_array_equal(rows[0, 0], run_start[s])
            np.testing.assert_array_equal(rows[1:, 0], rows[:-1, 1])
            assert rows[-1, 1] == run_start[s + 1]
            assert (rows[:-1, 1] - rows[:-1, 0] == seg_len).all()
            assert 0 < rows[-1, 1] - rows[-1, 0] <= seg_len
            first = int(np.flatnonzero(seg[:, 3] == s)[0])
            assert (rows[:, 4] == first).all()
            assert (rows[:, 5] == len(rows)).all()
        assert to_np(ex.hub_count).tolist() == [0] * len(hubs)
        assert tuple(ex.hub_part.shape) == (ex.nseg,)
    a = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(400).astype(np.float32))
    cap = len(runs) + 3
    A, B = to_np(a), to_np(b)
    _assert_slots_close(tmf.hub_fill_reference(ex, a, b, cap),
                        _scatter(slots, sa, sb, A, B, cap), slots, sa, sb,
                        A, B, cap, name)
    np.testing.assert_array_equal(
        to_np(ex.hub_seg) if hubs else np.zeros((0, 8), np.int32),
        tmf.hub_segments(run_start, seg_len))
    with pytest.raises(ValueError, match="segment length"):
        tmf.hub_segments(run_start, 0)

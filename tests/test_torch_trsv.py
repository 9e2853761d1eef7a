"""spblas_tpu_torch SpTRSV against the JAX package (the cases of
``tests/test_triangular_solve.py`` and ``tests/test_block_solve.py``):
the ragged level sweep, the ROUTE2 substitution (forced on the CPU with
``SPBLAS_FORCE_ROUTE_TRSV``, which runs the solve kernel's plain
version) and the pane-blocked solve (a lowered
``SPBLAS_ROUTE_SOLVE_PANE_CAP``), the schedule and solve plans bit-equal
to JAX's, each solve plan's launches holding one dependency level, the
persistent solve's work list (its steps and one-block stretches against
the launch starts, and an execution in its order with every step's
items reading the pane as the step found it), and the re-bake, grad,
deep-chain and launch-splitting paths.

Tolerances: against JAX's solve and the dense oracles, JAX's own
(``tests/util.py::assert_close``, factor 256 or 1024, abs floor 1e-4);
every solve also to the componentwise backward error per row, in
float64: |alpha A x - b|_i <= 64 eps_f32 (|alpha| |A| |x| + |b|)_i.
JAX's one-dispatch Pallas solve runs in interpret mode once, on a small
plan; elsewhere its numpy oracle ``route2_solve_numpy`` stands in."""

import dataclasses
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spl
import torch

import spblas_tpu as sp
from spblas_tpu import native as jnative
from spblas_tpu.kernels import route2 as jr2
from spblas_tpu.kernels.route2_kernel import route2_solve as jax_route2_solve
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import route2 as tr2
from spblas_tpu_torch.kernels import route2_kernel as tk
from spblas_tpu_torch.utils import interop

from tests.torch_util import EPS32, one_torch_thread, port_csr, to_np  # noqa: F401
from tests.util import assert_close, dense_from_csr

ts = importlib.import_module("spblas_tpu_torch.ops.triangular_solve")

PLAN_ARRAYS = ("ent_idx", "ent_col", "ent_slot", "lv_estart", "row_ids",
               "diag_idx", "lv_rstart")
ROUTE_ARRAYS = ("tile", "val", "slab_base", "y_base", "src_flag", "val_src")
ROUTE_STATIC = ("g", "shape", "nat_slots", "x_rows", "y_rows", "aux_rows",
                "n_aux_chunks", "fill", "dist_max", "any_lane")


def _scipy(a, unit=False):
    """The JAX or port CSR ``a`` as a float64 scipy matrix (plus the
    implicit unit diagonal when ``unit``)."""
    nnz = int(a.nnz)
    A = sps.csr_matrix((to_np(a.values)[:nnz].astype(np.float64),
                        to_np(a.colind)[:nnz], to_np(a.rowptr)),
                       shape=a.shape)
    return (A + sps.eye(a.shape[0])).tocsr() if unit else A


def _assert_backward(a, x, b, alpha=1.0, unit=False, factor=64):
    """|alpha A x - b|_i <= factor eps_f32 (|alpha| |A| |x| + |b|)_i."""
    A = _scipy(a, unit)
    x = to_np(x).astype(np.float64)
    b = to_np(b).astype(np.float64)
    r = np.abs(alpha * (A @ x) - b)
    lim = factor * EPS32 * (abs(alpha) * (abs(A) @ np.abs(x)) + np.abs(b))
    bad = r > lim
    assert not bad.any(), (f"{bad.sum()} rows past the backward bound; "
                           f"worst {np.max(r - lim)}")


def _np_trsv(dense, b, lower, unit):
    m = dense.shape[0]
    x = np.zeros(m, dtype=np.result_type(dense.dtype, b.dtype))
    order = range(m) if lower else range(m - 1, -1, -1)
    for i in order:
        deps = range(i) if lower else range(i + 1, m)
        dot = sum(dense[i, k] * x[k] for k in deps)
        diag = 1.0 if unit else dense[i, i]
        x[i] = (b[i] - dot) / diag
    return x


@functools.lru_cache(maxsize=None)
def _jax_case(lower, unit):
    """tests/test_triangular_solve.py's 120-row factor, its rhs, and
    JAX's solve and the dense oracle's."""
    a = gen.generate_triangular_csr(120, seed=0, lower=lower,
                                    unit_diag=unit, density=0.08)
    b = np.asarray(gen.generate_vector(120, seed=1))
    uplo = "lower" if lower else "upper"
    diag = "unit" if unit else "explicit"
    x = np.asarray(sp.triangular_solve(a, b, uplo=uplo, diag=diag))
    return a, b, x, _np_trsv(dense_from_csr(a), b, lower, unit)


@pytest.mark.parametrize("path", ["sweep", "route"])
@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("lower", [True, False])
def test_trsv_matches_jax(monkeypatch, lower, unit, path):
    a, b, x_jax, x_np = _jax_case(lower, unit)
    if path == "route":
        monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")
    uplo = "lower" if lower else "upper"
    diag = "unit" if unit else "explicit"
    ta = port_csr(a)
    info = tsp.triangular_solve_inspect(ta, uplo=uplo, diag=diag)
    assert (info.plan.route is not None) == (path == "route")
    x = tsp.triangular_solve(ta, torch.from_numpy(b), uplo=uplo, diag=diag,
                             info=info)
    assert x.dtype == torch.float32 and x.shape == (120,)
    assert_close(to_np(x), x_jax, factor=1024, abs_floor=1e-4)
    assert_close(to_np(x), x_np, factor=1024, abs_floor=1e-4)
    _assert_backward(a, x, b, unit=unit)


def test_schedule_plans_bit_equal_to_jax():
    """The ragged schedule of the skewed triangle (one dense row) and of
    a diagonal matrix (one level) equal JAX's arrays and caps."""
    m = 400
    rng = np.random.default_rng(0)
    rows = np.concatenate([np.arange(1, m), np.full(m - 2, m - 1),
                           np.arange(m)])
    cols = np.concatenate([np.arange(m - 1), np.arange(m - 2),
                           np.arange(m)])
    key = np.unique(rows * m + cols)
    rows, cols = key // m, key % m
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    vals[rows == cols] = 2.0 + np.abs(vals[rows == cols])
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))])
    skew = sp.CSR.from_arrays(vals, rowptr, cols, (m, m), nnz=len(vals))
    diag_only = gen.generate_triangular_csr(32, seed=7, lower=True,
                                            density=0.0)
    for a in (skew, diag_only):
        jp = sp.triangular_solve_inspect(a, uplo="lower").plan
        tp = tsp.triangular_solve_inspect(port_csr(a), uplo="lower").plan
        for f in PLAN_ARRAYS:
            np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                          np.asarray(getattr(jp, f)), f)
        assert (tp.e_cap, tp.r_cap, tp.num_levels, tp.m) == \
            (jp.e_cap, jp.r_cap, jp.num_levels, jp.m)
    assert tp.num_levels == 1
    b = rng.standard_normal(m).astype(np.float32)
    x = tsp.triangular_solve(port_csr(skew), torch.from_numpy(b))
    _assert_backward(skew, x, b)


def test_trsv_inspect_reuse_and_scaled():
    a = gen.generate_triangular_csr(80, seed=2, lower=True, density=0.1)
    ta = port_csr(a)
    info = tsp.triangular_solve_inspect(ta, uplo="lower")
    assert info.plan.num_levels >= 1 and info.result_shape == (80, 1)
    dense = dense_from_csr(a)
    for seed in (3, 4):
        b = np.asarray(gen.generate_vector(80, seed=seed))
        x = tsp.triangular_solve(ta, torch.from_numpy(b), info=info)
        assert_close(to_np(x), _np_trsv(dense, b, True, False),
                     factor=1024, abs_floor=1e-4)
    b = np.asarray(gen.generate_vector(80, seed=6))
    x = tsp.triangular_solve(tsp.scaled(2.0, ta), torch.from_numpy(b),
                             info=info)
    want = np.asarray(sp.triangular_solve(sp.scaled(2.0, a), b))
    assert_close(to_np(x), want, factor=1024, abs_floor=1e-4)
    _assert_backward(a, x, b, alpha=2.0)


def test_trsv_bad_args():
    a = port_csr(gen.generate_triangular_csr(10, seed=9, lower=True))
    b = torch.ones(10)
    with pytest.raises(ValueError, match="uplo"):
        tsp.triangular_solve(a, b, uplo="diagonal")
    with pytest.raises(ValueError, match="diag"):
        tsp.triangular_solve(a, b, diag="fancy")
    unit = port_csr(gen.generate_triangular_csr(10, seed=8, lower=True,
                                                unit_diag=True))
    with pytest.raises(ValueError, match="no diagonal"):
        tsp.triangular_solve_inspect(unit, uplo="lower", diag="explicit")
    info = tsp.triangular_solve_inspect(a, uplo="lower")
    with pytest.raises(ValueError, match="inspected with uplo"):
        tsp.triangular_solve(a, b, uplo="upper", info=info)
    with pytest.raises(ValueError, match="inspected with diag"):
        tsp.triangular_solve(a, b, diag="unit", info=info)
    with pytest.raises(ValueError, match="b length"):
        tsp.triangular_solve(a, torch.ones(9), info=info)
    rect = port_csr(gen.generate_csr(10, 12, 30, seed=1))
    with pytest.raises(ValueError, match="square"):
        tsp.triangular_solve_inspect(rect)


def _levels(a, lower, unit):
    m, nnz = a.shape[0], int(a.nnz)
    return jnative.level_schedule(
        m, nnz, np.asarray(a.rowptr).astype(np.int64),
        np.asarray(a.colind), lower, unit)


def _hub_factor(m=3000):
    """A lower factor with two rows of 400 entries (hub levels, aux
    reductions) on a sparse random triangle."""
    base = _scipy(gen.generate_triangular_csr(m, seed=1, lower=True,
                                              density=0.002)).tolil()
    rng = np.random.default_rng(0)
    for r in (2000, m - 1):
        base[r, rng.choice(r, 400, replace=False)] = rng.uniform(-1, 1, 400)
    A = base.tocsr()
    A.sort_indices()
    return sp.CSR.from_arrays(A.data.astype(np.float32), A.indptr,
                              A.indices, (m, m), nnz=A.nnz)


FACTORS = {
    "tri3000": (lambda: gen.generate_triangular_csr(3000, seed=7,
                                                    lower=True), True, False),
    "upper_unit": (lambda: gen.generate_triangular_csr(
        500, seed=7, lower=False, unit_diag=True, density=0.05), False, True),
    "hub_rows": (_hub_factor, True, False),
    "chain": (lambda: gen.generate_block_chain_lower(8192, block=64, deg=4,
                                                     seed=3), True, False)}


@functools.lru_cache(maxsize=None)
def _factor(name):
    make, lower, unit = FACTORS[name]
    a = make()
    levels, diag_pos, _ = _levels(a, lower, unit)
    m, nnz = a.shape[0], int(a.nnz)
    args = (np.asarray(a.rowptr), np.asarray(a.colind), np.asarray(a.values),
            (m, m), nnz, levels, diag_pos, unit, lower)
    return a, levels, diag_pos, jr2.build_route2_solve_plan(*args), \
        tr2.build_route2_solve_plan(*args, device="cpu")


@pytest.mark.parametrize("name", list(FACTORS))
def test_solve_plan_bit_equal_and_plain_matches_oracle(name):
    """The solve plan's arrays are JAX's bit for bit; the plain solve
    agrees with JAX's numpy oracle and holds the backward bound."""
    a, levels, diag_pos, jp, tp = _factor(name)
    _, lower, unit = FACTORS[name]
    for f in ROUTE_ARRAYS:
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), f)
    for f in ROUTE_STATIC:
        assert getattr(tp, f) == getattr(jp, f), f
    if name == "hub_rows":
        assert tp.n_aux_chunks > 0
    m = a.shape[0]
    b = np.random.default_rng(4).standard_normal(m).astype(np.float32)
    d = np.ones(m, np.float32) if unit else np.asarray(a.values)[diag_pos]
    y0 = b / d
    want = jr2.route2_solve_numpy(jp, y0)
    np.testing.assert_array_equal(tr2.route2_solve_numpy(tp, y0), want)
    before = tk.route2_solve_padded.launches
    got = tk.route2_solve(tp, torch.from_numpy(y0))
    assert tk.route2_solve_padded.launches == before   # plain: no launch
    assert_close(to_np(got), want, factor=256,
                 abs_floor=1e-6 * float(np.abs(want).max()))
    _assert_backward(a, got, b, unit=unit)


@pytest.mark.parametrize("name", list(FACTORS))
def test_solve_launches_hold_one_level(name):
    """Every launch range publishes into rows of one dependency level,
    the levels rise from launch to launch (a hub level's aux launches
    keep its level), and the starts are strictly increasing; run as one
    launch, the chunks read rows not solved yet and the answer is
    wrong."""
    a, levels, diag_pos, _, tp = _factor(name)
    _, lower, unit = FACTORS[name]
    m = a.shape[0]
    starts = tp.launch_starts
    assert all(s1 > s0 for s0, s1 in zip(starts, starts[1:]))
    tiles = to_np(tp.tile).astype(np.int64)
    va = (tiles >> tr2.B_VA) & 1
    rows = (to_np(tp.y_base).astype(np.int64)[:, None, None]
            + np.arange(tr2.SUBS)[None, :, None]) * tr2.LANES \
        + np.arange(tr2.LANES)[None, None, :]
    prev = -1
    for lo, hi in tp.launch_ranges():
        r = rows[lo:hi][(va[lo:hi] == 1) & (rows[lo:hi] < m)]
        lv = np.unique(levels[r])
        assert len(lv) <= 1, (lo, hi, lv)
        if len(lv):
            assert lv[0] >= prev
            prev = lv[0]
    if tp.launch_ranges() == [(0, tp.nchunks)]:
        return
    b = np.random.default_rng(5).standard_normal(m).astype(np.float32)
    d = np.ones(m, np.float32) if unit else np.asarray(a.values)[diag_pos]
    y0 = torch.from_numpy(b / d)
    good = tk.route2_solve(tp, y0)
    bad = tk.route2_solve(dataclasses.replace(tp, launch_starts=(0,)), y0)
    assert np.abs(to_np(good) - to_np(bad)).max() > 1e-3 * float(
        np.abs(to_np(good)).max())


def _items_of(work):
    """(item starts with the end, item steps, step needs) as numpy."""
    return (to_np(work.item_start).astype(np.int64),
            to_np(work.item_step).astype(np.int64),
            to_np(work.step_need).astype(np.int64))


@pytest.mark.parametrize("stretch", [0, 1, 4])
@pytest.mark.parametrize("name", list(FACTORS))
def test_solve_work_follows_launch_starts(name, stretch):
    """The persistent solve's work list against the plan's launch
    ranges: the items cover the chunks in order; an item is one chunk of
    a range wider than ``stretch`` chunks, or the whole of a maximal run
    of narrower ranges (a one-block stretch); a wide range's items form
    one step, a stretch is a step alone, the steps follow the ranges in
    order, and each done-counter target is its step's item count."""
    _, _, _, _, tp = _factor(name)
    assert tp.solve_work.stretch == tr2.SOLVE_STRETCH_CHUNKS
    work = tr2.build_solve_work(tp.launch_starts, tp.nchunks, "cpu",
                                stretch=stretch)
    start, step, need = _items_of(work)
    assert start[0] == 0 and start[-1] == tp.nchunks
    assert (np.diff(start) > 0).all()
    assert step[0] == 0 and set(np.diff(step)) <= {0, 1}
    np.testing.assert_array_equal(need, np.bincount(step))
    assert work.width == need.max()
    ranges = [(lo, hi) for lo, hi in tp.launch_ranges() if hi > lo]
    narrow = [hi - lo <= stretch for lo, hi in ranges]
    r = 0
    for i in range(work.nitems):
        lo, hi = start[i], start[i + 1]
        while ranges[r][1] <= lo:
            r += 1
        if not narrow[r]:
            assert hi == lo + 1 and hi <= ranges[r][1]
            assert need[step[i]] == ranges[r][1] - ranges[r][0]
            continue
        # a stretch: whole narrow ranges, none narrow just outside it
        assert ranges[r][0] == lo and need[step[i]] == 1
        assert r == 0 or not narrow[r - 1]
        while ranges[r][1] < hi:
            r += 1
            assert narrow[r]
        assert ranges[r][1] == hi
        assert r + 1 == len(ranges) or not narrow[r + 1]
    if name == "chain" and stretch:
        assert work.nitems == 1            # every level is one chunk


def _run_work(tp, work, pane):
    """The solve in the work list's order: steps in order; in a step of
    many items each item gathers from the pane as the step found it (a
    snapshot), the items in reverse order; a stretch runs its chunks one
    after another on the live pane."""
    p = pane.clone().view(-1, tr2.LANES)
    start, step, _ = _items_of(work)
    for t in range(work.nsteps):
        items = np.flatnonzero(step == t)[::-1]
        src = p.clone() if len(items) > 1 else p
        for i in items:
            for k in range(start[i], start[i + 1]):
                tk.chunk_reference(
                    tp.tile[k:k + 1], tp.val[k:k + 1],
                    tp.slab_base[k:k + 1], tp.y_base[k:k + 1],
                    tp.src_flag[k:k + 1], None, src, p, g=tp.g,
                    dist_max=tp.dist_max, any_lane=tp.any_lane, ww=1,
                    rotated=False)
    return p


@pytest.mark.parametrize("name", list(FACTORS))
def test_solve_in_work_order_matches_plain(name):
    """Run in the work list's order, with a step's items unable to see
    each other's publishes, the solve agrees with the plain version:
    the steps' waits are all the order the solve needs."""
    a, levels, diag_pos, _, tp = _factor(name)
    _, lower, unit = FACTORS[name]
    m = a.shape[0]
    b = np.random.default_rng(7).standard_normal(m).astype(np.float32)
    d = np.ones(m, np.float32) if unit else np.asarray(a.values)[diag_pos]
    y0 = torch.from_numpy(b / d)
    rows = tk.solve_pane_rows(tp)
    pane = torch.nn.functional.pad(y0, (0, rows * tr2.LANES - m))
    want = to_np(tk.route2_solve_reference(tp, pane).view(-1)[:m])
    for stretch in (0, tr2.SOLVE_STRETCH_CHUNKS, 4):
        work = tr2.build_solve_work(tp.launch_starts, tp.nchunks, "cpu",
                                    stretch=stretch)
        got = to_np(_run_work(tp, work, pane).view(-1)[:m])
        assert_close(got, want, factor=256,
                     abs_floor=1e-6 * float(np.abs(want).max()))


def test_carried_and_refreshed_solve_plans_keep_a_work_list(monkeypatch):
    """A solve plan carried from JAX gets a work list over its own
    (conservative) launch starts; an SpMV plan gets none; a values
    re-bake carries the list."""
    a, levels, diag_pos, jp, tp = _factor("hub_rows")
    cp = interop.route2_plan_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in ROUTE_ARRAYS + (
            "ext_cols",)} | {"rho": None},
        {f: getattr(jp, f) for f in ROUTE_STATIC + (
            "row_window_mult", "has_hub", "rotated")}, device="cpu")
    start, _, _ = _items_of(cp.solve_work)
    ref = tr2.build_solve_work(cp.launch_starts, cp.nchunks, "cpu")
    np.testing.assert_array_equal(start, _items_of(ref)[0])
    assert cp.solve_work.nchunks == cp.nchunks
    refreshed = tp.update_solve_values(torch.from_numpy(
        np.array(a.values)))
    assert refreshed.solve_work is tp.solve_work
    u = port_csr(gen.generate_csr(300, 300, 3000, seed=3))
    sp_plan = tr2.build_route2_plan(u.rowptr, u.colind, u.values, u.shape,
                                    u.nnz, device="cpu")
    assert sp_plan.solve_work is None
    # the CUDA path refuses a plan without its work list before launching
    pane = torch.zeros(tk.solve_pane_rows(tp) * tr2.LANES)
    with monkeypatch.context() as mp:
        mp.setattr(tk._t, "on_cuda", lambda t: True)
        for bad in (None, tr2.build_solve_work((0,), 1, "cpu")):
            with pytest.raises(ValueError, match="work list"):
                tk.route2_solve_padded(dataclasses.replace(
                    tp, solve_work=bad), pane)


@pytest.mark.parametrize("name", ["tri3000", "hub_rows"])
def test_carried_solve_plan_splits_conservatively(name):
    """A JAX solve plan carried across as numpy (no level boundaries)
    gets launch starts from the pane conflicts alone (a launch ends where
    a chunk's slab meets a window the launch writes), and the plain
    solve over it agrees with the builder's plan."""
    a, levels, diag_pos, jp, tp = _factor(name)
    cp = interop.route2_plan_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in ROUTE_ARRAYS + (
            "ext_cols",)} | {"rho": None},
        {f: getattr(jp, f) for f in ROUTE_STATIC + (
            "row_window_mult", "has_hub", "rotated")}, device="cpu")
    assert len(cp.launch_starts) > 1
    m = a.shape[0]
    y0 = torch.from_numpy(np.random.default_rng(6).standard_normal(m)
                          .astype(np.float32) / np.asarray(a.values)[diag_pos])
    assert_close(to_np(tk.route2_solve(cp, y0)),
                 to_np(tk.route2_solve(tp, y0)), factor=256,
                 abs_floor=1e-7)


def test_plain_solve_matches_jax_interpret_kernel(monkeypatch):
    """A small forced solve through JAX's Pallas solve (interpret mode)
    and through the port's plain version."""
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")
    a, b, _, _ = _jax_case(True, False)
    jp = sp.triangular_solve_inspect(a, uplo="lower").plan
    tp = tsp.triangular_solve_inspect(port_csr(a), uplo="lower").plan
    y0 = b / np.asarray(a.values)[np.asarray(jp.route_diag)]
    want = np.asarray(jax_route2_solve(jp.route, jnp.asarray(y0),
                                       interpret=True))
    got = tk.route2_solve(tp.route, torch.from_numpy(y0))
    assert_close(to_np(got), want, factor=256, abs_floor=1e-4)


def test_route_solve_values_refresh_stays_on_route(monkeypatch):
    """New values on the inspected structure re-bake the coefficients on
    the values' device and stay on the substitution (the sweep must not
    run), explicit and unit diagonals."""
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")

    def boom(*args, **kw):
        raise AssertionError("a values change dropped to the ragged sweep")

    rng = np.random.default_rng(3)
    for unit, seed in ((False, 7), (True, 9)):
        a = gen.generate_triangular_csr(3000, seed=seed, lower=True,
                                        unit_diag=unit)
        ta = port_csr(a)
        diag = "unit" if unit else "explicit"
        info = tsp.triangular_solve_inspect(ta, uplo="lower", diag=diag)
        assert info.plan.route is not None
        assert (info.plan.route_dpe is None) == unit
        nnz = int(a.nnz)
        vals = to_np(ta.values).copy()
        vals[:nnz] *= (1.0 + 0.1 * rng.standard_normal(nnz)).astype(
            np.float32)
        ta2 = dataclasses.replace(ta, values=torch.from_numpy(vals))
        b = rng.standard_normal(3000).astype(np.float32)
        with monkeypatch.context() as mp:
            mp.setattr(ts, "_trsv_execute", boom)
            x = tsp.triangular_solve(ta2, torch.from_numpy(b), diag=diag,
                                     info=info)
        ref = spl.spsolve_triangular(_scipy(ta2, unit), b.astype(np.float64),
                                     lower=True)
        assert_close(to_np(x), ref, factor=256,
                     abs_floor=3e-5 * float(np.abs(ref).max()))
        _assert_backward(ta2, x, b, unit=unit)


def test_route_solve_grad_takes_the_sweep(monkeypatch):
    """b with requires_grad takes the differentiable sweep: the gradient
    of sum(x^2) is A^{-T} (2x)."""
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")
    a = gen.generate_triangular_csr(300, seed=5, lower=True)
    ta = port_csr(a)
    info = tsp.triangular_solve_inspect(ta, uplo="lower")
    assert info.plan.route is not None
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(300)
                         .astype(np.float32)).requires_grad_()
    called = []
    real = ts._trsv_execute
    monkeypatch.setattr(ts, "_trsv_execute",
                        lambda *args: called.append(1) or real(*args))
    x = tsp.triangular_solve(ta, b, info=info)
    (x * x).sum().backward()
    assert called
    A = _scipy(a)
    want = spl.spsolve_triangular(A.T.tocsr(), 2 * to_np(x).astype(
        np.float64), lower=False)
    np.testing.assert_allclose(to_np(b.grad), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    # values with requires_grad also take it, and get a gradient
    v = ta.values.clone().requires_grad_()
    x2 = tsp.triangular_solve(dataclasses.replace(ta, values=v),
                              b.detach(), info=info)
    x2.sum().backward()
    assert v.grad is not None and bool(torch.isfinite(v.grad).all())


def test_f64_and_complex_take_the_sweep(monkeypatch):
    """The dtype gate keeps f64 values off the f32 kernel (no plan is
    built), and a complex scale or a conjugated view takes the sweep."""
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")
    a = gen.generate_triangular_csr(200, seed=11, lower=True, density=0.05)
    ta = port_csr(a)
    t64 = dataclasses.replace(ta, values=ta.values.double())
    info = tsp.triangular_solve_inspect(t64)
    assert info.plan.route is None and info.plan.blocked is None
    b = np.random.default_rng(2).standard_normal(200)
    x = tsp.triangular_solve(t64, torch.from_numpy(b), info=info)
    ref = spl.spsolve_triangular(_scipy(a), b, lower=True)
    assert x.dtype == torch.float64
    np.testing.assert_allclose(to_np(x), ref, rtol=1e-10, atol=1e-14)
    info = tsp.triangular_solve_inspect(ta)
    assert info.plan.route is not None
    xc = tsp.triangular_solve(tsp.scaled(1j, ta),
                              torch.from_numpy(b.astype(np.float32)),
                              info=info)
    assert xc.dtype == torch.complex64
    assert_close(to_np(xc), ref / 1j, factor=1024, abs_floor=1e-4)


def test_deep_level_chain_route_solve(monkeypatch):
    """A 625-level chain (40,000 rows, blocks of 64) stays on the
    substitution: one launch range per level."""
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")
    a = gen.generate_block_chain_lower(40_000, block=64, deg=4, seed=3)
    ta = port_csr(a)
    info = tsp.triangular_solve_inspect(ta, uplo="lower")
    assert info.plan.num_levels == 40_000 // 64
    route = info.plan.route
    assert route is not None, "deep chain must stay on route"
    assert len(route.launch_starts) == info.plan.num_levels - 1
    b = np.random.default_rng(1).standard_normal(40_000).astype(np.float32)
    x = tsp.triangular_solve(ta, torch.from_numpy(b), info=info)
    assert np.abs(_scipy(a) @ to_np(x).astype(np.float64) - b).max() < 1e-3
    _assert_backward(a, x, b)


def test_solve_launch_splitting(monkeypatch):
    """Launch ranges past ``_SOLVE_CHUNKS_PER_DISPATCH`` chunks split
    into chained launches over the same pane; the solve is unchanged."""
    a, levels, diag_pos, _, tp = _factor("tri3000")
    y0 = torch.from_numpy(np.random.default_rng(2).standard_normal(3000)
                          .astype(np.float32) / np.asarray(a.values)[diag_pos])
    whole = tk.route2_solve(tp, y0)
    monkeypatch.setattr(tk, "_SOLVE_CHUNKS_PER_DISPATCH", 2)
    ranges = tk.solve_ranges(tp)
    assert len(ranges) > len(tp.launch_ranges())
    assert max(hi - lo for lo, hi in ranges) <= 2
    assert [lo for lo, _ in ranges][0] == 0 and ranges[-1][1] == tp.nchunks
    split = tk.route2_solve(tp, y0)
    assert_close(to_np(split), to_np(whole), factor=256, abs_floor=1e-7)


@pytest.fixture
def blocked_env(monkeypatch):
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")
    monkeypatch.setenv("SPBLAS_ROUTE_SOLVE_PANE_CAP", "4")
    monkeypatch.setenv("SPBLAS_BLOCK_SOLVE_ROWS", "512")


def _check_blocked(a, x, b, diag, alpha=1.0):
    """tests/test_block_solve.py's residual check, and the backward
    bound."""
    unit = diag == "unit"
    resid = np.abs(alpha * (_scipy(a, unit) @ to_np(x).astype(np.float64))
                   - b)
    assert resid.max() < 1e-3 * max(1.0, np.abs(b).max()), resid.max()
    _assert_backward(a, x, b, alpha=alpha, unit=unit)


@pytest.mark.parametrize("uplo", ["lower", "upper"])
@pytest.mark.parametrize("diag", ["explicit", "unit"])
def test_blocked_solve_oracle(blocked_env, uplo, diag):
    m = 1500
    a = gen.generate_triangular_csr(m, seed=1, lower=(uplo == "lower"),
                                    unit_diag=(diag == "unit"),
                                    density=0.004)
    ta = port_csr(a)
    info = tsp.triangular_solve_inspect(ta, uplo=uplo, diag=diag)
    blk = info.plan.blocked
    assert blk is not None, "blocked gate should fire"
    assert len(blk.subs) == 3 and info.plan.route is None
    assert all(s.route is not None for s in blk.subs)
    b = np.asarray(gen.generate_vector(m, seed=2))
    x = tsp.triangular_solve(ta, torch.from_numpy(b), uplo=uplo, diag=diag,
                             info=info)
    _check_blocked(a, x, b, diag)


def test_blocked_solve_scaled_and_refresh(blocked_env):
    m = 1200
    a = gen.generate_triangular_csr(m, seed=3, lower=True, density=0.004)
    ta = port_csr(a)
    info = tsp.triangular_solve_inspect(ta, uplo="lower")
    assert info.plan.blocked is not None
    b = np.asarray(gen.generate_vector(m, seed=4))
    x = tsp.triangular_solve(tsp.scaled(2.0, ta), torch.from_numpy(b),
                             info=info)
    _check_blocked(a, x, b, "explicit", alpha=2.0)
    # numeric re-run with new values, same sparsity
    ta2 = dataclasses.replace(ta, values=ta.values * 1.5)
    x2 = tsp.triangular_solve(ta2, torch.from_numpy(b), info=info)
    _check_blocked(ta2, x2, b, "explicit")


def test_blocked_matches_ragged(blocked_env):
    m = 1100
    a = gen.generate_triangular_csr(m, seed=5, lower=True, density=0.004)
    ta = port_csr(a)
    info = tsp.triangular_solve_inspect(ta, uplo="lower")
    assert info.plan.blocked is not None
    b = torch.from_numpy(np.asarray(gen.generate_vector(m, seed=6)))
    x_blk = tsp.triangular_solve(ta, b, info=info)
    plan_r = dataclasses.replace(info.plan, blocked=None)
    x_rag = tsp.triangular_solve(ta, b, info=info.update(plan=plan_r))
    np.testing.assert_allclose(to_np(x_blk), to_np(x_rag), rtol=2e-4,
                               atol=2e-4)

"""spblas_tpu_torch paned ROUTE2 against the JAX package: bit-equal plans
on the geometries of ``tests/test_route_paned.py``, the kernel's plain
version per panel against the JAX package's exact ROUTE2 simulator
(``route2_spmv_numpy``) and, on one small plan, against its Pallas
kernel in interpret mode; values refresh with the aux carriers kept; the
budget guard; the plans carried across from JAX; and the slice end to
end, on the same seeded numpy inputs.

Tolerance: the per-row 64*eps*(|A|.|x|) of ``tests/torch_util.py``,
since the plain version's ``index_add_`` (and the CUDA kernel's atomics)
sum a row in another order than the sequential simulator."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spblas_tpu as sp
from spblas_tpu.kernels import plans as jplans
from spblas_tpu.kernels import route2 as jr2
from spblas_tpu.kernels import route_paned as jpn
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import plans as tplans
from spblas_tpu_torch.kernels import route_paned as tpn
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    assert_rows_close, port_csr, one_torch_thread)

PANEL_ARRAYS = ("tile", "val", "sb", "yb", "fl", "eva", "evb", "evw", "evs",
                "src_pos", "src_idx", "rho")
PANEL_STATIC = ("rows", "out_rows", "has_aux", "dist_max", "any_lane",
                "rotated")
PLAN_STATIC = ("shape", "g", "pane_rows", "x_rows_pad", "fill",
               "row_window_mult")


def _scipy(a):
    nnz = int(a.nnz)
    return sps.csr_matrix((np.asarray(a.values)[:nnz],
                           np.asarray(a.colind)[:nnz], np.asarray(a.rowptr)),
                          shape=a.shape)


def _hub_rows(seed, hubs):
    """tests/test_route_paned.py's hub-row matrix: 12,000 scattered
    entries and rows of degree 1500 (aux chunks in their panels)."""
    m, n = 3000, 2000
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, m, 12_000)]
                          + [np.full(1500, h) for h in hubs])
    cols = rng.integers(0, n, len(rows))
    a = sps.coo_matrix((rng.uniform(0, 1, len(rows)).astype(np.float32),
                        (rows, cols)), shape=(m, n)).tocsr()
    a.sum_duplicates()
    return a


def _generated(m, n, nnz, seed):
    return _scipy(gen.generate_csr(m, n, nnz, seed=seed))


def _empty_panels():
    """Entries in the first 1000 of 3072 rows only: the later panels
    hold one group of zero chunks each, which must add nothing."""
    a = _generated(1000, 1500, 8_000, 6)
    return sps.vstack([a, sps.csr_matrix((2072, 1500), dtype=np.float32)],
                      format="csr")


# name -> (matrix, builder keywords)
FIXTURES = {
    "multi_pane_multi_panel": (
        lambda: _generated(5000, 6000, 40_000, 0),
        dict(g=1, panel_rows=1024, pane_rows=16)),
    "hub_rows_aux": (lambda: _hub_rows(2, (7, 2049)),
                     dict(g=1, panel_rows=1024, pane_rows=16)),
    "uneven_last_panel": (lambda: _generated(2500, 1500, 6_000, 3),
                          dict(g=1, panel_rows=2048, pane_rows=32)),
    "empty_panels": (_empty_panels,
                     dict(g=1, panel_rows=1024, pane_rows=16)),
    "g2": (lambda: _generated(4096, 4096, 30_000, 4),
           dict(g=2, panel_rows=2048, pane_rows=32)),
    "supercell": (lambda: _generated(40_960, 40_960, 120_000, 7),
                  dict(panel_rows=16_384, pane_rows=256)),
    # degree 1 at 80k rows: starved supercell panels pack rotated
    "rotated": (lambda: _generated(80_000, 80_000, 80_000, 1),
                dict(panel_rows=16_384, pane_rows=256)),
}


def _plans(name):
    """(scipy CSR, JAX plan, port plan on the CPU)."""
    make, kw = FIXTURES[name]
    a = make()
    args = (a.indptr, a.indices, a.data, a.shape, a.nnz)
    return (a, jpn.build_route_paned_plan(*args, **kw),
            tpn.build_route_paned_plan(*args, device="cpu", **kw))


def _carried(jp):
    panels = [({f: np.asarray(getattr(p, f)) for f in PANEL_ARRAYS},
               {f: getattr(p, f) for f in PANEL_STATIC}) for p in jp.panels]
    return interop.route_paned_plan_from_numpy(
        panels, {f: getattr(jp, f) for f in PLAN_STATIC}, device="cpu")


def _x(a, seed=11):
    return np.random.default_rng(seed).standard_normal(
        a.shape[1]).astype(np.float32)


def _ref_csr(a):
    return types.SimpleNamespace(shape=a.shape, nnz=a.nnz, rowptr=a.indptr,
                                 colind=a.indices, values=a.data)


def _panel_route2_plan(plan, panel):
    """One panel as a JAX Route2Plan for ``route2_spmv_numpy``: flag-0
    slabs at their absolute x row, flag-1 slabs in the panel pane."""
    pane = panel.pane.numpy().astype(np.int64)
    fl = panel.fl.numpy()
    sb = panel.sb.numpy() + np.where(fl == 0, pane * plan.pane_rows, 0)
    return jr2.Route2Plan(
        tile=panel.tile.numpy(), val=panel.val.numpy(),
        slab_base=sb.astype(np.int32), y_base=panel.yb.numpy(),
        src_flag=fl, val_src=None, ext_cols=np.zeros(0, np.int32),
        g=plan.g, shape=(panel.rows, plan.shape[1]), nat_slots=0,
        x_rows=plan.x_rows_pad, y_rows=panel.out_rows, aux_rows=0,
        n_aux_chunks=0, fill=0.0, dist_max=panel.dist_max,
        any_lane=panel.any_lane, row_window_mult=plan.row_window_mult,
        rho=panel.rho.numpy(), rotated=panel.rotated)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plan_bit_equal_to_jax(name):
    _, jp, tp = _plans(name)
    assert len(tp.panels) == len(jp.panels)
    for jq, tq in zip(jp.panels, tp.panels):
        for f in PANEL_ARRAYS:
            want, got = np.asarray(getattr(jq, f)), getattr(tq, f).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, f
            assert np.array_equal(got, want), f
        for f in PANEL_STATIC:
            assert getattr(tq, f) == getattr(jq, f), f
    for f in PLAN_STATIC:
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.nchunks == jp.nchunks
    if name == "hub_rows_aux":
        assert any(len(p.launch_starts) > 1 for p in tp.panels)
    if name == "empty_panels":
        assert all(p.nchunks == 8 and not p.tile.any()
                   for p in tp.panels[1:])
    if name == "supercell":
        assert tp.row_window_mult > 1 and len(tp.panels) > 1
    if name == "rotated":
        assert any(p.rotated for p in tp.panels)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plain_version_matches_simulator(name):
    """Each panel's plain version against JAX's sequential ROUTE2
    simulator on that panel, and the whole product against the matrix."""
    a, _, tp = _plans(name)
    x = _x(a)
    x2 = tpn.pack_x2(tp, torch.from_numpy(x))
    r0 = 0
    for p in tp.panels:
        got = tpn.route_paned_spmv_padded(tp, p, x2).view(-1)[:p.rows]
        want = jr2.route2_spmv_numpy(_panel_route2_plan(tp, p), x)
        assert_rows_close(got, want, _ref_csr(a[r0:r0 + p.rows]), x,
                          err_msg=f"{name} panel at row {r0}")
        r0 += p.rows
    y = tpn.route_paned_spmv(tp, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (a.shape[0],)
    assert_rows_close(y, a.astype(np.float64) @ x.astype(np.float64),
                      _ref_csr(a), x)


def test_launch_starts_split_the_flag_runs():
    """The recorded starts: the flag-0 run first, then one start per aux
    level, each on a flag-1 chunk; one launch over a panel with aux
    levels does not give the simulator's answer."""
    a, _, tp = _plans("hub_rows_aux")
    x = _x(a, seed=12)
    x2 = tpn.pack_x2(tp, torch.from_numpy(x))
    checked = 0
    for p in tp.panels:
        fl = p.fl.numpy()
        starts = p.launch_starts
        assert starts[0] == 0
        if len(starts) == 1:
            continue
        assert (fl[:starts[1]] == 0).all() and (fl[starts[1]:] == 1).all()
        want = jr2.route2_spmv_numpy(_panel_route2_plan(tp, p), x)
        one = dataclasses.replace(p, launch_starts=(0,))
        y = tpn.route_paned_spmv_padded(tp, one, x2).view(-1)[:p.rows]
        assert not np.allclose(y.numpy(), want, rtol=1e-3, atol=1e-3)
        checked += 1
    assert checked


def test_plain_version_matches_interpret_kernel():
    """One small plan (two panels, several panes) through JAX's Pallas
    kernel in interpret mode."""
    a, jp, tp = _plans("g2")
    x = _x(a, seed=13)
    want = jpn.route_paned_spmv(jp, jnp.asarray(x), interpret=True)
    assert_rows_close(tpn.route_paned_spmv(tp, torch.from_numpy(x)), want,
                      _ref_csr(a), x)


def test_update_values_keeps_aux_carriers():
    """Values refresh gives JAX's values bit for bit, keeps the aux
    chunks' baked 1.0 carriers, and the refreshed plan the refreshed
    matrix's product; the old plan keeps the old values."""
    a, jp, tp = _plans("hub_rows_aux")
    new = (a.data * -0.5 + 2.0).astype(np.float32)
    jnew = jp.update_values(jnp.asarray(new))
    got = tp.update_values(torch.from_numpy(new))
    for jq, tq in zip(jnew.panels, got.panels):
        assert np.array_equal(tq.val.numpy(), np.asarray(jq.val))
    x = _x(a, seed=14)
    b = a.copy()
    b.data = new
    assert_rows_close(tpn.route_paned_spmv(got, torch.from_numpy(x)),
                      b.astype(np.float64) @ x.astype(np.float64),
                      _ref_csr(b), x)
    assert_rows_close(tpn.route_paned_spmv(tp, torch.from_numpy(x)),
                      a.astype(np.float64) @ x.astype(np.float64),
                      _ref_csr(a), x)


def test_budget_guard_and_estimate(monkeypatch):
    """The estimate is JAX's, and a budget of 1 byte sends both choosers'
    paned rung to None."""
    for args in ((4_000_000, 4_000_000, 40_000_000), (3000, 2000, 15_000)):
        assert tpn.estimate_paned_bytes(*args) == \
            jpn.estimate_paned_bytes(*args)
    a = gen.generate_csr(3000, 2000, 15_000, seed=7)
    monkeypatch.setattr(jplans, "_ROUTE_PANED_BUDGET", 1)
    monkeypatch.setattr(tplans, "_ROUTE_PANED_BUDGET", 1)
    assert jplans._try_route_paned(a) is None
    assert tplans._try_route_paned(port_csr(a)) is None


@pytest.mark.parametrize("name", ["hub_rows_aux", "multi_pane_multi_panel",
                                  "rotated"])
def test_carried_plan_gives_the_builders_metadata(name):
    """A plan carried from JAX derives each chunk's pane from the event
    streams (the builder's own, exactly) and its launch starts
    conservatively (the builder's, or a finer split), and gives the same
    product."""
    a, jp, tp = _plans(name)
    carried = _carried(jp)
    for p, q in zip(tp.panels, carried.panels):
        assert np.array_equal(q.pane.numpy(), p.pane.numpy())
        assert set(p.launch_starts) <= set(q.launch_starts)
    x = _x(a, seed=15)
    want = a.astype(np.float64) @ x.astype(np.float64)
    assert_rows_close(tpn.route_paned_spmv(carried, torch.from_numpy(x)),
                      want, _ref_csr(a), x)


def test_main_path_matches_jax(monkeypatch):
    """The slice end to end: with the ladder's CUDA probe forced and the
    VMEM rows made small in both packages, a general matrix takes
    route_paned with JAX's plan, and multiply(scaled(2.0, matrix_opt(A)),
    x) matches JAX's multiply(scaled(2.0, A), x)."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    monkeypatch.setattr(jplans, "_on_tpu", lambda: True)
    monkeypatch.setattr(jplans, "_ROUTE_VMEM_ROWS", 10)
    monkeypatch.setattr(tplans, "_ROUTE_VMEM_ROWS", 10)
    a = gen.generate_csr(3000, 2000, 15_000, seed=5)
    x = gen.generate_vector(2000, seed=6)
    opt = tsp.matrix_opt(port_csr(a))
    y = tsp.multiply(tsp.scaled(2.0, opt), torch.from_numpy(x))
    kind, plan = opt._plans["matvec"]
    jkind, jplan = jplans.build_matvec_plan(a)
    assert kind == jkind == "route_paned"
    for jq, tq in zip(jplan.panels, plan.panels):
        assert np.array_equal(tq.tile.numpy(), np.asarray(jq.tile))
    assert y.dtype == torch.float32
    want = sp.multiply(sp.scaled(2.0, a), jnp.asarray(x))
    assert_rows_close(y, want, a, x, scale=2.0)

"""spblas_tpu_torch ROUTE2 against the JAX package: bit-equal plans, the
kernel's plain version against the JAX package's exact numpy simulator
(``route2_spmv_numpy``), values refresh, launch starts, the chooser, and
the slice end to end, on the same seeded numpy inputs.

The JAX Pallas kernel is not run here (its interpret-mode compile costs
more than the suite can spare); ``route2_spmv_numpy`` is the JAX
package's own plain reference of it.  Tolerance: the per-row
64*eps*(|A|.|x|) of ``tests/torch_util.py``, since the plain version's
``index_add_`` (and the CUDA kernel's atomics) sum a row in another
order than the sequential simulator."""

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
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import plans as tplans
from spblas_tpu_torch.kernels import route2 as tr2
from spblas_tpu_torch.kernels import route2_kernel as tk
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    assert_rows_close, port_csr, one_torch_thread)

ARRAYS = ("tile", "val", "slab_base", "y_base", "src_flag", "val_src",
          "ext_cols", "rho")
STATIC = ("g", "shape", "nat_slots", "x_rows", "y_rows", "aux_rows",
          "n_aux_chunks", "fill", "dist_max", "any_lane",
          "row_window_mult", "has_hub", "rotated")


def _coo(m, n, rows, cols, seed):
    v = np.random.default_rng(seed).standard_normal(len(rows))
    a = sps.coo_matrix((v.astype(np.float32), (rows, cols)),
                       shape=(m, n)).tocsr()
    a.sum_duplicates()
    return a


def _uniform(m, n, nnz, seed):
    rng = np.random.default_rng(seed)
    return _coo(m, n, rng.integers(0, m, nnz), rng.integers(0, n, nnz),
                seed + 1)


def _generated(m, nnz, seed):
    a = gen.generate_csr(m, m, nnz, seed=seed)
    return sps.csr_matrix((np.array(a.values)[:nnz],
                           np.array(a.colind)[:nnz], np.array(a.rowptr)),
                          shape=(m, m))


def _hub_row(seed, hub):
    """One row of degree ``hub`` over a sparse remainder (aux spill)."""
    rng = np.random.default_rng(seed)
    m = 2048
    rows = np.concatenate([np.zeros(hub, np.int64),
                           rng.integers(0, m, 2000)])
    cols = np.concatenate([rng.permutation(m)[:hub],
                           rng.integers(0, m, 2000)])
    return _coo(m, m, rows, cols, seed + 1)


def _hub_split():
    """Three dense rows (degree 2000) over 30k scattered entries."""
    rng = np.random.default_rng(13)
    m = 16_384
    rows = np.concatenate([np.repeat([5, 4000, 12_001], 2000),
                           rng.integers(0, m, 30_000)])
    cols = np.concatenate([rng.permutation(m)[:2000] for _ in range(3)]
                          + [rng.integers(0, m, 30_000)])
    return _coo(m, m, rows, cols, 14)


def _window_major_spill():
    """Rows of degree 90 in 16 of every 128 lanes overflow their cells'
    chunk budget, which repacks window-major into aux-publishing
    chunks."""
    rng = np.random.default_rng(0)
    m = 12_288
    deg = np.where(np.arange(m) % 128 < 16, 90, 12)
    rows = np.repeat(np.arange(m), deg)
    return _coo(m, m, rows, rng.integers(0, m, len(rows)), 1)


# name -> (matrix, builder keywords); the fixtures of tests/test_route2.py
FIXTURES = {
    "classic": (lambda: _uniform(2000, 1500, 20_000, 77), {}),
    "starved_supercell": (lambda: _uniform(40_000, 40_000, 25_000, 79), {}),
    "rotated": (lambda: _generated(20_000, 100_000, 1),
                dict(row_window_mult=8, rotate=True)),
    "any_lane": (lambda: _uniform(2000, 1500, 20_000, 77),
                 dict(any_lane=True)),
    "hub_row_aux": (lambda: _hub_row(4, 1500), {}),
    "aux_carriers": (lambda: _hub_row(21, 1200), {}),
    "window_major_spill": (_window_major_spill, {}),
    "hub_deg_256": (_hub_split, dict(hub_deg=256)),
    "hub_deg_256_ww8": (_hub_split, dict(hub_deg=256, row_window_mult=8)),
    "single": (lambda: sps.csr_matrix(([2.5], ([3], [60])), shape=(64, 64),
                                      dtype=np.float32), {}),
    "empty": (lambda: sps.csr_matrix((64, 64), dtype=np.float32), {}),
}
AUX = ("hub_row_aux", "aux_carriers", "window_major_spill", "classic")


def _plans(name):
    """(scipy CSR, JAX plan, port plan on the CPU)."""
    make, kw = FIXTURES[name]
    a = make()
    args = (a.indptr, a.indices, a.data, a.shape, a.nnz)
    return (a, jr2.build_route2_plan(*args, **kw),
            tr2.build_route2_plan(*args, device="cpu", **kw))


def _carried(jp):
    """The JAX plan carried across as numpy."""
    arrays = {f: None if getattr(jp, f) is None else np.asarray(
        getattr(jp, f)) for f in ARRAYS}
    return interop.route2_plan_from_numpy(
        arrays, {f: getattr(jp, f) for f in STATIC}, device="cpu")


def _x(a, seed=5):
    return np.random.default_rng(seed).standard_normal(
        a.shape[1]).astype(np.float32)


def _ref_csr(a):
    """A scipy CSR in the fields ``assert_rows_close`` reads."""
    return types.SimpleNamespace(shape=a.shape, nnz=a.nnz, rowptr=a.indptr,
                                 colind=a.indices, values=a.data)


@pytest.mark.parametrize("name", ["rotated", "hub_row_aux",
                                  "window_major_spill", "empty"])
def test_slab_work_groups_each_range_by_slab(name):
    """The slab-staged kernel's work list (``route2.build_slab_work``,
    every range taken) against a plain loop over the JAX plan's
    ``slab_base``: each launch range's chunks once, by slab in ascending
    order and in stream order within a slab, cut into items of at most
    ``SLAB_ITEM`` chunks of one slab.  The built and the carried plans
    hold it for the ranges of ``SLAB_MIN_CHUNKS`` chunks or more, and a
    value update carries it unchanged."""
    _, jp, tp = _plans(name)
    sb = np.asarray(jp.slab_base)
    ranges = tp.launch_ranges()
    work = tr2.build_slab_work(sb, tp.launch_starts, "cpu", min_chunks=0)
    assert len(work) == len(ranges)
    sb = sb.tolist()
    for (lo, hi), (order, starts) in zip(ranges, work):
        want_order, want_starts = [], [0]
        for v in sorted(set(sb[lo:hi])):
            ks = [k for k in range(lo, hi) if sb[k] == v]
            for i in range(0, len(ks), tr2.SLAB_ITEM):
                want_order += ks[i:i + tr2.SLAB_ITEM]
                want_starts.append(len(want_order))
        assert order.dtype == starts.dtype == torch.int32
        assert order.tolist() == want_order
        assert starts.tolist() == want_starts
    for plan in (tp, _carried(jp)):
        big = [hi - lo >= tr2.SLAB_MIN_CHUNKS
               for lo, hi in plan.launch_ranges()]
        assert [w is not None for w in plan.slab_work] == big
    nnz = int(tp.val_src.max()) + 1
    assert tp.update_values(torch.ones(max(nnz, 1))).slab_work \
        is tp.slab_work


def test_slab_work_past_the_threshold():
    """A plan whose first launch range reaches ``SLAB_MIN_CHUNKS`` (the
    uniform 160k degree-10 matrix) carries that range's work list, every
    chunk of the range once; the wrapper's lookup refuses a plan whose
    launch starts no longer match it."""
    a = _generated(160_000, 1_600_000, 3)
    tp = tr2.build_route2_plan(a.indptr, a.indices, a.data, a.shape, a.nnz,
                               device="cpu")
    (lo, hi), *aux = tp.launch_ranges()
    assert hi - lo >= tr2.SLAB_MIN_CHUNKS
    order, starts = tp.slab_work[0]
    want = tr2.slab_items(tp.slab_base.numpy(), lo, hi)
    assert np.array_equal(order.numpy(), want[0])
    assert np.array_equal(starts.numpy(), want[1])
    assert sorted(order.tolist()) == list(range(lo, hi))
    assert all(w is None for w in tp.slab_work[1:])
    assert tk._slab_work(tp, 0, hi - lo) is tp.slab_work[0]
    short = dataclasses.replace(tp, launch_starts=(0, hi - 1))
    with pytest.raises(ValueError, match="slab work list"):
        tk._slab_work(short, 0, hi - 1)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plan_bit_equal_to_jax(name):
    _, jp, tp = _plans(name)
    for f in ARRAYS:
        want, got = getattr(jp, f), getattr(tp, f)
        if want is None:
            assert got is None, f
            continue
        want, got = np.asarray(want), got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
    for f in STATIC:
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plain_version_matches_numpy_simulator(name):
    """The plain version on the port's own plan and on the carried JAX
    plan, against JAX's sequential kernel simulator."""
    a, jp, tp = _plans(name)
    x = _x(a)
    want = jr2.route2_spmv_numpy(jp, x)
    for plan in (tp, _carried(jp)):
        y = tk.route2_spmv(plan, torch.from_numpy(x))
        assert y.dtype == torch.float32 and y.shape == (a.shape[0],)
        assert_rows_close(y, want, _ref_csr(a), x, err_msg=name)
    # the port's numpy simulator is the JAX one
    assert np.array_equal(tr2.route2_spmv_numpy(tp, x), want)


@pytest.mark.parametrize("name", ["aux_carriers", "hub_deg_256", "rotated"])
def test_update_values_bit_equal_to_jax(name):
    """Values refresh keeps the baked slots (val_src < 0: aux carriers
    1.0, padding 0) and gives JAX's values bit for bit."""
    a, jp, tp = _plans(name)
    new = np.random.default_rng(9).standard_normal(a.nnz).astype(np.float32)
    want = np.asarray(jp.update_values(jnp.asarray(new)).val)
    got = tp.update_values(torch.from_numpy(new))
    assert np.array_equal(got.val.numpy(), want)
    same = tp.update_values(torch.from_numpy(a.data))
    assert np.array_equal(same.val.numpy(), tp.val.numpy())
    b = a.copy()
    b.data = new
    x = _x(a)
    assert_rows_close(tk.route2_spmv(got, torch.from_numpy(x)),
                      jr2.route2_spmv_numpy(
                          jp.update_values(jnp.asarray(new)), x),
                      _ref_csr(b), x)


@pytest.mark.parametrize("name", AUX)
def test_launch_starts_give_the_simulator_answer(name):
    """The recorded starts (one per aux level) and the starts derived for
    a carried plan both give the sequential answer; one launch over
    every chunk does not, wherever aux levels exist."""
    a, jp, tp = _plans(name)
    assert tp.launch_starts[0] == 0
    assert len(tp.launch_starts) > 1 or tp.n_aux_chunks == 0
    if tp.n_aux_chunks:
        aux = np.flatnonzero(tp.src_flag.numpy() == 1)
        assert tp.launch_starts[1] == aux[0]
        assert tp.nchunks - tp.launch_starts[1] == tp.n_aux_chunks
    carried = _carried(jp)
    assert carried.launch_starts[:2] == tp.launch_starts[:2]
    x = _x(a, seed=6)
    want = jr2.route2_spmv_numpy(jp, x)
    for plan in (tp, carried):
        assert_rows_close(tk.route2_spmv(plan, torch.from_numpy(x)), want,
                          _ref_csr(a), x, err_msg=str(plan.launch_starts))
    if len(tp.launch_starts) > 2:
        import dataclasses
        one = dataclasses.replace(tp, launch_starts=(0, tp.launch_starts[1]))
        y = tk.route2_spmv(one, torch.from_numpy(x)).numpy()
        assert not np.allclose(y, want, rtol=1e-3, atol=1e-3)


def _jax_csr(a):
    return sp.CSR.from_arrays(a.data, a.indptr, a.indices, a.shape,
                              nnz=a.nnz)


@pytest.mark.parametrize("case", ["uniform", "hub_heavy", "paned"])
def test_try_route_kind_matches_jax(case, monkeypatch):
    """The port's _try_route picks JAX's kind with JAX's plan: "route"
    (ROUTE2) on a uniform matrix, ROUTE v1 on hub-heavy rows, and paned
    ROUTE2 past the VMEM rows (made small here in both packages)."""
    if case == "hub_heavy":
        a = gen.generate_rmat_csr(4096, 4096 * 16, seed=5)
        a = sps.csr_matrix((np.array(a.values)[:a.nnz],
                            np.array(a.colind)[:a.nnz],
                            np.array(a.rowptr)), shape=a.shape)
    else:
        a = _uniform(3000, 3000, 24_000, 3)
    if case == "paned":
        monkeypatch.setattr(jplans, "_ROUTE_VMEM_ROWS", 40)
        monkeypatch.setattr(tplans, "_ROUTE_VMEM_ROWS", 40)
    jkind, jplan = jplans._try_route(_jax_csr(a))
    kind, plan = tplans._try_route(port_csr(_jax_csr(a)))
    want = {"uniform": "route", "hub_heavy": "route1",
            "paned": "route_paned"}[case]
    assert jkind.startswith(want) and kind == jkind
    if case == "uniform":
        pairs = [(jplan.tile, plan.tile)]
    elif case == "paned":
        pairs = [(jq.tile, tq.tile)
                 for jq, tq in zip(jplan.panels, plan.panels)]
    elif kind == "route1":
        pairs = [(jplan.tile1, plan.tile1), (jplan.tile3, plan.tile3)]
    else:
        pairs = [(jplan.base.tile1, plan.base.tile1),
                 (jplan.unperm.tile, plan.unperm.tile)]
    for want_t, got_t in pairs:
        assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    x = _x(a)
    assert_rows_close(tplans.plan_spmv((kind, plan), torch.from_numpy(x)),
                      a.astype(np.float64) @ x.astype(np.float64),
                      _ref_csr(a), x)


@pytest.mark.parametrize("complex_", [False, True])
def test_main_path_route_matches_jax(complex_, monkeypatch):
    """The slice end to end: with the ladder's CUDA probe forced, a CPU
    matrix takes the route (f32) or route_cx (complex64) rung, and
    multiply(scaled(2.0, matrix_opt(A)), x) matches JAX's
    multiply(scaled(2.0, A), x)."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    a = gen.generate_csr(2500, 2500, 20_000, seed=8, complex_=complex_)
    x = gen.generate_vector(2500, seed=9, complex_=complex_)
    opt = tsp.matrix_opt(port_csr(a))
    y = tsp.multiply(tsp.scaled(2.0, opt), torch.from_numpy(x))
    assert opt._plans["matvec"][0] == ("route_cx" if complex_ else "route")
    assert y.dtype == (torch.complex64 if complex_ else torch.float32)
    want = sp.multiply(sp.scaled(2.0, a), jnp.asarray(x))
    assert_rows_close(y, want, a, x, scale=2.0)


# ------------------------------------------------------------------ #
# the complex product over one ROUTE2 plan (route_cx, kind route)
# ------------------------------------------------------------------ #

CX_CASES = ("hub_row_aux", "aux_carriers", "rotated", "hub_deg_256_ww8")


def _cx_plans(name):
    """(complex scipy CSR, real plan, imaginary plan, the complex
    kernel's imaginary plane) on the CPU."""
    make, kw = FIXTURES[name]
    a = make()
    im = np.random.default_rng(17).standard_normal(a.nnz).astype(np.float32)
    pr = tr2.build_route2_plan(a.indptr, a.indices, a.data, a.shape, a.nnz,
                               device="cpu", **kw)
    pi = pr.update_values(torch.from_numpy(im))
    ac = sps.csr_matrix((a.data + 1j * im, a.indices, a.indptr),
                        shape=a.shape).astype(np.complex64)
    return ac, pr, pi, tk.cx_imag_plane(pr, pi)


@pytest.mark.parametrize("name", CX_CASES)
def test_cx_imag_plane_zero_only_at_carriers(name):
    """The complex kernel's imaginary plane is ``pi.val`` with 0 at every
    slot that holds no entry: it differs from ``pi`` only at val_src < 0
    slots, and there only where ``pi`` carries a nonzero (the aux
    carriers' 1.0)."""
    _, pr, pi, vi = _cx_plans(name)
    diff = (vi != pi.val).numpy()
    src = pr.val_src.numpy()
    assert (src[diff] < 0).all()
    assert (vi.numpy()[src < 0] == 0).all()
    assert np.array_equal(vi.numpy()[src >= 0], pi.val.numpy()[src >= 0])
    if pr.n_aux_chunks:
        assert diff.any() and (pi.val.numpy()[diff] == 1.0).all()


@pytest.mark.parametrize("x_kind", ["complex", "real"])
@pytest.mark.parametrize("name", CX_CASES)
def test_cx_plain_matches_four_applies(name, x_kind):
    """One pass of the complex plain version (the complex kernel's
    arithmetic) against the four-apply composition of the real plain
    version, (ax - by) + i(ay + bx), and against the float64 product, on
    plans with aux levels, hub chunks and a rotated supercell plan; a
    real x takes the same pass."""
    ac, pr, pi, vi = _cx_plans(name)
    assert pr.n_aux_chunks > 0 or pr.rotated or pr.has_hub
    rng = np.random.default_rng(23)
    x = rng.standard_normal(ac.shape[1]).astype(np.float32)
    if x_kind == "complex":
        x = (x + 1j * rng.standard_normal(ac.shape[1])).astype(np.complex64)
    xt = torch.from_numpy(x)
    y = tk.route2_cx_spmv(pr, vi, xt)
    assert y.dtype == torch.complex64 and y.shape == (ac.shape[0],)
    xr = xt.real.float() if xt.is_complex() else xt
    if xt.is_complex():
        xi = xt.imag.float()
        four = torch.complex(
            tk.route2_spmv(pr, xr) - tk.route2_spmv(pi, xi),
            tk.route2_spmv(pr, xi) + tk.route2_spmv(pi, xr))
    else:
        four = torch.complex(tk.route2_spmv(pr, xr), tk.route2_spmv(pi, xr))
    ref = types.SimpleNamespace(shape=ac.shape, nnz=ac.nnz,
                                rowptr=ac.indptr, colind=ac.indices,
                                values=ac.data)
    # the four-apply sum rounds each of its two products, so it is held
    # to the bound of both planes' magnitudes, as the complex pass is
    assert_rows_close(y, four, ref, x, factor=128)
    assert_rows_close(y, ac.astype(np.complex128) @ x.astype(np.complex128),
                      ref, x)


def test_cx_padded_rejects_bad_operands():
    """The complex wrapper checks the pane's dtype and the plane's shape
    before it runs anything."""
    _, pr, _, vi = _cx_plans("hub_row_aux")
    x2 = tk.pack_x2(pr, torch.ones(pr.shape[1], dtype=torch.complex64))
    assert x2.dtype == torch.complex64
    with pytest.raises(TypeError):
        tk.route2_cx_spmv_padded(pr, vi, x2.to(torch.complex128))
    with pytest.raises(ValueError):
        tk.route2_cx_spmv_padded(pr, vi[:-1], x2)

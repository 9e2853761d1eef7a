"""spblas_tpu_torch ROUTE v1 against the JAX package: bit-equal plans
(through the recursive aux plan), the kernel's plain version against the
JAX package's exact numpy simulator (``route_spmv_numpy``) and, on one
small plan, against its Pallas kernel in interpret mode; the one-launch
layout (rebased bases, ``V1Layout``) and the plain version of the
kernel's order over it; values refresh; the degree-sorted rung and the
ROUTE2 fill guard of the chooser; and the slice end to end, on the same
seeded numpy inputs.

Tolerance: the per-row 64*eps*(|A|.|x|) of ``tests/torch_util.py``,
since the plain version's ``index_add_`` (and the CUDA kernel's atomics)
sum a row in another order than the sequential simulator."""

import dataclasses
import types
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spblas_tpu as sp
from spblas_tpu.kernels import plans as jplans
from spblas_tpu.kernels import route2 as jr2
from spblas_tpu.kernels import route_plan as jrp
from spblas_tpu.kernels import route_spmv as jrs
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import plans as tplans
from spblas_tpu_torch.kernels import route_plan as trp
from spblas_tpu_torch.kernels import route_spmv as trs
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    assert_rows_close, port_csr, one_torch_thread)

SUBS = trp.SUBS

ARRAYS = ("tile1", "tile3", "val", "slab_base", "y_base", "val_src",
          "hot_cols")
STATIC = ("g", "shape", "x_rows", "y_rows", "aux_len", "n_pad", "fill")
R2_ARRAYS = ("tile", "val", "slab_base", "y_base", "src_flag", "val_src",
             "ext_cols", "rho")
R2_STATIC = ("g", "shape", "nat_slots", "x_rows", "y_rows", "aux_rows",
             "n_aux_chunks", "fill", "dist_max", "any_lane",
             "row_window_mult", "has_hub", "rotated")


def _scipy(a):
    """A JAX CSR as a scipy CSR of its live entries."""
    nnz = int(a.nnz)
    return sps.csr_matrix((np.asarray(a.values)[:nnz],
                           np.asarray(a.colind)[:nnz], np.asarray(a.rowptr)),
                          shape=a.shape)


def _adversarial():
    """tests/test_route_plan.py's adversarial rows: a dense row 7, empty
    rows, a long row 11 and hot column 13."""
    m = n = 600
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.full(n // 2, 7), rng.integers(0, m, 800),
                           np.full(300, 11)])
    cols = np.concatenate([rng.permutation(n)[: n // 2], np.full(800, 13),
                           rng.permutation(n)[:300]])
    a = sps.coo_matrix((rng.standard_normal(len(rows)).astype(np.float32),
                        (rows, cols)), shape=(m, n)).tocsr()
    a.sum_duplicates()
    return a


def _generated(m, n, nnz, seed):
    return _scipy(gen.generate_csr(m, n, nnz, seed=seed))


# name -> (matrix, builder keywords)
FIXTURES = {
    "uniform": (lambda: _generated(1000, 1000, 10_000, 1000), {}),
    "adversarial": (_adversarial, {}),
    "g1": (lambda: _generated(500, 3000, 4000, 77), dict(g=1)),
    "g2": (lambda: _generated(500, 3000, 4000, 77), dict(g=2)),
    "g3": (lambda: _generated(500, 3000, 4000, 77), dict(g=3)),
    "empty": (lambda: sps.csr_matrix((64, 64), dtype=np.float32), {}),
    "rmat_2048": (lambda: _scipy(gen.generate_rmat_csr(2048, 2048 * 16,
                                                       seed=5)), {}),
}


def _plans(name):
    """(scipy CSR, JAX plan, port plan on the CPU)."""
    make, kw = FIXTURES[name]
    a = make()
    args = (a.indptr, a.indices, a.data, a.shape, a.nnz)
    return (a, jrp.build_route_plan(*args, **kw),
            trp.build_route_plan(*args, device="cpu", **kw))


def _assert_bit_equal(jp, tp, fields, static, path="plan"):
    for f in fields:
        want, got = getattr(jp, f), getattr(tp, f)
        if want is None:
            assert got is None, (path, f)
            continue
        want, got = np.asarray(want), got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (path, f)
        assert np.array_equal(got, want), (path, f)
    for f in static:
        assert getattr(tp, f) == getattr(jp, f), (path, f)


def _levels(jp, tp):
    """Compare two v1 plans through the aux recursion; returns the depth."""
    depth = 0
    while True:
        _assert_bit_equal(jp, tp, ARRAYS, STATIC, f"level {depth}")
        assert (jp.aux_plan is None) == (tp.aux_plan is None), depth
        if jp.aux_plan is None:
            return depth
        jp, tp, depth = jp.aux_plan, tp.aux_plan, depth + 1


def _carry_numpy(jp):
    """A JAX v1 plan as the (arrays, static) pair interop takes."""
    arrays = {f: np.asarray(getattr(jp, f)) for f in ARRAYS}
    arrays["aux_plan"] = None if jp.aux_plan is None \
        else _carry_numpy(jp.aux_plan)
    return arrays, {f: getattr(jp, f) for f in STATIC}


def _carry_r2_numpy(jp):
    arrays = {f: None if getattr(jp, f) is None else np.asarray(
        getattr(jp, f)) for f in R2_ARRAYS}
    return arrays, {f: getattr(jp, f) for f in R2_STATIC}


def _x(a, seed=5):
    return np.random.default_rng(seed).standard_normal(
        a.shape[1]).astype(np.float32)


def _ref_csr(a):
    """A scipy CSR in the fields ``assert_rows_close`` reads."""
    return types.SimpleNamespace(shape=a.shape, nnz=a.nnz, rowptr=a.indptr,
                                 colind=a.indices, values=a.data)


def _jax_csr(a):
    return sp.CSR.from_arrays(a.data, a.indptr, a.indices, a.shape,
                              nnz=a.nnz)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plan_bit_equal_to_jax(name):
    _, jp, tp = _plans(name)
    depth = _levels(jp, tp)
    if name == "rmat_2048":
        assert depth >= 1 and tp.hot_cols.numel() == 67
    if name == "adversarial":
        assert 13 in tp.hot_cols.tolist()
    if name.startswith("g"):
        assert tp.g == int(name[1])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plain_version_matches_numpy_simulator(name):
    """The plain version on the port's own plan and on the carried JAX
    plan, against JAX's sequential kernel simulator; the port's numpy
    simulator is the JAX one."""
    a, jp, tp = _plans(name)
    x = _x(a)
    want = jrp.route_spmv_numpy(jp, x)
    carried = interop.route_plan_from_numpy(*_carry_numpy(jp), device="cpu")
    for plan in (tp, carried):
        y = trs.route_spmv(plan, torch.from_numpy(x))
        assert y.dtype == torch.float32 and y.shape == (a.shape[0],)
        assert_rows_close(y, want, _ref_csr(a), x, err_msg=name)
    assert np.array_equal(trp.route_spmv_numpy(tp, x), want)


def test_plain_version_matches_interpret_kernel():
    """One small plan through JAX's Pallas kernel in interpret mode."""
    a, jp, tp = _plans("g2")
    x = _x(a, seed=6)
    want = jrs.route_spmv(jp, jnp.asarray(x), interpret=True)
    assert_rows_close(trs.route_spmv(tp, torch.from_numpy(x)), want,
                      _ref_csr(a), x)


def _assert_layout(plan):
    """The one-launch layout of a root plan: level ends count the chunks
    (the done counters' targets), the x regions follow the y region back
    to back, each as large as the aux windows of the level before and
    its own packed x; fused_sb / fused_yb are slab_base / y_base rebased
    into the buffer, every window inside its region."""
    lay, levels = plan.layout, trp.plan_levels(plan)
    assert lay.nlevels == len(levels)
    assert all(p.layout is None for p in levels[1:])
    assert list(lay.level_ends) == list(np.cumsum([p.nchunks
                                                   for p in levels]))
    assert lay.x_offs[0] == 0 and lay.src_rows[0] == plan.x_rows
    off = plan.y_rows
    for d in range(1, len(levels)):
        assert lay.x_offs[d] == off
        off += max(levels[d - 1].aux_rows, levels[d].x_rows)
        assert lay.src_rows[d] == off
    assert lay.buf_rows == off
    for d, p in enumerate(levels):
        assert p.fused_sb.dtype == p.fused_yb.dtype == torch.int32
        sb, yb, fsb, fyb = (t.numpy().astype(np.int64) for t in (
            p.slab_base, p.y_base, p.fused_sb, p.fused_yb))
        assert np.array_equal(fsb, sb + lay.x_offs[d])
        aux = yb >= plan.y_rows
        assert np.array_equal(fyb[~aux], yb[~aux])
        assert (fyb[~aux] + SUBS <= plan.y_rows).all()
        if aux.any():
            assert np.array_equal(fyb[aux], yb[aux] - plan.y_rows
                                  + lay.x_offs[d + 1])
            assert (fyb[aux] + SUBS <= lay.src_rows[d + 1]).all()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fused_layout_and_order(name):
    """The builder's plan and the one carried from JAX carry the same
    layout.  The plain version of the kernel's order (every chunk, level
    by level, into one buffer) gives the numpy simulator's y, and leaves
    in each level's x region exactly the packed x the level-by-level
    plain version hands that level: the aux windows land as packed."""
    a, jp, tp = _plans(name)
    carried = interop.route_plan_from_numpy(*_carry_numpy(jp), device="cpu")
    assert carried.layout == tp.layout
    for p, q in zip(trp.plan_levels(tp), trp.plan_levels(carried)):
        assert torch.equal(p.fused_sb, q.fused_sb)
        assert torch.equal(p.fused_yb, q.fused_yb)
    _assert_layout(tp)
    x = _x(a, seed=8)
    x2 = trs.pack_x(tp, torch.from_numpy(x))
    buf = trs.route_spmv_fused_reference(tp, x2)
    assert buf.shape == (tp.layout.buf_rows, trp.LANES)
    assert_rows_close(buf.view(-1)[:a.shape[0]], jrp.route_spmv_numpy(jp, x),
                      _ref_csr(a), x, err_msg=name)
    lay, levels = tp.layout, trp.plan_levels(tp)
    xd = x2
    for d in range(1, len(levels)):
        prev = levels[d - 1]
        start = prev.y_rows * trp.LANES
        pane = trs.route_spmv_reference(prev, xd).view(-1)
        xd = trs.pack_x(levels[d], pane[start:start + prev.aux_len])
        region = buf[lay.x_offs[d]:lay.src_rows[d]].reshape(-1)
        assert torch.equal(region[:xd.numel()], xd), (name, d)
        assert not region[xd.numel():].any(), (name, d)


def test_fused_layout_of_a_level_and_its_limits():
    """A level taken out of its chain has no layout until it is laid out
    anew, and then gives the level-by-level answer; a level past the
    first with hot columns (the level before would have to publish
    replicas) is refused."""
    a, _, tp = _plans("uniform")
    assert tp.aux_plan is not None and tp.aux_plan.layout is None
    xa = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tp.aux_plan.shape[1]).astype(np.float32))
    x2 = trs.pack_x(tp.aux_plan, xa)
    with pytest.raises(ValueError, match="no one-launch layout"):
        trs.route_spmv_fused_reference(tp.aux_plan, x2)
    level = trp.fuse_levels(tp.aux_plan)
    got = trs.route_spmv_fused_reference(level, x2).view(-1)
    want = trs.route_spmv_chain_reference(level, x2)
    assert torch.allclose(got[:want.numel()], want, rtol=1e-6, atol=1e-6)
    hot = dataclasses.replace(tp.aux_plan,
                              hot_cols=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="hot columns"):
        trp.fuse_levels(dataclasses.replace(tp, aux_plan=hot))


def test_pack_x_matches_numpy():
    """The packed pane (hot-column replicas included) is the numpy
    simulator's pane bit for bit."""
    a, _, tp = _plans("rmat_2048")
    x = _x(a, seed=7)
    want = trp.pack_x(x, tp).reshape(-1)
    assert np.array_equal(trs.pack_x(tp, torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", ["rmat_2048", "adversarial"])
def test_update_values_bit_equal_to_jax(name):
    """Values refresh gives JAX's values bit for bit, and the refreshed
    plan the refreshed matrix's product."""
    a, jp, tp = _plans(name)
    new = np.random.default_rng(9).standard_normal(a.nnz).astype(np.float32)
    jnew = jp.update_values(jnp.asarray(new))
    got = tp.update_values(torch.from_numpy(new))
    assert np.array_equal(got.val.numpy(), np.asarray(jnew.val))
    same = tp.update_values(torch.tensor(a.data))
    assert np.array_equal(same.val.numpy(), tp.val.numpy())
    b = a.copy()
    b.data = new
    x = _x(a)
    assert_rows_close(trs.route_spmv(got, torch.from_numpy(x)),
                      jrp.route_spmv_numpy(jnew, x), _ref_csr(b), x)


def _rmat_args():
    a = _scipy(gen.generate_rmat_csr(2048, 2048 * 16, seed=3))
    return a, (a.indptr, a.indices, a.data, a.shape[0], a.shape[1], a.nnz)


@pytest.mark.parametrize("forced", [False, True])
def test_try_route_sorted_matches_jax(forced, monkeypatch):
    """With the dispatch overhead at its value both packages keep plain
    v1 on R-MAT 2048; patched far below it in both, both take
    route1_sorted, with bit-equal base and un-permute plans."""
    a, (rp, ci, vv, m, n, nnz) = _rmat_args()
    if forced:
        monkeypatch.setattr(jplans, "_SORTED_DISPATCH_NS", -10 ** 12)
        monkeypatch.setattr(tplans, "_SORTED_DISPATCH_NS", -10 ** 12)
    jplain = jrp.build_route_plan(rp, ci, vv, (m, n), nnz)
    tplain = trp.build_route_plan(rp, ci, vv, (m, n), nnz, device="cpu")
    jk, jp = jplans._try_route_sorted(rp, ci, vv, m, n, nnz, jplain)
    tk, tp = tplans._try_route_sorted(rp, ci, vv, m, n, nnz, tplain,
                                      device="cpu")
    assert tk == jk == ("route1_sorted" if forced else "route1")
    x = _x(a)
    if not forced:
        assert tp is tplain
        return
    _levels(jp.base, tp.base)
    _assert_bit_equal(jp.unperm, tp.unperm, R2_ARRAYS, R2_STATIC, "unperm")
    assert np.array_equal(tp.entry_perm.numpy(), np.asarray(jp.entry_perm))
    assert tp.nchunks == jp.nchunks and tp.fill == jp.fill
    want = jr2.route2_spmv_numpy(jp.unperm, jrp.route_spmv_numpy(jp.base, x))
    carried = interop.sorted_route_plan_from_numpy(
        _carry_numpy(jp.base), _carry_r2_numpy(jp.unperm),
        np.asarray(jp.entry_perm), device="cpu")
    for plan in (tp, carried):
        y = tplans.plan_spmv(("route1_sorted", plan), torch.from_numpy(x))
        assert_rows_close(y, want, _ref_csr(a), x)
    # values refresh keeps the permuted entry mapping
    y2 = tplans.plan_spmv(("route1_sorted", tp.update_values(
        2.0 * torch.tensor(a.data))), torch.from_numpy(x))
    assert_rows_close(y2, 2.0 * want, _ref_csr(a), x, scale=2.0)


def test_fill_guard_matrix_kind_matches_jax():
    """tests/test_route_chooser.py's fill-guard matrix (rows of degree 24
    in one narrow column window, under the hub metric): the port's
    ``_try_route`` gives JAX's kind and plan, and its product."""
    rng = np.random.default_rng(3)
    m = 4096
    rows = np.repeat(np.arange(0, m, 4), 24)
    cols = rng.integers(0, 512, len(rows))
    v = rng.standard_normal(len(rows)).astype(np.float32)
    a = sps.coo_matrix((v, (rows, cols)), shape=(m, m)).tocsr()
    a.sum_duplicates()
    jk, jp = jplans._try_route(_jax_csr(a))
    tk, tp = tplans._try_route(port_csr(_jax_csr(a)))
    assert tk == jk
    if jk == "route1":
        _levels(jp, tp)
        want = jrp.route_spmv_numpy(jp, _x(a))
    else:
        _assert_bit_equal(jp, tp, R2_ARRAYS, R2_STATIC)
        want = jr2.route2_spmv_numpy(jp, _x(a))
    x = _x(a)
    assert_rows_close(tplans.plan_spmv((tk, tp), torch.from_numpy(x)), want,
                      _ref_csr(a), x)


def _hub_heavy_c64():
    """R-MAT 2048 with complex64 values."""
    a = _scipy(gen.generate_rmat_csr(2048, 2048 * 16, seed=5))
    rng = np.random.default_rng(17)
    a.data = (a.data + 1j * rng.uniform(0, 100, a.nnz)).astype(np.complex64)
    return a


@pytest.mark.parametrize("case", ["route1", "route1_sorted", "route_cx"])
def test_main_path_matches_jax(case, monkeypatch):
    """The slice end to end: with the ladder's CUDA probe forced (and
    JAX's TPU gate, so both choosers run the same ladder), R-MAT 2048
    takes route1, route1_sorted with the dispatch overhead patched away,
    and a complex64 R-MAT route_cx over v1; multiply(scaled(2.0,
    matrix_opt(A)), x) matches JAX's multiply(scaled(2.0, A), x)."""
    monkeypatch.setattr(tplans, "_on_cuda", lambda t: True)
    monkeypatch.setattr(jplans, "_on_tpu", lambda: True)
    if case == "route1_sorted":
        monkeypatch.setattr(jplans, "_SORTED_DISPATCH_NS", -10 ** 12)
        monkeypatch.setattr(tplans, "_SORTED_DISPATCH_NS", -10 ** 12)
    a = _jax_csr(_hub_heavy_c64() if case == "route_cx"
                 else _scipy(gen.generate_rmat_csr(2048, 2048 * 16, seed=5)))
    cx = case == "route_cx"
    x = gen.generate_vector(2048, seed=9, complex_=cx)
    opt = tsp.matrix_opt(port_csr(a))
    y = tsp.multiply(tsp.scaled(2.0, opt), torch.from_numpy(x))
    kind, plan = opt._plans["matvec"]
    jkind, jplan = jplans.build_matvec_plan(a)
    assert kind == jkind == case
    if cx:
        assert plan[0] == jplan[0] == "route1"
        _levels(jplan[1], plan[1])
        _levels(jplan[2], plan[2])
    assert y.dtype == (torch.complex64 if cx else torch.float32)
    want = sp.multiply(sp.scaled(2.0, a), jnp.asarray(x))
    assert_rows_close(y, want, a, x, scale=2.0)


def test_wrapper_checks_operands():
    """The wrapper raises on what the kernel does not take."""
    _, _, tp = _plans("uniform")
    x2 = trs.pack_x(tp, torch.zeros(tp.shape[1]))
    with pytest.raises(ValueError, match="bad shapes"):
        trs.route_spmv_padded(tp, x2[:-1])
    with pytest.raises(TypeError, match="float32"):
        trs.route_spmv_padded(tp, x2.double())
    with mock.patch.object(trs, "route_spmv_chain_reference") as ref:
        trs.route_spmv_padded(tp, x2)
    assert ref.called and trs.route_spmv_padded.launches == 0

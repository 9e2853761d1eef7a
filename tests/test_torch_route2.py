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

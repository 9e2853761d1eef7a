"""spblas_tpu_torch.utils.serialize against spblas_tpu.utils.serialize:
one ``.npz`` layout, so a plan saved by either package loads in the
other.  Each of JAX's plan kinds (tests/test_serialize.py: ell, dia,
trsv, trsv with ROUTE, spgemm (with its ROUTE2-mul engine), paned,
permuted band, band, BSR SpGEMM, a ROUTE2 plan missing later static
fields) goes port -> port, JAX -> port and port -> JAX, and the loaded
plan's result is held to the saving plan's.

Tolerances: port -> port gives the same bits; across the packages the
two sum in different orders, so SpMV results agree per row within
64 eps_f32 (|A|.|x|), the SpGEMM values (all positive) within 64 eps_f32
relative, the triangular solves within rtol 1e-4 and atol 1e-5 (each
level's rounding feeds the next, as tests/test_serialize.py holds the
JAX package's own round trip to 1e-5), and the block SpGEMM plans' pair
lists exactly.
"""

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spblas_tpu as jsp
from spblas_tpu.formats.bsr import BSR as JaxBSR
from spblas_tpu.kernels import banded as jbanded
from spblas_tpu.kernels import dia as jdia
from spblas_tpu.kernels import ell as jell
from spblas_tpu.kernels import route2 as jroute2
from spblas_tpu.kernels import route2_kernel as jr2k
from spblas_tpu.kernels import route_paned as jpaned
from spblas_tpu.utils import generate as gen
from spblas_tpu.utils import serialize as jser

import spblas_tpu_torch as tsp
from spblas_tpu_torch.kernels import banded, bsr_spgemm as tbsg, dia, ell
from spblas_tpu_torch.kernels import route2 as troute2
from spblas_tpu_torch.kernels import route2_kernel as tr2k
from spblas_tpu_torch.kernels import route_paned as tpaned
from spblas_tpu_torch.utils import serialize as tser

# the JAX package's kernels map gives its bsr_spgemm function under the
# submodule's name
jbsg = importlib.import_module("spblas_tpu.kernels.bsr_spgemm")

from tests.torch_util import (EPS32, assert_rows_close,  # noqa: F401
                              one_torch_thread, port_csr, to_np)


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _spmv_case(ja, jplan, tplan, japply, tapply, seed):
    x = _x(ja.shape[1], seed)

    def check(got, want, exact):
        if exact:
            assert torch.equal(got, want)
        else:
            assert_rows_close(got, want, ja, x)
    return dict(jplan=jplan, tplan=tplan,
                jrun=lambda p: japply(p, jnp.asarray(x)),
                trun=lambda p: tapply(p, torch.from_numpy(x)), check=check)


def _ell():
    ja = gen.generate_csr(50, 60, 400, seed=0)
    return _spmv_case(ja, jell.build_ell_plan(ja),
                      ell.build_ell_plan(port_csr(ja)), jell.ell_spmv,
                      ell.ell_spmv, 1)


def _dia():
    ja = gen.generate_banded_csr(64, 64, 3, seed=2)
    return _spmv_case(ja, jdia.build_dia_plan(ja),
                      dia.build_dia_plan(port_csr(ja)), jdia.dia_spmv,
                      dia.dia_spmv, 3)


def _trsv(route):
    m = 600 if route else 80
    jl = gen.generate_triangular_csr(m, seed=11 if route else 4, lower=True)
    tl = port_csr(jl)
    jinfo = jsp.triangular_solve_inspect(jl, uplo="lower")
    tinfo = tsp.triangular_solve_inspect(tl, uplo="lower")
    assert (jinfo.plan.route is not None) == route
    assert (tinfo.plan.route is not None) == route
    b = _x(m, 5)

    def check(got, want, exact):
        if exact:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-4,
                                       atol=1e-5)
    return dict(
        jplan=jinfo.plan, tplan=tinfo.plan,
        jrun=lambda p: jsp.triangular_solve(
            jl, jnp.asarray(b), uplo="lower",
            info=dataclasses.replace(jinfo, plan=p)),
        trun=lambda p: tsp.triangular_solve(
            tl, torch.from_numpy(b), uplo="lower",
            info=dataclasses.replace(tinfo, plan=p)), check=check)


def _spgemm():
    ja = gen.generate_csr(40, 40, 300, seed=6)
    jb = gen.generate_csr(40, 40, 300, seed=7)
    ta, tb = port_csr(ja), port_csr(jb)
    jinfo = jsp.multiply_compute(ja, jb)
    tinfo = tsp.multiply_compute(ta, tb)
    assert tinfo.plan.route is not None
    assert tinfo.plan.route.expansion is not None

    def check(got, want, exact):
        if exact:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(to_np(got), to_np(want),
                                       rtol=64 * EPS32)
    return dict(
        jplan=jinfo.plan, tplan=tinfo.plan,
        jrun=lambda p: jsp.multiply_fill(
            jinfo.update(plan=p), ja, jb).todense(),
        trun=lambda p: tsp.multiply_fill(
            tinfo.update(plan=p), ta, tb).todense(), check=check)


def _paned():
    m = 20_000
    values, rowptr, colind = gen.generate_csr_arrays(m, m, 10 * m, seed=9)
    nnz = int(rowptr[-1])
    kw = dict(panel_rows=8192, pane_rows=4096)
    jplan = jpaned.build_route_paned_plan(rowptr, colind, values, (m, m),
                                          nnz, **kw)
    tplan = tpaned.build_route_paned_plan(rowptr, colind, values, (m, m),
                                          nnz, **kw, device="cpu")
    x = _x(m, 1)
    dense_abs = None

    def check(got, want, exact):
        if exact:
            assert torch.equal(got, want)
            return
        nonlocal dense_abs
        if dense_abs is None:
            rows = np.repeat(np.arange(m), np.diff(rowptr))
            dense_abs = np.bincount(rows, weights=np.abs(
                values[:nnz].astype(np.float64) * x[colind[:nnz]]),
                minlength=m)
        err = np.abs(to_np(got)[:m].astype(np.float64)
                     - to_np(want)[:m])
        assert (err <= 64 * EPS32 * dense_abs).all()
    return dict(jplan=jplan, tplan=tplan,
                jrun=lambda p: jpaned.route_paned_spmv(p, jnp.asarray(x)),
                trun=lambda p: tpaned.route_paned_spmv(
                    p, torch.from_numpy(x)), check=check)


def _permuted_band():
    ja = gen.generate_banded_csr(200, 200, 9, seed=12)
    jplan = jbanded.build_permuted_band_plan(ja)
    tplan = banded.build_permuted_band_plan(
        port_csr(ja), perm=np.asarray(jplan.perm)[:200])
    return _spmv_case(
        ja, jplan, tplan,
        lambda p, x: jbanded.permuted_band_spmv(p, x, interpret=True),
        banded.permuted_band_spmv, 13)


def _band():
    ja = gen.generate_banded_csr(256, 256, 7, seed=14)
    tplan = banded.build_band_plan(port_csr(ja))
    assert tplan.tf32_exact   # a cached gate travels with the port plan
    return _spmv_case(ja, jbanded.build_band_plan(ja), tplan,
                      lambda p, x: jbanded.band_spmv(p, x, interpret=True),
                      banded.band_spmv, 15)


def _bsr_spgemm():
    rng = np.random.default_rng(16)
    da = np.zeros((32, 256), np.float32)
    da[:8, :128] = rng.standard_normal((8, 128))
    db = np.zeros((256, 256), np.float32)
    db[:128, :128] = rng.standard_normal((128, 128))
    ja, jb = JaxBSR.from_dense(da, (8, 128)), JaxBSR.from_dense(db, (128, 128))
    ta = tsp.BSR.from_dense(da, (8, 128), device="cpu")
    tb = tsp.BSR.from_dense(db, (128, 128), device="cpu")

    def check(got, want, exact):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), to_np(w))
    return dict(jplan=jbsg.bsr_spgemm_compute(ja, jb),
                tplan=tbsg.bsr_spgemm_compute(ta, tb),
                jrun=lambda p: (p.pair_ptr, p.pair_a, p.pair_b, p.c_colind),
                trun=lambda p: (p.pair_ptr, p.pair_a, p.pair_b, p.c_colind),
                check=check)


def _route2_legacy():
    ja = gen.generate_csr(300, 300, 2000, seed=11)
    args = (np.asarray(ja.rowptr), np.asarray(ja.colind),
            np.asarray(ja.values), (300, 300), int(ja.nnz))
    jplan = jroute2.build_route2_plan(*args)
    tplan = troute2.build_route2_plan(*args, device="cpu")
    assert jplan.row_window_mult == 1 and not jplan.has_hub \
        and not jplan.any_lane
    return dict(_spmv_case(ja, jplan, tplan, jr2k.route2_spmv,
                           tr2k.route2_spmv, 12),
                strip=("row_window_mult", "has_hub", "any_lane",
                       "dist_max"))


KINDS = {"ell": _ell, "dia": _dia, "trsv": lambda: _trsv(False),
         "trsv_route": lambda: _trsv(True), "spgemm": _spgemm,
         "paned": _paned, "permuted_band": _permuted_band, "band": _band,
         "bsr_spgemm": _bsr_spgemm, "route2_missing_static": _route2_legacy}
ENV = {"trsv_route": ("SPBLAS_FORCE_ROUTE_TRSV",),
       "spgemm": ("SPBLAS_FORCE_ROUTE_SPGEMM",)}
_cases = {}


def _strip(path, keys):
    """A file as an older writer left it: ``keys`` gone from its static
    fields."""
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    static = json.loads(str(payload["__static__"]))
    for k in keys:
        static.pop(k, None)
    payload["__static__"] = np.str_(json.dumps(static))
    np.savez(path, **payload)


@pytest.mark.parametrize("direction", ["port_port", "jax_port", "port_jax"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plan_round_trip(kind, direction, tmp_path, monkeypatch):
    # the ROUTE engines these plans were built under
    for var in ENV.get(kind, ()):
        monkeypatch.setenv(var, "1")
    if kind not in _cases:
        c = _cases[kind] = KINDS[kind]()
        c["tres"] = c["trun"](c["tplan"])
        c["jres"] = c["jrun"](c["jplan"])
    c = _cases[kind]
    path = str(tmp_path / f"{kind}.npz")
    src = "jax" if direction == "jax_port" else "port"
    (jser if src == "jax" else tser).save_plan(
        path, c["jplan"] if src == "jax" else c["tplan"])
    if "strip" in c:
        _strip(path, c["strip"])
    if direction == "port_jax":
        loaded = jser.load_plan(path)
        assert type(loaded).__name__ == type(c["jplan"]).__name__
        c["check"](c["jrun"](loaded), c["tres"], False)
        return
    loaded = tser.load_plan(path, device="cpu")
    assert type(loaded) is type(c["tplan"])
    got = c["trun"](loaded)
    if direction == "port_port":
        c["check"](got, c["tres"], True)
    else:
        c["check"](got, c["jres"], False)
    if kind == "band":
        # the cached gate comes back with a port file; a JAX file's is
        # made again on first use
        assert ("tf32_gate" in loaded.__dict__) == (src == "port")
        assert loaded.tf32_gate == c["tplan"].tf32_gate
    if kind == "spgemm":
        # a JAX file carries no expansion stream: the CUDA fill refuses
        # such a plan (mul_fill.plan_stream)
        assert (loaded.route.expansion is None) == (src == "jax")


def test_legacy_single_level_file_loads_in_both(tmp_path):
    """The older single-level layout (``__class__``, ``__static__`` and
    one array a field) loads in both packages to the same plan."""
    c = _dia()
    plan = c["jplan"]
    path = str(tmp_path / "legacy.npz")
    np.savez(path, __class__=np.str_("spblas_tpu.kernels.dia:DiaPlan"),
             __static__=np.str_(json.dumps({
                 "offsets": {"__tuple__": list(plan.offsets)},
                 "shape": {"__tuple__": list(plan.shape)}})),
             diags=np.asarray(plan.diags))
    jplan, tplan = jser.load_plan(path), tser.load_plan(path, device="cpu")
    assert tplan.offsets == tuple(plan.offsets) == jplan.offsets
    assert torch.equal(c["trun"](tplan), c["trun"](c["tplan"]))
    np.testing.assert_array_equal(np.asarray(c["jrun"](jplan)),
                                  np.asarray(c["jrun"](plan)))


def test_interop_carries_trsv_and_spgemm_plans(monkeypatch):
    """The plans ``load_plan`` returns that carry a nested engine plan
    (TrsvPlan over a ROUTE2 solve plan, SpgemmPlan over a ROUTE2-mul
    plan) also come across from the JAX package's arrays by
    ``utils.interop``; the port then gives the results its own plans
    give (the solve within the stated tolerance, the fill bit for bit on
    the CPU)."""
    from spblas_tpu_torch.utils import interop
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_TRSV", "1")
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")

    def fields(p, names):
        return {k: None if getattr(p, k) is None else np.asarray(getattr(p, k))
                for k in names}

    def static(p, names):
        return {k: getattr(p, k) for k in names}

    c = _trsv(True)
    jp = c["jplan"]
    r = jp.route
    route = interop.route2_plan_from_numpy(
        fields(r, ("tile", "val", "slab_base", "y_base", "src_flag",
                   "val_src", "ext_cols", "rho")),
        static(r, ("g", "shape", "nat_slots", "x_rows", "y_rows",
                   "aux_rows", "n_aux_chunks", "fill", "dist_max",
                   "any_lane", "row_window_mult", "has_hub", "rotated")),
        device="cpu")
    tp = interop.trsv_plan_from_numpy(
        fields(jp, ("ent_idx", "ent_col", "ent_slot", "lv_estart", "row_ids",
                    "diag_idx", "lv_rstart", "route_diag", "route_dpe")),
        static(jp, ("e_cap", "r_cap", "uplo", "unit_diag", "m")),
        route=route, device="cpu")
    c["check"](c["trun"](tp), c["trun"](c["tplan"]), False)
    c = _spgemm()
    jp = c["jplan"]
    r = jp.route
    route = interop.route2_mul_plan_from_numpy(
        fields(r, ("tile1", "tile2", "a_base", "b_base", "src_flag",
                   "y_base")),
        static(r, ("g_a", "g_b", "a_rows", "b_rows", "y_rows", "aux_rows",
                   "n_aux_chunks", "capacity", "fill", "dist_max")),
        device="cpu")
    tp = interop.spgemm_plan_from_numpy(
        fields(jp, ("src_a", "src_b", "is_d", "valid", "slot", "c_rowptr",
                    "c_colind", "c_nnz")),
        static(jp, ("shape", "has_d", "a_capacity", "b_capacity",
                    "d_capacity")), route=route, device="cpu")
    c["check"](c["trun"](tp), c["trun"](c["tplan"]), True)

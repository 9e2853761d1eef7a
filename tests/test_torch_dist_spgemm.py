"""The port's distributed SpGEMM (``spblas_tpu_torch.parallel.spgemm``)
against the JAX package's, on the CPU.

One gloo world of 4 ranks serves the module (``parallel/launch.py``,
tasks in ``tests/torch_dist_cases.py``); the JAX side runs on a mesh of
4 of the 8 faked CPU devices.  Plans and the forced per-rank mul engine
(every panel's arrays, their padding to the largest rank's chunk count
included) are held bit-equal to slice ``[rank]`` of JAX's; C within
64·eps·(|A|·|B|) per entry of JAX's C, for a numeric and for a reuse on
new values.  Each call to the world has its own 60 s limit.
"""

import dataclasses

import jax
import numpy as np
import pytest

import spblas_tpu.parallel as jpar
from spblas_tpu.utils import generate as gen

from spblas_tpu_torch.parallel.launch import World
from tests import torch_dist_cases as cases
from tests.torch_util import (  # noqa: F401
    EPS32, abs_spgemm, csr_dense, one_torch_thread)

P = 4
LIMIT = 60.0


@pytest.fixture(scope="module")
def world():
    w = World(P, backend="gloo", device="cpu", threads=1, timeout=LIMIT,
              start_timeout=LIMIT)
    w.start()
    yield w
    w.close()


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_row_mesh(devices=jax.devices()[:P])


def run(world, fn, *args):
    if not world.alive:
        world.start()
    return world.run(fn, *args, timeout=LIMIT)


def assert_slots_close(got, want, plan, r, bound, err_msg=""):
    """Rank r's C values within 64·eps of ``want`` per slot, the bound
    taken at each slot's (row, col) of the dense |A|·|B|."""
    rowptr = np.asarray(plan.c_rowptr)[r].astype(np.int64)
    nnz = int(rowptr[-1])
    rows = r * plan.mloc + np.repeat(np.arange(plan.mloc), np.diff(rowptr))
    cols = np.asarray(plan.c_colind)[r][:nnz]
    lim = 64 * EPS32 * bound[rows, cols]
    err = np.abs(got[:nnz].astype(np.float64) - want[:nnz])
    assert (err <= lim).all(), f"{err_msg} rank {r}: {(err > lim).sum()} " \
        f"slots out of bound"
    assert not got[nnz:].any()


def jax_plan(a, b, jmesh, monkeypatch, engine, panel_slots=None):
    if engine:
        monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    if panel_slots:
        monkeypatch.setenv("SPBLAS_DIST_MUL_PANEL_SLOTS", str(panel_slots))
    ar, br = jpar.partition_rowblock(a, jmesh), \
        jpar.partition_rowblock(b, jmesh)
    plan = jpar.dist_spgemm_compute(ar, br, jmesh)
    monkeypatch.delenv("SPBLAS_FORCE_ROUTE_SPGEMM", raising=False)
    monkeypatch.delenv("SPBLAS_DIST_MUL_PANEL_SLOTS", raising=False)
    return ar, br, plan


def check(out, a, b, ar, br, plan, jmesh):
    """Plans bit-equal, C and the reuse on 2A within the bound of JAX's."""
    arrays = {k: np.asarray(getattr(plan, k)) for k in cases.SPGEMM_FIELDS}
    numeric = jax.jit(lambda p, a, b: jpar.dist_spgemm_numeric(
        p, a, b, jmesh).values)          # one compile for both numerics
    c = np.asarray(numeric(plan, ar, br))
    ar2 = dataclasses.replace(ar, values=ar.values * 2.0)
    c2 = np.asarray(numeric(plan, ar2, br))
    bound = abs_spgemm(a, b)
    for r, o in enumerate(out):
        for k, v in arrays.items():
            np.testing.assert_array_equal(o["plan"][k], v[r], err_msg=k)
        assert o["c_nnz"] == int(np.asarray(plan.c_nnz)[r])
        assert o["result_nnz"] == plan.result_nnz
        assert_slots_close(o["c"], c[r], plan, r, bound, "C")
        assert_slots_close(o["c2"], c2[r], plan, r, 2 * bound, "reuse")
        if "c2_carried" in o:
            assert_slots_close(o["c2_carried"], c2[r], plan, r, 2 * bound,
                               "carried")
    return arrays


DIMS = [(64, 64, 64, 512, 512), (100, 40, 70, 600, 500)]


@pytest.mark.parametrize("m,k,n,nnz_a,nnz_b", DIMS)
def test_dist_spgemm_torch_numeric_matches_jax(world, jmesh, monkeypatch,
                                               m, k, n, nnz_a, nnz_b):
    """Without the engine (CPU, not forced): the gather maps and C
    structure bit-equal to JAX's, the torch numeric within bound."""
    a = gen.generate_csr(m, k, nnz_a, seed=5)
    b = gen.generate_csr(k, n, nnz_b, seed=6)
    ar, br, plan = jax_plan(a, b, jmesh, monkeypatch, engine=False)
    assert plan.engine is None
    arrays = dict({f: np.asarray(getattr(plan, f))
                   for f in cases.SPGEMM_FIELDS},
                  c_nnz=np.asarray(plan.c_nnz))
    out = run(world, cases.spgemm_task, (m, k, nnz_a, 5),
              (k, n, nnz_b, 6), False, None,
              (arrays, dict(shape=plan.shape, mloc=plan.mloc)))
    assert all(o["engine"] is None for o in out)
    check(out, a, b, ar, br, plan, jmesh)


@pytest.mark.parametrize("panel_slots", [None, 1024])
def test_dist_mul_engine_matches_jax(world, jmesh, monkeypatch,
                                     panel_slots):
    """The forced engine (its fills walk the tiles on the CPU): every
    panel bit-equal to JAX's stacked engine's slice, padding chunks and
    event streams included, on one panel and on several (1,024-slot
    panels); C and a reuse within bound of JAX's engine; the JAX plan and
    engine carried across give C too."""
    m, k, n, nnz_a, nnz_b = 96, 96, 96, 768, 768
    a = gen.generate_csr(m, k, nnz_a, seed=8)
    b = gen.generate_csr(k, n, nnz_b, seed=9)
    ar, br, plan = jax_plan(a, b, jmesh, monkeypatch, engine=True,
                            panel_slots=panel_slots)
    eng = plan.engine
    assert eng is not None
    assert (len(eng.panels) > 1) == (panel_slots is not None)
    panels = [({f: np.asarray(getattr(p, f)) for f in cases.PANEL_FIELDS},
               dict(slots=p.slots, out_rows=p.out_rows, has_aux=p.has_aux,
                    dist_max=p.dist_max)) for p in eng.panels]
    estatic = {f: getattr(eng, f) for f in (
        "g_a", "g_b", "a_rows", "b_rows_pad", "pane_rows", "capacity")}
    arrays = dict({f: np.asarray(getattr(plan, f))
                   for f in cases.SPGEMM_FIELDS},
                  c_nnz=np.asarray(plan.c_nnz))
    out = run(world, cases.spgemm_task, (m, k, nnz_a, 8), (k, n, nnz_b, 9),
              True, panel_slots,
              (arrays, dict(shape=plan.shape, mloc=plan.mloc),
               (panels, estatic)))
    check(out, a, b, ar, br, plan, jmesh)
    for r, o in enumerate(out):
        e = o["engine"]
        assert e["static"] == estatic
        assert len(e["panels"]) == len(panels)
        for got, (want, st) in zip(e["panels"], panels):
            for f in cases.PANEL_FIELDS:
                np.testing.assert_array_equal(got[f], want[f][r],
                                              err_msg=f"panel {f} rank {r}")
            assert {k: got[k] for k in st} == st
        # the slot fill's stream: one run a slot of the rank's C block
        assert len(e["stream"]) - 1 == o["c_nnz"]


def test_dist_spgemm_one_shot(world):
    """``dist_spgemm`` from global operands: the assembled C is A·B
    within bound of a float64 oracle."""
    sa, sb = (90, 70, 600, 10), (70, 50, 500, 11)
    out = run(world, cases.one_shot_task, sa, sb)
    a = gen.generate_csr(*sa[:3], seed=10)
    b = gen.generate_csr(*sb[:3], seed=11)
    want = (csr_dense(a) @ csr_dense(b)).real
    bound = abs_spgemm(a, b)
    for o in out:
        back = o["back"]
        rows = np.repeat(np.arange(90), np.diff(back["rowptr"]))
        got = np.zeros((90, 50))
        np.add.at(got, (rows, back["colind"][:o["nnz"]]),
                  back["values"][:o["nnz"]])
        assert (np.abs(got - want) <= 64 * EPS32 * bound).all()

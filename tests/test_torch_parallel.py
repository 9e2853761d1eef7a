"""The port's distribution layer (``spblas_tpu_torch.parallel``) against
the JAX package's, on the CPU.

One gloo world of 4 ranks (``parallel/launch.py``) serves the module;
its ranks run the tasks of ``tests/torch_dist_cases.py`` and return
their plan slices and results.  The JAX side runs on a mesh of 4 of the
8 faked CPU devices.  Every plan is held bit-equal to slice ``[rank]`` of
JAX's stacked plan built from the same seeded inputs, and carried across
by ``utils.interop``'s ``dist_*_plan_from_numpy``; every result within
64·eps·(|A|·|x|) per row (per entry for SpMM) of JAX's result (of a
float64 numpy oracle for SELL, whose JAX executor is left out for its
run time).  Each call to the world has its own 60 s limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spblas_tpu as sp
import spblas_tpu.parallel as jpar
from spblas_tpu.utils import generate as gen

from spblas_tpu_torch.parallel.launch import World, WorldError
from spblas_tpu_torch.parallel.mesh import RowMesh
from spblas_tpu_torch.utils import interop
from tests import torch_dist_cases as cases
from tests.torch_util import (  # noqa: F401
    EPS32, assert_entries_close, assert_rows_close, csr_dense,
    one_torch_thread)

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
    """``fn`` on every rank within the call's limit (a world that an
    earlier failure took down is started again)."""
    if not world.alive:
        world.start()
    return world.run(fn, *args, timeout=LIMIT)


def stacked(plan, names):
    return {k: np.asarray(getattr(plan, k)) for k in names}


def assert_same(got: dict, want: dict, rank: int, what=""):
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v)[rank],
                                      err_msg=f"{what} {k} rank {rank}")


def assert_same_csr(back: dict, nnz: int, a):
    """The reassembled CSR holds the operand's entries (its rows' order
    of columns may differ)."""
    assert nnz == int(a.nnz)
    np.testing.assert_array_equal(back["rowptr"], np.asarray(a.rowptr))
    m, n = a.shape
    rows = np.repeat(np.arange(m), np.diff(back["rowptr"].astype(np.int64)))
    dense = np.zeros((m, n), np.complex128)
    np.add.at(dense, (rows, back["colind"][:nnz]), back["values"][:nnz])
    np.testing.assert_array_equal(dense, csr_dense(a))


DIMS = [(64, 64, 512), (100, 40, 770), (40, 100, 771)]


@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_partition_csr_and_generic_spmv_match_jax(world, jmesh, m, n, nnz):
    """DistCSR slices bit-equal to JAX's (and carried across); the ring
    and all-gather SpMV and the ring SpMM within the bound of JAX's; the
    reassembled CSR is the operand."""
    a = gen.generate_csr(m, n, nnz, seed=1)
    out = run(world, cases.csr_task, (m, n, nnz, 1), 3, 5)
    d = jpar.partition_csr(a, jmesh)
    arrays = stacked(d, ("values", "rowloc", "colloc"))
    x, b = cases.operand(n, 5), cases.operand((n, 3), 6)
    y = jpar.gather_result(jax.jit(lambda d, x: jpar.dist_spmv(
        d, x, jmesh))(d, jpar.partition_vector(x, d, jmesh)), d)
    c = jpar.gather_result(jax.jit(lambda d, b: jpar.dist_spmm(
        d, b, jmesh))(d, jpar.partition_vector(b, d, jmesh)), d)
    for r, o in enumerate(out):
        assert_same(o["plan"], arrays, r, "DistCSR")
        assert (o["nnz"], o["mloc"], o["nloc"]) == (int(d.nnz), d.mloc,
                                                   d.nloc)
        cp = interop.dist_csr_plan_from_numpy(
            dict(arrays, nnz=np.asarray(d.nnz)),
            dict(shape=d.shape, mloc=d.mloc, nloc=d.nloc), r, device="cpu")
        for k in arrays:
            np.testing.assert_array_equal(cases._np(getattr(cp, k)),
                                          o["plan"][k])
        assert_rows_close(o["y_ring"], y, a, x, err_msg="ring")
        assert_rows_close(o["y_all"], o["y_ring"], a, x, err_msg="allgather")
        assert_entries_close(o["c"], c, a, b)
        assert_same_csr(o["back"], o["back_nnz"], a)


@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_partition_rowblock_matches_jax(world, jmesh, m, n, nnz):
    a = gen.generate_csr(m, n, nnz, seed=2)
    out = run(world, cases.rowblock_task, (m, n, nnz, 2))
    rb = jpar.partition_rowblock(a, jmesh)
    arrays = stacked(rb, ("values", "colind", "rowptr"))
    for r, o in enumerate(out):
        assert_same(o["plan"], arrays, r, "RowBlockCSR")
        assert o["nnz"] == int(arrays["rowptr"][r, -1])
        cp = interop.dist_rowblock_plan_from_numpy(
            arrays, dict(shape=rb.shape, mloc=rb.mloc), r, device="cpu")
        assert cp.nnz == o["nnz"]
        assert_same_csr(o["back"], o["back_nnz"], a)


@pytest.mark.parametrize("m,bw", [(4096, 65), (3000, 17)])
def test_dist_band_halo_matches_jax(world, jmesh, m, bw):
    """The band halo pipeline: panels bit-equal to JAX's slice, the SpMV
    and the resident SpMM (k 8) within the bound of JAX's."""
    a = gen.generate_banded_csr(m, m, bw, seed=3)
    out = run(world, cases.band_task, (m, bw, 3), 8, 7)
    plan = jpar.partition_band(a, jmesh)
    x, b = cases.operand(m, 7), cases.operand((m, 8), 8)
    y = jax.jit(lambda p, x: jpar.dist_band_spmv(p, x, jmesh))(
        plan, jpar.partition_band_vector(x, plan, jmesh))
    c = jax.jit(lambda p, b: jpar.dist_band_spmm(p, b, jmesh))(
        plan, jpar.partition_band_vector(b, plan, jmesh))
    for r, o in enumerate(out):
        assert_same(o, {"panels": plan.panels}, r, "DistBandPlan")
        assert (o["h"], o["mloc"]) == (plan.h, plan.mloc)
        cp = interop.dist_band_plan_from_numpy(
            {"panels": np.asarray(plan.panels)},
            dict(h=plan.h, mloc=plan.mloc, shape=plan.shape), r,
            device="cpu")
        np.testing.assert_array_equal(cases._np(cp.panels), o["panels"])
        assert_rows_close(o["y"].reshape(-1)[:m], np.asarray(y)[:m], a, x)
        assert_entries_close(o["c"].reshape(-1, 8)[:m], np.asarray(c)[:m],
                             a, b)


def test_dist_band_rejects_wide_band(world, jmesh):
    """h = 4000 exceeds the 1024 local rows of a 4-way mesh: both
    packages refuse it with one message."""
    msgs = run(world, cases.error_task, "wide_band", cases.WIDE)
    with pytest.raises(ValueError) as e:
        jpar.partition_band(sp.CSR.from_arrays(*cases.wide_arrays()),
                            jmesh)
    assert msgs == [str(e.value)] * P


def test_plan_for_another_mesh_size_raises(world):
    msgs = run(world, cases.error_task, "mesh_size", (64, 64, 512, 1))
    assert all("partitioned for p=4 devices but the mesh has 2" in m
               for m in msgs), msgs


@pytest.mark.parametrize("case", [
    ("uniform", (2048, 2048, 16000, 1)),
    # starved enough to cross a publish gate (supercells or any-lane)
    ("starved", (8192, 8192, 512, 4)),
])
def test_dist_route_spmv_matches_jax(world, jmesh, case):
    """Per-rank ROUTE2 plans bit-equal to JAX's stacked slice, common
    geometry included; the result within the bound of JAX's (interpret
    mode); the JAX plan carried across runs too."""
    name, args = case
    a = gen.generate_csr(*args[:3], seed=args[3])
    plan = jpar.partition_route(a, jmesh)
    if name == "starved":
        assert plan.row_window_mult > 1 or plan.any_lane
    arrays = stacked(plan, cases.ROUTE_FIELDS)
    static = {k: getattr(plan, k) for k in cases.ROUTE_STATIC}
    out = run(world, cases.route_task, args, 9,
              (arrays, dict(static, shape=plan.shape)))
    m, n = a.shape
    x = cases.operand(n, 9)
    y = np.asarray(jax.jit(lambda p, x: jpar.dist_route_spmv(p, x, jmesh))(
        plan, jnp.pad(jnp.asarray(x), (0, plan.p * plan.nloc - n))))[:m]
    for r, o in enumerate(out):
        assert_same(o["plan"], arrays, r, "DistRoutePlan")
        assert o["static"] == static
        assert o["launch_starts"][0] == 0
        assert_rows_close(o["y"].reshape(-1)[:m], y, a, x)
        assert_rows_close(o["y_carried"].reshape(-1)[:m], y, a, x)


def test_dist_sell_spmm_plan_matches_jax(world, jmesh):
    """Per-rank SELL plans bit-equal to JAX's host-built partition_sell;
    the product within the bound of a float64 oracle."""
    m, n, nnz, k = 2000, 1500, 12000, 4
    a = gen.generate_csr(m, n, nnz, seed=7)
    out = run(world, cases.sell_task, (m, n, nnz, 7), k, 11)
    plan = jpar.partition_sell(a, jmesh)
    b = cases.operand((n, k), 11)
    want = (csr_dense(a) @ b.astype(np.float64)).real
    for r, o in enumerate(out):
        assert len(o["values"]) == len(plan.bucket_values)
        for got, jv in zip(o["values"], plan.bucket_values):
            np.testing.assert_array_equal(got, np.asarray(jv)[r])
        for got, jc in zip(o["cols"], plan.bucket_cols):
            np.testing.assert_array_equal(got, np.asarray(jc)[r])
        np.testing.assert_array_equal(o["pos"], np.asarray(plan.pos)[r])
        cp = interop.dist_sell_plan_from_numpy(
            dict(bucket_values=[np.asarray(v) for v in plan.bucket_values],
                 bucket_cols=[np.asarray(c) for c in plan.bucket_cols],
                 pos=np.asarray(plan.pos)),
            dict(shape=plan.shape, mloc=plan.mloc, nloc=plan.nloc), r,
            device="cpu")
        np.testing.assert_array_equal(cases._np(cp.pos), o["pos"])
        assert_entries_close(o["c"].reshape(-1, k)[:m], want, a, b)


def test_dist_add_and_scaled_reuse_match_jax(world, jmesh):
    """The union plan bit-equal to JAX's slice; C and a reuse on 2A with
    alpha 0.5, beta -1.5 bit-equal to JAX's (each slot adds A's entry,
    then B's); the carried plan gives the same bits."""
    sa, sb = (200, 150, 1200, 3), (200, 150, 1000, 4)
    a, b = gen.generate_csr(*sa[:3], seed=3), gen.generate_csr(*sb[:3],
                                                               seed=4)
    ar, br = jpar.partition_rowblock(a, jmesh), \
        jpar.partition_rowblock(b, jmesh)
    plan = jpar.dist_add_compute(ar, br, jmesh)
    arrays = dict(stacked(plan, cases.ADD_FIELDS),
                  c_nnz=np.asarray(plan.c_nnz))
    out = run(world, cases.add_task, sa, sb, (0.5, -1.5),
              (arrays, dict(shape=plan.shape, mloc=plan.mloc)))
    numeric = jax.jit(lambda p, a, b, al, be: jpar.dist_add_numeric(
        p, a, b, jmesh, al, be).values)     # one compile for both
    c = np.asarray(numeric(plan, ar, br, 1.0, 1.0))
    ar2 = dataclasses.replace(ar, values=ar.values * 2.0)
    c2 = np.asarray(numeric(plan, ar2, br, 0.5, -1.5))
    for r, o in enumerate(out):
        assert_same(o["plan"], {k: arrays[k] for k in cases.ADD_FIELDS}, r,
                    "DistAddPlan")
        assert o["c_nnz"] == int(arrays["c_nnz"][r])
        np.testing.assert_array_equal(o["c"], c[r])
        np.testing.assert_array_equal(o["c2"], c2[r])
        np.testing.assert_array_equal(o["c2_carried"], c2[r])


@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_dist_triangular_solve_matches_jax(world, jmesh, uplo):
    """The padded level schedules bit-equal to JAX's slices; x within
    the componentwise backward error 64·eps·(|A||x| + |b|) and close to
    JAX's x."""
    m = 512
    a = gen.generate_triangular_csr(m, seed=3, lower=uplo == "lower")
    out = run(world, cases.trsv_task, (m, 3, uplo == "lower"), uplo, 13)
    plan = jpar.dist_triangular_solve_inspect(a, jmesh, uplo=uplo)
    arrays = stacked(plan, cases.TRSV_FIELDS)
    b = cases.operand(m, 13)
    x = np.asarray(jax.jit(lambda p, b: jpar.dist_triangular_solve(
        p, b, jmesh))(plan, jnp.asarray(b)))[:m]
    dense = csr_dense(a).real
    for r, o in enumerate(out):
        assert_same(o["plan"], arrays, r, "DistTrsvPlan")
        cp = interop.dist_trsv_plan_from_numpy(
            arrays, dict(lower=plan.lower, unit_diag=plan.unit_diag,
                         mloc=plan.mloc, shape=plan.shape), r, device="cpu")
        np.testing.assert_array_equal(cases._np(cp.eidx), o["plan"]["eidx"])
        xp = o["x"].reshape(-1)[:m].astype(np.float64)
        resid = np.abs(dense @ xp - b)
        assert (resid <= 64 * EPS32 * (np.abs(dense) @ np.abs(xp)
                                       + np.abs(b))).all()
        np.testing.assert_allclose(xp, x, rtol=1e-4, atol=1e-5)


def test_stage_through_host_gives_the_same_bits(world):
    """A mesh that stages through the host (the gloo mesh over CUDA
    tensors on the card) runs the halo, the ring, the all-gather and the
    broadcast on CPU tensors with the plain mesh's bits, and counts its
    bytes; the plain mesh counts none."""
    out = run(world, cases.staging_task, (4096, 33, 5),
              (1000, 1000, 6000, 6), 17)
    for o in out:
        for k in o["plain"]:
            np.testing.assert_array_equal(o["staged"][k], o["plain"][k],
                                          err_msg=k)
        assert o["staged_bytes"] > 0 and o["plain_bytes"] == 0


def test_collectives_have_jax_semantics(world):
    """``ppermute`` (zeros where no pair sends, a pair to itself a copy),
    ``all_gather`` (stacked), ``psum``, ``broadcast`` and ``reduce_ints``
    give JAX's values on the plain mesh and on one that stages through
    the host; no rank imported JAX or the JAX package."""
    out = run(world, cases.collectives_task)
    assert [o["imported"] for o in out] == [[]] * P
    t = [np.arange(3, dtype=np.float32) + 10 * r for r in range(P)]
    for r, o in enumerate(out):
        for mesh in ("plain", "staged"):
            c = o[mesh]
            np.testing.assert_array_equal(
                c["shift"], t[r - 1] if r else np.zeros(3, np.float32))
            np.testing.assert_array_equal(c["ring"], t[(r + 1) % P])
            np.testing.assert_array_equal(c["self_pair"], t[r])
            np.testing.assert_array_equal(c["gathered"], np.stack(t))
            np.testing.assert_array_equal(c["summed"], sum(t))
            np.testing.assert_array_equal(c["from_last"], t[P - 1])
            assert c["maxed"] == [P - 1, 0]
            assert c["total"] == [sum(range(P)), P]


def test_meshes_refuse_tensors_their_backend_cannot_carry():
    """gloo carries CUDA tensors only through the host, when the mesh was
    built to stage; NCCL carries no CPU tensor."""
    gloo = RowMesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                   backend="gloo")
    with pytest.raises(RuntimeError, match="stage_through_host"):
        gloo.check_carry(torch.device("cuda"))
    dataclasses.replace(gloo, stage_through_host=True).check_carry(
        torch.device("cuda"))
    gloo.check_carry(torch.device("cpu"))
    nccl = dataclasses.replace(gloo, backend="nccl")
    with pytest.raises(RuntimeError):
        nccl.check_carry(torch.device("cpu"))


def test_world_defaults_to_the_card(monkeypatch):
    """A world with no device named puts rank r on card r modulo the
    host's cards, and raises, before it starts a rank, where there is no
    card: only a caller that names the CPU gets CPU ranks."""
    from spblas_tpu_torch.parallel import launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        World(2).start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_world(2, cases.sleep_task, 0.0)
    assert launch._rank_device(3, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch._rank_device(3, None) == torch.device("cuda", 1)
    assert launch._rank_device(3, "cuda:0") == torch.device("cuda", 0)


def test_choosers_on_cpu_and_forced_kinds(world):
    """Off the card both choosers take the generic blocks; every forced
    kind's product is within the bound of a float64 oracle."""
    band, uni = (4096, 33, 5), (1000, 1000, 6000, 6)
    out = run(world, cases.chooser_task, band, uni)
    a = gen.generate_banded_csr(4096, 4096, 33, seed=5)
    u = gen.generate_csr(1000, 1000, 6000, seed=6)
    for o in out:
        assert (o["auto_spmv"], o["auto_spmm"]) == ("csr", "csr")
        for kind, mat in (("band", a), ("route", u), ("csr", u)):
            x = np.ones(mat.shape[1], np.float32)
            assert_rows_close(o[f"spmv_{kind}"], csr_dense(mat).real @ x,
                              mat, x, err_msg=kind)
        for kind, mat in (("band", a), ("sell", u), ("csr", u)):
            b = np.ones((mat.shape[1], 3), np.float32)
            assert_entries_close(o[f"spmm_{kind}"],
                                 csr_dense(mat).real @ b, mat, b)


def test_failed_or_hung_rank_fails_the_call(world):
    """A rank that raises, or passes the call's limit, makes the call
    raise with every rank killed; the world starts again."""
    with pytest.raises(WorldError, match=r"rank \d failed"):
        world.run(cases.csr_task, None, 3, 5, timeout=LIMIT)
    assert not world.alive
    world.start()
    with pytest.raises(WorldError, match="no result within 2 s"):
        world.run(cases.sleep_task, 30.0, timeout=2.0)
    assert not world.alive

"""Multi-rank dry run of the distribution layer on the CPU — counterpart
of ``__graft_entry__.dryrun_multichip``.

    python -m spblas_tpu_torch.parallel.dryrun 8

:func:`dryrun_multichip` starts a local gloo world of n ranks
(:mod:`~spblas_tpu_torch.parallel.launch`) and runs the same steps on
it, each rank on its own slice: the ring and all-gather generic SpMV
(held to each other) and SpMM, the SpGEMM numeric and the forced mul
engine (held to it), the band halo SpMV and SpMM, the triangular solve,
the SpADD, the per-rank ROUTE2 SpMV on a dense and on a starved matrix
that crosses a publish gate (held to the generic path), the per-rank
SELL SpMM and both choosers.  Every rank also reports whether ``jax``
or ``spblas_tpu`` was imported in it.
"""

from __future__ import annotations

import os
import sys

import torch


def _close(a, b) -> bool:
    return bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4))


def _dryrun_rank(mesh):
    from spblas_tpu_torch import parallel as par
    from spblas_tpu_torch.utils import generate as gen

    p = mesh.size
    m = n = 8 * p
    a = gen.generate_csr(m, n, 4 * m, seed=0, device="cpu")
    d = par.partition_csr(a, mesh)
    x = par.partition_vector(torch.ones(n), d, mesh)
    b = par.partition_vector(torch.ones(n, 8), d, mesh)
    checks = {}
    y = par.dist_spmv(d, x, mesh, strategy="ring")
    checks["ring_vs_allgather"] = _close(
        y, par.dist_spmv(d, x, mesh, strategy="allgather"))
    checks["spmm_shape"] = tuple(par.dist_spmm(d, b, mesh).shape) \
        == (d.mloc, 8)

    ar = par.partition_rowblock(a, mesh)
    plan = par.dist_spgemm_compute(ar, ar, mesh)
    cc = par.dist_spgemm_numeric(plan, ar, ar, mesh)
    # the per-rank paned mul engine, forced on the CPU, against it
    os.environ["SPBLAS_FORCE_ROUTE_SPGEMM"] = "1"
    try:
        plan_e = par.dist_spgemm_compute(ar, ar, mesh)
    finally:
        os.environ.pop("SPBLAS_FORCE_ROUTE_SPGEMM", None)
    checks["engine_built"] = plan_e.engine is not None
    checks["engine_vs_torch"] = _close(
        par.dist_spgemm_numeric(plan_e, ar, ar, mesh).values, cc.values)

    mb = 1024 * p
    ab = gen.generate_banded_csr(mb, mb, 9, seed=1, device="cpu")
    bplan = par.partition_band(ab, mesh)
    yb = par.dist_band_spmv(
        bplan, par.partition_band_vector(torch.ones(mb), bplan, mesh), mesh)
    cb = par.dist_band_spmm(
        bplan, par.partition_band_vector(torch.ones(mb, 8), bplan, mesh),
        mesh)
    checks["band_finite"] = bool(yb.isfinite().all() and cb.isfinite().all())

    mt = 16 * p
    lt = gen.generate_triangular_csr(mt, seed=2, lower=True, density=0.05,
                                     device="cpu")
    tplan = par.dist_triangular_solve_inspect(lt, mesh, uplo="lower")
    xt = par.dist_triangular_solve(tplan, torch.ones(tplan.mloc), mesh)
    checks["trsv_finite"] = bool(xt.isfinite().all())

    a2 = gen.generate_csr(m, n, 4 * m, seed=3, device="cpu")
    s = par.dist_add(ar, par.partition_rowblock(a2, mesh), mesh)
    checks["add_finite"] = bool(s.values.isfinite().all())

    rplan = par.partition_route(a, mesh)
    yr = par.dist_route_spmv(rplan, torch.ones(rplan.nloc), mesh)
    checks["route_vs_csr"] = _close(yr, par.dist_spmv(
        d, par.partition_vector(torch.ones(n), d, mesh), mesh))
    # a starved matrix that crosses the publish-geometry gate
    starved = gen.generate_csr(2048 * p, 2048 * p, p * 128, seed=4,
                               device="cpu")
    rplan2 = par.partition_route(starved, mesh)
    checks["starved_gate"] = rplan2.row_window_mult > 1 or rplan2.any_lane
    d2 = par.partition_csr(starved, mesh)
    checks["starved_vs_csr"] = _close(
        par.dist_route_spmv(rplan2, torch.ones(rplan2.nloc), mesh),
        par.dist_spmv(d2, torch.ones(d2.nloc), mesh, strategy="allgather"))

    splan = par.partition_sell(a, mesh)
    checks["sell_shape"] = tuple(par.dist_sell_spmm(
        splan, torch.ones(splan.nloc, 8), mesh).shape) == (splan.mloc, 8)

    for prefer, mat in (("route", a), ("band", ab), (None, a)):
        kp = par.partition_spmv(mat, mesh, prefer=prefer)
        yv = par.dist_plan_spmv(kp, par.partition_spmv_vector(
            kp, torch.ones(mat.shape[1]), mesh), mesh)
        checks[f"spmv_{kp[0]}"] = bool(yv.isfinite().all())
    for prefer, mat in (("sell", a), ("band", ab), (None, a)):
        kp = par.partition_spmm(mat, mesh, prefer=prefer)
        cv = par.dist_plan_spmm(kp, par.partition_spmm_operand(
            kp, torch.ones(mat.shape[1], 4), mesh), mesh)
        checks[f"spmm_{kp[0]}"] = bool(cv.isfinite().all())
    checks["no_jax"] = not ({"jax", "spblas_tpu"} & set(sys.modules))
    return checks


def dryrun_multichip(n_devices: int, timeout: float = 120.0) -> list:
    """Run the dry run on a local gloo world of ``n_devices`` CPU ranks;
    raises if a check fails on any rank.  Returns each rank's checks."""
    from spblas_tpu_torch.parallel.launch import run_world
    out = run_world(n_devices, _dryrun_rank, backend="gloo", device="cpu",
                    threads=1, timeout=timeout)
    bad = {(r, k) for r, checks in enumerate(out)
           for k, ok in checks.items() if not ok}
    if bad:
        raise RuntimeError(f"dry run failed: {sorted(bad)}")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    print("dryrun_multichip ok")

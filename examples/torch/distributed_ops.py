"""Distributed op tour — the port's twin of examples/distributed_ops.py:
banded SpMV halo pipeline, SpGEMM with numeric reuse, SpADD, and
block-substitution SpTRSV over a row mesh.

One process a rank (``torch.distributed``), each calling the same tour on
its own rows.  Started with ``python``, the script runs a local world of
``--ranks`` spawned ranks (``parallel.launch.tour_main``): NCCL and one rank
a card by default, gloo on the CPU.  A gloo world on the card stages
every collective through the host (NCCL refuses two ranks on one card):

    python examples/torch/distributed_ops.py        # NCCL, a rank a card
    python examples/torch/distributed_ops.py --backend gloo --ranks 4
    python examples/torch/distributed_ops.py --device cpu --ranks 4

Started under ``torchrun`` it runs the tour as one rank of torchrun's
world (NCCL on the card, gloo with ``--device cpu``):

    torchrun --nproc-per-node 4 examples/torch/distributed_ops.py
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from spblas_tpu_torch.parallel import (
    assemble_csr, dist_add, dist_band_spmv, dist_spgemm,
    dist_spgemm_compute, dist_spgemm_numeric, dist_triangular_solve,
    dist_triangular_solve_inspect, gather_result, partition_band,
    partition_band_vector, partition_rowblock, partition_vector,
)
from spblas_tpu_torch.parallel.launch import tour_main
from spblas_tpu_torch.utils.generate import (generate_banded_csr,
                                             generate_csr,
                                             generate_triangular_csr)


def tour(mesh):
    """The rank's part of the tour; every rank checks the gathered
    results, rank 0 prints."""
    def say(*what):
        if mesh.rank == 0:
            print(*what, flush=True)

    dev = mesh.device
    p = mesh.size
    say("mesh:", mesh)

    # --- banded SpMV: h-wide halo exchange + local band panels ------- #
    m = 1024 * p
    a = generate_banded_csr(m, m, 33, seed=0, device=dev)
    plan = partition_band(a, mesh)
    x = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    xd = partition_band_vector(torch.from_numpy(x), plan, mesh)
    y = gather_result(dist_band_spmv(plan, xd, mesh), plan, mesh)
    y = y.cpu().numpy()
    nnz = a.nnz
    rowptr = a.rowptr.cpu().numpy()
    cols = a.colind.cpu().numpy()[:nnz]
    vals = a.values.cpu().numpy()[:nnz]
    rows = np.repeat(np.arange(m), np.diff(np.minimum(rowptr, nnz)))
    exp = np.zeros(m, np.float32)
    np.add.at(exp, rows, vals * x[cols])
    assert np.allclose(y, exp, rtol=1e-3, atol=1e-3)
    say("dist banded spmv ok")

    # --- SpGEMM + SpADD over row blocks ------------------------------ #
    g1 = generate_csr(96, 96, 800, seed=2, device=dev)
    g2 = generate_csr(96, 96, 700, seed=3, device=dev)
    c = assemble_csr(dist_spgemm(g1, g2, mesh), mesh)
    expected = g1.todense().cpu().numpy() @ g2.todense().cpu().numpy()
    assert np.allclose(c.todense().cpu().numpy(), expected, rtol=1e-3)
    s = assemble_csr(dist_add(g1, g2, mesh), mesh)
    assert np.allclose(s.todense().cpu().numpy(),
                       g1.todense().cpu().numpy()
                       + g2.todense().cpu().numpy(), rtol=1e-4)
    say("dist spgemm + add ok")

    # --- block-substitution SpTRSV ----------------------------------- #
    mt = 320
    L = generate_triangular_csr(mt, seed=4, lower=True, device=dev)
    tplan = dist_triangular_solve_inspect(L, mesh, uplo="lower")
    b = np.random.default_rng(5).standard_normal(mt).astype(np.float32)
    bp = partition_vector(torch.from_numpy(b), tplan, mesh, axis="rows")
    xs = mesh.all_gather(dist_triangular_solve(tplan, bp, mesh))
    xs = xs.reshape(-1)[:mt].cpu().numpy()
    assert np.abs(L.todense().cpu().numpy() @ xs - b).max() < 1e-4
    say("dist sptrsv ok")

    # --- distributed SpGEMM at engine speed -------------------------- #
    # the card's default reuse path: each rank's mul engine, its numeric
    # one launch of the slot fill; the CPU builds it when asked (its
    # fills then walk the tiles)
    force = (dev.type != "cuda"
             and "SPBLAS_FORCE_ROUTE_SPGEMM" not in os.environ)
    if force:
        os.environ["SPBLAS_FORCE_ROUTE_SPGEMM"] = "1"
    try:
        ar = partition_rowblock(g1, mesh)
        br = partition_rowblock(g2, mesh)
        plan = dist_spgemm_compute(ar, br, mesh)
    finally:
        if force:
            del os.environ["SPBLAS_FORCE_ROUTE_SPGEMM"]
    assert plan.engine is not None, "mul engine gate"
    ce = assemble_csr(dist_spgemm_numeric(plan, ar, br, mesh), mesh)
    assert np.allclose(ce.todense().cpu().numpy(), expected,
                       rtol=1e-3, atol=1e-3)
    # numeric re-run with new values, same sparsity (the reuse contract)
    a2 = dataclasses.replace(ar, values=ar.values * 3.0)
    c3 = assemble_csr(dist_spgemm_numeric(plan, a2, br, mesh), mesh)
    assert np.allclose(c3.todense().cpu().numpy(), 3.0 * expected,
                       rtol=1e-3, atol=1e-3)
    say("dist spgemm engine ok")
    return y


if __name__ == "__main__":
    out = tour_main(tour, "distributed op tour")
    assert all(np.array_equal(r, out[0]) for r in out)

"""Distributed SpMV over a row mesh — the port's twin of
examples/distributed_spmv.py.

One process a rank (``torch.distributed``), each calling the same tour on
its own rows.  Started with ``python``, the script runs a local world of
``--ranks`` spawned ranks (``parallel.launch.tour_main``): NCCL and one rank
a card by default, gloo on the CPU.  A gloo world on the card stages
every collective through the host (NCCL refuses two ranks on one card):

    python examples/torch/distributed_spmv.py       # NCCL, a rank a card
    python examples/torch/distributed_spmv.py --backend gloo --ranks 4
    python examples/torch/distributed_spmv.py --device cpu --ranks 4

Started under ``torchrun`` it runs the tour as one rank of torchrun's
world (NCCL on the card, gloo with ``--device cpu``):

    torchrun --nproc-per-node 4 examples/torch/distributed_spmv.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from spblas_tpu_torch.parallel import (
    dist_plan_spmm, dist_plan_spmv, dist_spmv, gather_result,
    partition_csr, partition_spmm, partition_spmm_operand, partition_spmv,
    partition_spmv_vector, partition_vector,
)
from spblas_tpu_torch.parallel.launch import tour_main
from spblas_tpu_torch.utils.generate import generate_csr, generate_vector

m = n = 1024


def tour(mesh):
    """The rank's part of the tour; every rank checks the gathered
    results, rank 0 prints."""
    def say(*what):
        if mesh.rank == 0:
            print(*what, flush=True)

    say("mesh:", mesh)
    a = generate_csr(m, n, 16 * m, seed=0, device=mesh.device)
    x = generate_vector(n, seed=1, device=mesh.device)
    expected = a.todense().cpu().numpy() @ x.cpu().numpy()

    # --- recommended entry: the distributed chooser ---------------- #
    # picks band halo / per-rank ROUTE2 on the card, generic blocks on
    # the CPU; ``prefer`` forces a kind (here: the card's route path,
    # whose ranks run the ROUTE2 kernel, or its plain version on the CPU)
    for prefer in (None, "route"):
        kp = partition_spmv(a, mesh, prefer=prefer)
        xv = partition_spmv_vector(kp, x, mesh)
        y = gather_result(dist_plan_spmv(kp, xv, mesh), kp[1], mesh)
        assert np.allclose(y.cpu().numpy(), expected, rtol=1e-3, atol=1e-3)
        say(f"chooser prefer={prefer!r} -> kind={kp[0]} ok")

    # dense-operand (SpMM) chooser: same selection surface
    B = np.random.default_rng(2).standard_normal((n, 8)).astype(np.float32)
    kp = partition_spmm(a, mesh, prefer="sell")
    Bp = partition_spmm_operand(kp, torch.from_numpy(B), mesh)
    C = gather_result(dist_plan_spmm(kp, Bp, mesh), kp[1], mesh)
    assert np.allclose(C.cpu().numpy(), a.todense().cpu().numpy() @ B,
                       rtol=1e-3, atol=1e-3)
    say("spmm chooser kind=sell ok")

    # --- raw gather-block kernels (the CPU-class default) ---------- #
    d = partition_csr(a, mesh)          # inspect: row blocks + ring layout
    xd = partition_vector(x, d, mesh)

    y_ring = gather_result(dist_spmv(d, xd, mesh, strategy="ring"), d, mesh)
    y_ag = gather_result(dist_spmv(d, xd, mesh, strategy="allgather"), d,
                         mesh)

    assert np.allclose(y_ring.cpu().numpy(), expected, rtol=1e-3, atol=1e-3)
    assert np.allclose(y_ag.cpu().numpy(), expected, rtol=1e-3, atol=1e-3)
    return y_ring.cpu().numpy()


if __name__ == "__main__":
    out = tour_main(tour, "distributed SpMV")
    assert all(np.array_equal(r, out[0]) for r in out)
    if int(os.environ.get("RANK", 0)) == 0:
        print("ok")

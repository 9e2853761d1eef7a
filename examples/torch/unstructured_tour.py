"""Unstructured-sparsity tour: the chooser's general-matrix paths — the
port's twin of examples/unstructured_tour.py.

On the card the ``matrix_opt`` chooser (``kernels/plans.py``) picks a
plan from the measured pattern, each with a kernel written for the card:

  low-skew random      -> ROUTE2 chunk kernel               ("route")
  hub-heavy power-law  -> ROUTE v1 (free scatter lanes)     ("route1")
  SpMM (dense B)       -> SELL degree-bucketed row-gathers  ("sell")
  triangular solve     -> ONE-launch level schedule         (plan.route)

On the CPU the chooser has no ROUTE rung, so the tour calls the builder
the card's chooser calls (``plans._try_route``) and the plans run their
kernels' plain versions; every step asserts a dense oracle.

    python examples/torch/unstructured_tour.py                # on the card
    python examples/torch/unstructured_tour.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import spblas_tpu_torch as sp
from spblas_tpu_torch.kernels import plans as _plans
from spblas_tpu_torch.utils.generate import (generate_csr,
                                             generate_rmat_csr,
                                             generate_triangular_csr)

parser = argparse.ArgumentParser(description="unstructured-sparsity tour")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device


def chosen(a):
    """The matvec chooser's (kind, plan) on the card; on the CPU the
    ROUTE rung it takes there."""
    if a.device.type == "cuda":
        return _plans.build_matvec_plan(a)
    return _plans._try_route(a)


rng = np.random.default_rng(0)

# --- low-skew uniform random: ROUTE2 ------------------------------- #
a = generate_csr(3000, 3000, 24_000, seed=1, device=dev)
kind, plan = chosen(a)
assert kind == "route", kind
x = rng.standard_normal(3000).astype(np.float32)
y = _plans.plan_spmv((kind, plan), torch.from_numpy(x).to(a.device))
y = y.cpu().numpy()
expected = a.todense().cpu().numpy() @ x
assert np.allclose(y, expected, rtol=1e-4, atol=1e-3)
print(f"uniform  -> {kind:7s} ok")

# --- hub-heavy power-law: ROUTE v1 --------------------------------- #
r = generate_rmat_csr(4096, 4096 * 16, seed=2, device=dev)
hub = _plans._hub_fraction(r)
kind_r, plan_r = chosen(r)
assert kind_r in ("route1", "route1_sorted"), kind_r
xr = rng.standard_normal(4096).astype(np.float32)
yr = _plans.plan_spmv((kind_r, plan_r), torch.from_numpy(xr).to(r.device))
yr = yr.cpu().numpy()
expected = r.todense().cpu().numpy() @ xr
assert np.allclose(yr, expected, rtol=1e-4, atol=1e-3)
print(f"rmat     -> {kind_r:7s} ok  (hub fraction {hub:.2f})")

# --- SpMM through the SELL plan ------------------------------------ #
ao = sp.matrix_opt(r)
b = rng.standard_normal((4096, 16)).astype(np.float32)
c = sp.multiply(ao, torch.from_numpy(b).to(r.device)).cpu().numpy()
expected = r.todense().cpu().numpy() @ b
assert np.allclose(c, expected, rtol=1e-4, atol=1e-3)
print(f"spmm     -> {ao._plans['matmul'][0]:7s} ok")

# --- one-launch triangular solve ----------------------------------- #
L = generate_triangular_csr(2000, seed=3, lower=True, device=dev)
# on the card the substitution plan is the default; the CPU builds it
# when asked, and runs the kernel's plain version
force = L.device.type != "cuda" and "SPBLAS_FORCE_ROUTE_TRSV" not in os.environ
if force:
    os.environ["SPBLAS_FORCE_ROUTE_TRSV"] = "1"
try:
    info = sp.triangular_solve_inspect(L, uplo="lower")
finally:
    if force:
        del os.environ["SPBLAS_FORCE_ROUTE_TRSV"]
bl = rng.standard_normal(2000).astype(np.float32)
xl = sp.triangular_solve(L, torch.from_numpy(bl).to(L.device), uplo="lower",
                         info=info).cpu().numpy()
dense = L.todense().cpu().numpy()
assert np.allclose(dense @ xl, bl, rtol=1e-3, atol=1e-3)
path = "route_one_dispatch" if info.plan.route is not None else "sweep"
assert path == "route_one_dispatch", path
print(f"sptrsv   -> {path} ok")
print("ok")

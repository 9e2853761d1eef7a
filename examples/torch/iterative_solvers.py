"""Iterative solvers over the sparse framework — the port's twin of
examples/iterative_solvers.py: CG on an SPD banded system (on the card
each iteration's SpMV runs the ``matrix_opt`` plan's kernel), a dominant
eigenpair by power iteration, and a weighted Jacobi smoother.

    python examples/torch/iterative_solvers.py                # on the card
    python examples/torch/iterative_solvers.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from spblas_tpu_torch import matrix_opt, solvers
from spblas_tpu_torch.formats.csr import CSR

parser = argparse.ArgumentParser(description="iterative solvers")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

rng = np.random.default_rng(0)
m = 400

# SPD: diagonally dominant symmetric band
off1 = rng.uniform(0.05, 0.25, m - 1).astype(np.float32)
dense = np.diag(np.full(m, 2.0, np.float32))
dense += np.diag(off1, 1) + np.diag(off1, -1)
a = CSR.from_dense(dense, device=dev)

b = rng.standard_normal(m).astype(np.float32)
res = solvers.cg(matrix_opt(a), torch.from_numpy(b).to(a.device), tol=1e-6,
                 maxiter=500)
print(f"CG: {int(res.iterations)} iterations, "
      f"residual {float(res.residual_norm):.2e}")
assert np.abs(dense @ res.x.cpu().numpy() - b).max() < 1e-3

# v0 from a seeded CPU generator, so the card and the CPU start from one
# v0 (JAX's PRNG key has no torch twin; the card's generator draws
# another v0, from which 200 steps land farther from lambda_max)
gen = torch.Generator().manual_seed(0)
eig = solvers.power_method(a, m, iters=200, generator=gen)
lam_true = np.linalg.eigvalsh(dense.astype(np.float64)).max()
print(f"power method: lambda_max = {float(eig.eigenvalue):.6f} "
      f"(dense oracle {lam_true:.6f})")
assert abs(float(eig.eigenvalue) - lam_true) < 1e-2

x_j = solvers.jacobi(a, torch.from_numpy(b).to(a.device),
                     torch.from_numpy(np.diag(dense).copy()).to(a.device),
                     iters=300, omega=0.8)
assert np.abs(dense @ x_j.cpu().numpy() - b).max() < 1e-2
print("ok")

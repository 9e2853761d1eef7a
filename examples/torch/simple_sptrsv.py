"""SpTRSV walk-through — the port's twin of examples/simple_sptrsv.py,
with the level-scheduled inspector made explicit.  On the card each
solve is one launch of the ROUTE2 substitution kernel.

    python examples/torch/simple_sptrsv.py                # on the card
    python examples/torch/simple_sptrsv.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.utils.generate import generate_triangular_csr, \
    generate_vector

parser = argparse.ArgumentParser(description="SpTRSV walk-through")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

m = 200
L = generate_triangular_csr(m, seed=0, lower=True, device=dev)
b = generate_vector(m, seed=1, device=dev)

# one-shot (analysis runs internally)
x = sp.triangular_solve(L, b, uplo="lower", diag="explicit")

# inspector-executor: amortize the level analysis across solves
info = sp.triangular_solve_inspect(L, uplo="lower", diag="explicit")
print("levels:", info.plan.num_levels)
x2 = sp.triangular_solve(L, b, uplo="lower", info=info)

dense = L.todense().cpu().numpy()
assert np.allclose(dense @ x.cpu().numpy(), b.cpu().numpy(), atol=1e-4)
assert np.allclose(x.cpu().numpy(), x2.cpu().numpy())
print("ok")

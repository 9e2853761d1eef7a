"""matrix_opt walk-through — the port's twin of
examples/matrix_opt_example.py.

Wrapping a matrix in ``matrix_opt`` lets repeated products amortize an
inspection step: the first multiply builds a plan (on the card the
chooser's kind, whose kernel then runs every product; on the CPU the
torch-op SELL plan) and later multiplies reuse it.

    python examples/torch/matrix_opt_example.py                # on the card
    python examples/torch/matrix_opt_example.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.utils.generate import generate_csr, generate_vector

parser = argparse.ArgumentParser(description="matrix_opt walk-through")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

a = generate_csr(500, 500, 5000, seed=0, device=dev)
x = generate_vector(500, seed=1, device=dev)

a_opt = sp.matrix_opt(a)

y1 = sp.multiply(a_opt, x)       # builds + caches the plan
y2 = sp.multiply(a_opt, x)       # reuses it

expected = a.todense().cpu().numpy() @ x.cpu().numpy()
assert np.allclose(y1.cpu().numpy(), expected, rtol=1e-4)
assert np.allclose(y2.cpu().numpy(), expected, rtol=1e-4)
print("plans cached:", list(a_opt._plans.keys()))
print("matvec kind:", a_opt._plans["matvec"][0])
print("ok")

"""Real-matrix IO tour — the port's twin of examples/real_matrix_io.py:
load a checked-in Matrix Market file, run the full matvec chooser on it,
and round-trip a matrix through save/load.

The port reads Matrix Market files with its own copy of the native C++
reader (transparent .gz support); the benchmark matrices live under
data/ (``scripts/make_data_torch.py`` regenerates them).

    python examples/torch/real_matrix_io.py                # on the card
    python examples/torch/real_matrix_io.py --device cpu   # on the CPU
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.utils.generate import generate_csr, generate_vector
from spblas_tpu_torch.utils.io import load_matrix_market, save_matrix_market

parser = argparse.ArgumentParser(description="Matrix Market IO tour")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

data = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")

# load a checked-in benchmark matrix (gzipped Matrix Market)
a = load_matrix_market(os.path.join(data, "fem2d_128.mtx.gz"), device=dev)
print("fem2d_128:", a.shape, a.nnz, "nnz")

# run it through the optimized-matrix path (plan chooser)
x = generate_vector(a.shape[1], seed=1, device=dev)
a_opt = sp.matrix_opt(a)
y = sp.multiply(a_opt, x)
print("matvec kind:", a_opt._plans["matvec"][0])

expected = a.todense().cpu().numpy() @ x.cpu().numpy()
assert np.allclose(y.cpu().numpy(), expected, rtol=1e-4, atol=1e-3)

# save/load round-trip of a generated matrix
b = generate_csr(200, 150, 900, seed=2, device=dev)
with tempfile.TemporaryDirectory() as d:
    p = os.path.join(d, "b.mtx")
    save_matrix_market(p, b)
    b2 = load_matrix_market(p, device=dev)
assert b2.shape == b.shape and b2.nnz == b.nnz
assert np.allclose(b2.todense().cpu().numpy(), b.todense().cpu().numpy(),
                   rtol=1e-6)
print("ok")

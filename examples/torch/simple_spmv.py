"""SpMV walk-through — the port's twin of examples/simple_spmv.py.

y = alpha * A @ x over a random CSR, via the polymorphic ``multiply``
with a lazy ``scaled`` view folded into the product.

    python examples/torch/simple_spmv.py                # on the card
    python examples/torch/simple_spmv.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.utils.generate import generate_csr, generate_vector

parser = argparse.ArgumentParser(description="SpMV walk-through")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

m, n, nnz = 100, 100, 10

a = generate_csr(m, n, nnz, seed=0, device=dev)
x = generate_vector(n, seed=1, device=dev)

alpha = 2.0
y = sp.multiply(sp.scaled(alpha, a), x)

print("A:", a)
print("y[:8] =", y[:8].cpu().numpy())

# oracle check, the reference tests' style
expected = alpha * (a.todense().cpu().numpy() @ x.cpu().numpy())
assert np.allclose(y.cpu().numpy(), expected, rtol=1e-5)
print("ok")

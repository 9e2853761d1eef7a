"""SpMM (CSR and CSC) — the port's twin of examples/spmm.py.

    python examples/torch/spmm.py                # on the card
    python examples/torch/spmm.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.utils.generate import generate_csr, generate_csc, \
    generate_dense

parser = argparse.ArgumentParser(description="SpMM over CSR and CSC")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

m, n, k = 100, 80, 64

a_csr = generate_csr(m, n, 700, seed=0, device=dev)
b = generate_dense(n, k, seed=1, device=dev)

c = sp.multiply(a_csr, b)
expected = a_csr.todense().cpu().numpy() @ b.cpu().numpy()
assert np.allclose(c.cpu().numpy(), expected, rtol=1e-4)

# same call, CSC operand (the op canonicalizes formats internally)
a_csc = generate_csc(m, n, 700, seed=0, device=dev)
c2 = sp.multiply(a_csc, b)
expected2 = a_csc.todense().cpu().numpy() @ b.cpu().numpy()
assert np.allclose(c2.cpu().numpy(), expected2, rtol=1e-4)
print("ok")

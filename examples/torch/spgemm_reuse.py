"""Numeric-reuse SpGEMM — the port's twin of examples/spgemm_reuse.py:
one symbolic phase, many numeric re-runs with new values over unchanged
sparsity, plus the 4-argument fused form C = alpha*A*B + beta*D.

    python examples/torch/spgemm_reuse.py                # on the card
    python examples/torch/spgemm_reuse.py --device cpu   # on the CPU
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.utils.generate import generate_csr

parser = argparse.ArgumentParser(description="numeric-reuse SpGEMM")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

m = k = n = 80
a = generate_csr(m, k, 600, seed=0, device=dev)
b = generate_csr(k, n, 600, seed=1, device=dev)

state = sp.SpgemmState()
sp.multiply_symbolic_compute(state, a, b)
c_struct = sp.multiply_symbolic_fill(state, a, b)
print("symbolic nnz:", state.info.result_nnz)

dense_b = b.todense().cpu().numpy()
for it in range(3):
    a_new = dataclasses.replace(a, values=a.values * (it + 1.0))
    c = sp.multiply_numeric(state, a_new, b)
    expected = a_new.todense().cpu().numpy() @ dense_b
    assert np.allclose(c.todense().cpu().numpy(), expected, rtol=1e-4)

# fused 4-arg form
d = generate_csr(m, n, 400, seed=2, device=dev)
c4 = sp.multiply_fused(sp.SpgemmState(), sp.scaled(2.0, a), b,
                       sp.scaled(3.0, d))
expected4 = 2.0 * a.todense().cpu().numpy() @ dense_b + \
    3.0 * d.todense().cpu().numpy()
assert np.allclose(c4.todense().cpu().numpy(), expected4, rtol=1e-4)
print("ok")

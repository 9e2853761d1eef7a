"""Two-phase SpGEMM walk-through — the port's twin of
examples/simple_spgemm.py.

The canonical inspector-executor protocol: symbolic ``multiply_compute``
returns an info with ``result_nnz``; the caller sizes the output; numeric
``multiply_fill`` populates it (on the card, one launch of the slot fill
over the mul engine's expansion stream).

    python examples/torch/simple_spgemm.py                # on the card
    python examples/torch/simple_spgemm.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.utils.generate import generate_csr

parser = argparse.ArgumentParser(description="two-phase SpGEMM")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

m, k, n = 100, 80, 120

a = generate_csr(m, k, 600, seed=0, device=dev)
b = generate_csr(k, n, 500, seed=1, device=dev)

# symbolic phase: structure + nnz (the one device→host sync)
info = sp.multiply_compute(a, b)
print("result shape:", info.result_shape, "nnz:", info.result_nnz)

# numeric phase into the computed structure
c = sp.multiply_fill(info, a, b)
print("C:", c)

expected = a.todense().cpu().numpy() @ b.todense().cpu().numpy()
assert np.allclose(c.todense().cpu().numpy(), expected, rtol=1e-4)
print("ok")

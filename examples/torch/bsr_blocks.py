"""Block-sparse (BSR) tour — the port's twin of examples/bsr_blocks.py:
SpMV, SpMM and block SpGEMM.

Every stored nonzero of a BSR is a dense (bh, bw) tile, so products run
with no index traffic inside blocks.  On the card the BSR SpMV
(``csrc/bsr_spmv.cu``), the BSR SpMM and the block SpGEMM (both on the
tensor cores at full f32 accuracy, ``csrc/bsr_spmm.cu``,
``csrc/bsr_spgemm.cu``) run; on the CPU their plain versions.

    python examples/torch/bsr_blocks.py                # on the card
    python examples/torch/bsr_blocks.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import spblas_tpu_torch as sp
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.kernels.bsr_spgemm import (bsr_spgemm_compute,
                                                 bsr_spgemm_numeric)

parser = argparse.ArgumentParser(description="block-sparse tour")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

rng = np.random.default_rng(0)


def blocky(m, n, bh, bw, nblocks, seed):
    r = np.random.default_rng(seed)
    d = np.zeros((m, n), np.float32)
    for _ in range(nblocks):
        i, j = r.integers(m // bh), r.integers(n // bw)
        d[i*bh:(i+1)*bh, j*bw:(j+1)*bw] = r.standard_normal((bh, bw))
    return d


da = blocky(64, 512, 8, 128, 16, seed=1)
a = BSR.from_dense(da, (8, 128), device=dev)
print("A:", a)

# SpMV / SpMM through the polymorphic multiply
x = rng.standard_normal(512).astype(np.float32)
y = sp.multiply(a, torch.from_numpy(x).to(a.device))
assert np.allclose(y.cpu().numpy(), da @ x, rtol=1e-4, atol=1e-4)

b = rng.standard_normal((512, 128)).astype(np.float32)
c = sp.multiply(a, torch.from_numpy(b).to(a.device))
assert np.allclose(c.cpu().numpy(), da @ b, rtol=1e-3, atol=1e-3)

# block SpGEMM with numeric reuse (two-phase over the block graph)
db = blocky(512, 384, 128, 128, 10, seed=2)
bm = BSR.from_dense(db, (128, 128), device=dev)
plan = bsr_spgemm_compute(a, bm)
print("C blocks:", plan.nnzb_c)
c1 = bsr_spgemm_numeric(plan, a, bm)
assert np.allclose(c1.todense().cpu().numpy(), da @ db, rtol=1e-3,
                   atol=1e-3)

# same through multiply: BSR x BSR routes to the block kernel
c2 = sp.multiply(a, bm)
assert isinstance(c2, BSR)
print("ok")

"""Mesh-family matrices: stencils and FEM graphs — the port's twin of
examples/mesh_matrices.py.

Discretized PDE operators are a few dense diagonals spread wide: band
fill ~0.002 but DIA fill 0.8-1.0.  A DIA plan stores them as dense
diagonals, and on the card ``dia_spmv`` runs the fused multi-diagonal
kernel (``csrc/dia_spmv.cu``), which reads x and every diagonal once.
The same matrix also goes through the public ``matrix_opt`` surface,
whose chooser picks its own kind.

    python examples/torch/mesh_matrices.py                # on the card
    python examples/torch/mesh_matrices.py --device cpu   # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import spblas_tpu_torch as sp
from spblas_tpu_torch.kernels.dia import (build_dia_plan, dia_fill_fraction,
                                          dia_spmm, dia_spmv)
from spblas_tpu_torch.utils.generate import (generate_fem_graph_csr,
                                             generate_stencil_csr,
                                             generate_vector)

parser = argparse.ArgumentParser(description="mesh-family matrices")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

# --- 2D 5-point Poisson stencil ------------------------------------ #
a = generate_stencil_csr((40, 50), device=dev)   # 2000x2000, 5 diagonals
m = a.shape[0]
x = generate_vector(m, seed=1, device=dev)
dense = a.todense().cpu().numpy()

plan = build_dia_plan(a)
print(f"2D stencil: {len(plan.offsets)} diagonals, "
      f"DIA fill {dia_fill_fraction(a):.2f}")
y = dia_spmv(plan, x).cpu().numpy()
np.testing.assert_allclose(y, dense @ x.cpu().numpy(), rtol=1e-4, atol=1e-4)

# through the public inspector-executor surface
aopt = sp.matrix_opt(a)
y2 = sp.multiply(aopt, x).cpu().numpy()
np.testing.assert_allclose(y2, dense @ x.cpu().numpy(), rtol=1e-4,
                           atol=1e-4)
print(f"matrix_opt kind: {aopt._plans['matvec'][0]}")

# --- 3D 7-point stencil --------------------------------------------- #
a3 = generate_stencil_csr((12, 13, 14), device=dev)
x3 = generate_vector(a3.shape[0], seed=2, device=dev)
p3 = build_dia_plan(a3)
y3 = dia_spmv(p3, x3).cpu().numpy()
np.testing.assert_allclose(y3, a3.todense().cpu().numpy()
                           @ x3.cpu().numpy(), rtol=1e-4, atol=1e-4)
print(f"3D stencil: {len(p3.offsets)} diagonals ok")

# --- FEM-style triangulated graph ----------------------------------- #
af = generate_fem_graph_csr(30, 35, seed=3, device=dev)
xf = generate_vector(af.shape[0], seed=4, device=dev)
pf = build_dia_plan(af)
yf = dia_spmv(pf, xf).cpu().numpy()
np.testing.assert_allclose(yf, af.todense().cpu().numpy()
                           @ xf.cpu().numpy(), rtol=1e-4, atol=1e-4)
print(f"FEM graph: {len(pf.offsets)} offset diagonals ok")

# SpMM over the same plan (k right-hand sides in one pass)
B = generate_vector(af.shape[0] * 8, seed=5,
                    device=dev).reshape(af.shape[0], 8)
C = dia_spmm(pf, B).cpu().numpy()
np.testing.assert_allclose(C, af.todense().cpu().numpy() @ B.cpu().numpy(),
                           rtol=1e-4, atol=1e-4)
print("mesh_matrices example ok")

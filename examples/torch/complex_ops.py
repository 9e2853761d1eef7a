"""Complex-valued operations tour — the port's twin of
examples/complex_ops.py.

complex64 runs through every op, and the structured plans get dual-plane
treatment:

  banded complex        -> two real band-panel plans   ("band_cx")
  unstructured complex  -> two real ROUTE2 plans       ("route_cx"; on
                           the card one pass of the complex ROUTE2
                           kernel over both value planes)
  conjugated views      -> folded into values at dispatch
  Matrix Market complex -> 'complex general' files round-trip

On the card the ``matrix_opt`` chooser picks the two plan kinds; on the
CPU, whose chooser has no ROUTE or band rung for complex values, the
tour calls the builders the card's chooser calls, and the plans run
their kernels' plain versions.  Every step asserts a dense oracle.

    python examples/torch/complex_ops.py                # on the card
    python examples/torch/complex_ops.py --device cpu   # on the CPU
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import spblas_tpu_torch as sp
from spblas_tpu_torch.kernels import plans as _plans
from spblas_tpu_torch.utils.generate import generate_banded_csr, generate_csr
from spblas_tpu_torch.utils.io import load_matrix_market, save_matrix_market

parser = argparse.ArgumentParser(description="complex-valued tour")
parser.add_argument("--device", default=None,
                    help="device of every tensor (default: the card)")
dev = parser.parse_args().device

rng = np.random.default_rng(0)


def complexify(a, seed):
    r = np.random.default_rng(seed)
    vi = r.standard_normal(a.values.shape[0]).astype(np.float32)
    vi[a.nnz:] = 0.0                       # canonical zero padding
    vc = torch.complex(a.values, torch.from_numpy(vi).to(a.device))
    return dataclasses.replace(a, values=vc)


def chosen(a, rung):
    """The matvec chooser's (kind, plan) on the card; on the CPU the
    rung it takes there, built by ``rung``."""
    if a.device.type == "cuda":
        return _plans.build_matvec_plan(a)
    return rung(a)


# --- unstructured complex SpMV: dual-plane ROUTE ------------------- #
ac = complexify(generate_csr(2048, 2048, 16_000, seed=1, device=dev), 2)
kind, plan = chosen(ac, _plans._try_route_cx)
assert kind == "route_cx", kind
x = (rng.standard_normal(2048)
     + 1j * rng.standard_normal(2048)).astype(np.complex64)
xt = torch.from_numpy(x).to(ac.device)
y = _plans.plan_spmv((kind, plan), xt).cpu().numpy()
dense = ac.todense().cpu().numpy()
assert np.allclose(y, dense @ x, rtol=1e-3, atol=1e-2)
print(f"unstructured complex -> {kind:8s} ok")

# --- banded complex: dual-plane band panels ------------------------ #
ab = complexify(generate_banded_csr(2048, 2048, 9, seed=3, device=dev), 4)
kind_b, plan_b = chosen(ab, lambda t: ("band_cx", _plans._build_band_cx(t)))
assert kind_b == "band_cx", kind_b
yb = _plans.plan_spmv((kind_b, plan_b), xt).cpu().numpy()
dense_b = ab.todense().cpu().numpy()
assert np.allclose(yb, dense_b @ x, rtol=1e-3, atol=1e-2)
print(f"banded complex       -> {kind_b:8s} ok")

# --- conjugated / scaled views fold into every op ------------------ #
y2 = sp.multiply(sp.scaled(2j, sp.conjugated(ac)), xt).cpu().numpy()
assert np.allclose(y2, 2j * (np.conj(dense) @ x), rtol=1e-3, atol=1e-2)
print("scaled(2j, conjugated(A)) @ x ok")

# complex SpGEMM through the two-phase protocol
bc = complexify(generate_csr(512, 512, 4_000, seed=5, device=dev), 6)
info = sp.multiply_compute(bc, sp.conjugated(bc))
c = sp.multiply_fill(info, bc, sp.conjugated(bc))
db = bc.todense().cpu().numpy()
assert np.allclose(c.todense().cpu().numpy(), db @ np.conj(db),
                   rtol=1e-3, atol=1e-2)
print(f"complex SpGEMM (nnz {info.result_nnz}) ok")

# --- complex Matrix Market round-trip ------------------------------ #
fd, path = tempfile.mkstemp(suffix=".mtx")
os.close(fd)
try:
    save_matrix_market(path, ac)
    with open(path) as f:
        assert "complex general" in f.readline()
    back = load_matrix_market(path, device=dev)
    assert back.dtype.is_complex
    assert np.allclose(back.todense().cpu().numpy(), dense,
                       rtol=1e-4, atol=1e-4)
    print("complex MatrixMarket round-trip ok")
finally:
    os.unlink(path)

print("complex_ops: all oracles passed")

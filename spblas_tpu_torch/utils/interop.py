"""Carrying state across from the JAX package.

The JAX package's arrays, handed over as numpy (``np.asarray`` of its
containers and plans), become the port's objects on ``device`` bit for
bit.  With these, both packages run on the same matrix and the same plan.
"""

from __future__ import annotations

import numpy as np

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.kernels.banded import BandPlan
from spblas_tpu_torch.kernels.dia import DiaPlan


def csr_from_numpy(values, rowptr, colind, nnz, shape,
                   device=None) -> CSR:
    """A CSR over the given arrays; their length is kept as the capacity
    (padding past ``nnz`` is made canonical)."""
    values = np.asarray(values)
    return CSR.from_arrays(values, np.asarray(rowptr), np.asarray(colind),
                           shape, nnz=int(nnz), capacity=len(values),
                           device=device)


def band_plan_from_numpy(panels, pad_l, shape, device=None) -> BandPlan:
    """A BandPlan over the JAX plan's panels (f32, or bfloat16 as
    ml_dtypes hands it over)."""
    dev = _t.resolve_device(device)
    return BandPlan(panels=_t.as_tensor(np.asarray(panels), dev),
                    pad_l=int(pad_l), shape=(int(shape[0]), int(shape[1])))


def dia_plan_from_numpy(diags, offsets, shape, device=None) -> DiaPlan:
    """A DiaPlan over the JAX plan's (ndiag, rows_pad, 128) diagonals."""
    dev = _t.resolve_device(device)
    return DiaPlan(diags=_t.as_tensor(np.asarray(diags), dev),
                   offsets=tuple(int(o) for o in offsets),
                   shape=(int(shape[0]), int(shape[1])))

"""scale — eager alpha-scaling of a tensor's values, counterpart of
``spblas_tpu/ops/scale.py``: a new container (or dense tensor) with
scaled values, on the operand's device."""

from __future__ import annotations

import dataclasses

import torch


def scale(alpha, t):
    alpha = torch.as_tensor(alpha)
    if dataclasses.is_dataclass(t) and hasattr(t, "values"):
        # every sparse container (CSR/CSC/COO/BSR/DCSR) keeps all its
        # numerics in .values
        return dataclasses.replace(t, values=t.values * alpha)
    return torch.as_tensor(t) * alpha

"""ELL (padded-row) plan — counterpart of ``spblas_tpu/kernels/ell.py``.

CSR rows padded to one common width W, so the per-row entry loop becomes
a dense (m_pad, W) axis: SpMV is one 2-D gather of x, a multiply and a
row sum; SpMM gathers whole rows of B (``sell.bucket_matmul``).  The JAX
module is XLA code with no Pallas kernel, so these are torch ops on the
plan's device.  The geometry comes from the native inspector
(``native.ell_geometry``, C++).  No rung of the ``matrix_opt`` ladder
builds an ELL plan; ``plans.plan_spmv``/``plan_spmm`` run one handed to
them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.kernels.sell import bucket_matmul


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """Padded-row layout: values and columns re-laid as (m_pad, W)."""

    values: torch.Tensor      # (m_pad, W), padding 0
    cols: torch.Tensor        # (m_pad, W) int32, padding column 0
    gather_idx: torch.Tensor  # (m_pad, W) int32 into the CSR's values
    valid: torch.Tensor       # (m_pad, W) bool
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return int(self.values.shape[1])

    @property
    def m_pad(self) -> int:
        return int(self.values.shape[0])

    def refresh_values(self, csr_values: torch.Tensor) -> "EllPlan":
        """Re-gather after a numeric update with unchanged sparsity."""
        vals = torch.where(self.valid, csr_values[self.gather_idx.long()],
                           0)
        return dataclasses.replace(self, values=vals)


def build_ell_plan(a: CSR, row_pad: int = 8) -> EllPlan:
    """Host-side plan construction (inspect phase), placed on the
    matrix's device."""
    m, n = a.shape
    m_pad = -(-m // row_pad) * row_pad
    gather, cols, valid, _ = native.ell_geometry(
        m, m_pad, a.nnz, _t.to_numpy(a.rowptr), _t.to_numpy(a.colind))
    dev = a.device
    g = torch.from_numpy(gather).to(dev)
    v = torch.from_numpy(valid).to(dev)
    return EllPlan(values=torch.where(v, a.values[g.long()], 0),
                   cols=torch.from_numpy(cols).to(dev), gather_idx=g,
                   valid=v, shape=(m, n))


def ell_spmv(plan: EllPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the padded layout: gather and row sum (padding
    contributes 0)."""
    return (plan.values * x[plan.cols.long()]).sum(dim=1)[:plan.shape[0]]


def ell_spmm(plan: EllPlan, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B: W accumulated row gathers of B (one 3-D gather past
    ``sell._UNROLL_MAX``), as ``sell.bucket_matmul`` runs them."""
    return bucket_matmul(plan.values, plan.cols, b)[:plan.shape[0]]

"""SELL (sliced/bucketed ELL) — counterpart of ``spblas_tpu/kernels/sell.py``.

Rows are bucketed by degree on a fine width ladder; each bucket is a
dense (mb, Wb) block of values and columns.  SpMV is a gather, multiply
and row sum per bucket, un-permuted with one row gather; rows with no
entries read an appended zero.  SpMM gathers whole rows of B the same
way (:func:`bucket_matmul`).  This is the general-sparsity rung of the
port (the JAX package's own off-TPU rung) and runs as torch ops: it has
no hand-written kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR

_WIDTH_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32,
                 40, 48, 56, 64)
# buckets up to this width take W accumulated row gathers in SpMM; wider
# (hub) buckets one 3-D gather and an einsum
_UNROLL_MAX = 64


def _bucket_width(deg: int) -> int:
    """Smallest ladder width >= deg (pow-2 beyond the ladder)."""
    for w in _WIDTH_LADDER:
        if deg <= w:
            return w
    return 1 << int(deg - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SellBucket:
    values: torch.Tensor       # (mb, Wb), padding 0
    cols: torch.Tensor         # (mb, Wb) int32, padding 0


@dataclasses.dataclass(frozen=True)
class SellPlan:
    """Degree-bucketed layout + the inverse row permutation."""

    buckets: Tuple[SellBucket, ...]
    pos: torch.Tensor          # (m,) int32: row i's slot in the concat
    shape: Tuple[int, int]


def build_sell_plan(a: CSR) -> SellPlan:
    """Host-side bucketing (inspect phase), placed on the matrix's device."""
    m, n = a.shape
    nnz = a.nnz
    rowptr = np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), nnz)
    colind = _t.to_numpy(a.colind[:nnz]).astype(np.int64)
    values = _t.to_numpy(a.values[:nnz])
    deg = np.diff(rowptr)
    live = np.flatnonzero(deg > 0)
    ladder = np.asarray(_WIDTH_LADDER, np.int64)
    bid = np.zeros(len(deg), np.int64)
    if len(live):
        dl = deg[live]
        in_ladder = np.searchsorted(ladder, dl)
        beyond = np.ceil(np.log2(np.maximum(dl, 2))).astype(np.int64)
        bid[live] = np.where(dl <= ladder[-1], in_ladder,
                             len(ladder) + beyond)
    order = live[np.argsort(bid[live], kind="stable")]
    pos = np.full(m, len(order), np.int64)   # default: the zero row
    pos[order] = np.arange(len(order))

    buckets = []
    sorted_bids = bid[order]
    bounds = np.flatnonzero(np.diff(sorted_bids)) + 1
    starts = np.concatenate([[0], bounds]) if len(order) else []
    ends = np.concatenate([bounds, [len(order)]]) if len(order) else []
    dev = a.device
    for s0, s1 in zip(starts, ends):
        rows = order[s0:s1]
        wb = _bucket_width(int(deg[rows].max()))
        offs = rowptr[rows][:, None] + np.arange(wb)[None, :]
        val_mask = np.arange(wb)[None, :] < deg[rows][:, None]
        gidx = np.where(val_mask, offs, 0)
        buckets.append(SellBucket(
            values=torch.from_numpy(
                np.where(val_mask, values[gidx], 0).astype(values.dtype)
            ).to(dev),
            cols=torch.from_numpy(
                np.where(val_mask, colind[gidx], 0).astype(np.int32)
            ).to(dev)))
    return SellPlan(buckets=tuple(buckets),
                    pos=torch.from_numpy(pos.astype(np.int32)).to(dev),
                    shape=(m, n))


def sell_spmv(plan: SellPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the bucketed layout."""
    vdt = plan.buckets[0].values.dtype if plan.buckets else torch.float32
    dt = torch.promote_types(vdt, x.dtype)
    parts = [(b.values * x[b.cols]).sum(dim=1).to(dt)
             for b in plan.buckets]
    parts.append(torch.zeros(1, dtype=dt, device=x.device))
    return torch.cat(parts)[plan.pos]


def bucket_matmul(values: torch.Tensor, cols: torch.Tensor,
                  mat: torch.Tensor) -> torch.Tensor:
    """(mb, W) padded rows times dense mat -> (mb, k): W accumulated row
    gathers for moderate widths, one 3-D gather and an einsum for wide
    hub buckets (few rows there).  The einsum runs in float64
    (:func:`types.wide_matmul`), so no TF32 setting reaches it."""
    if values.shape[1] <= _UNROLL_MAX:
        acc = torch.zeros(values.shape[0], mat.shape[1],
                          dtype=torch.promote_types(values.dtype, mat.dtype),
                          device=mat.device)
        for w in range(values.shape[1]):
            acc = acc + values[:, w, None] * mat.index_select(
                0, cols[:, w])
        return acc
    bg = mat[cols.long()]
    return _t.wide_matmul(lambda v, g: torch.einsum("mw,mwk->mk", v, g),
                          values, bg)


def sell_spmm(plan: SellPlan, mat: torch.Tensor) -> torch.Tensor:
    """C = A @ B over the bucketed layout."""
    k = mat.shape[1]
    vdt = plan.buckets[0].values.dtype if plan.buckets else torch.float32
    dt = torch.promote_types(vdt, mat.dtype)
    parts = [bucket_matmul(b.values, b.cols, mat).to(dt)
             for b in plan.buckets]
    parts.append(torch.zeros(1, k, dtype=dt, device=mat.device))
    return torch.cat(parts).index_select(0, plan.pos)

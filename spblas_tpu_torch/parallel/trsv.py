"""Distributed SpTRSV: block substitution over a row-partitioned factor —
counterpart of ``spblas_tpu/parallel/trsv.py``.

A triangular A is row-partitioned into p blocks.  Step d (d = 0 .. p-1
for a lower factor, p-1 .. 0 for an upper one) solves the diagonal block
on rank d by its local level schedule, after folding every piece solved
so far into its right-hand side through its off-diagonal entries; the
solved piece then goes to every rank.  The JAX package shares it by a
``psum`` of a vector that only the solving device fills; the port
broadcasts it from the solving rank (``dist.broadcast``), which gives
the same values up to the sign of a zero (the sum turns a -0.0 into
+0.0), and only the solving rank computes its step.  The level sweep is
torch ops, as the JAX one is jnp.

The inspect phase builds each rank's padded level schedule (one (L, R, W)
over all ranks, agreed by a MAX all-reduce, so every array is ``[rank]``
of the JAX plan's) and its off-diagonal entries as global-column COO.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import native
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import host_arrays
from spblas_tpu_torch.ops.triangular_solve import _check_diag, _check_uplo
from spblas_tpu_torch.parallel.mesh import RowMesh, check_mesh_matches


@dataclasses.dataclass(frozen=True)
class DistTrsvPlan:
    """This rank's arrays (``[rank]`` of the JAX plan's).

    Diagonal-block schedule (sentinel mloc rows are padding): rows
    (L, R); eidx, evalid, cols (L, R, W), eidx into the rank's block
    values lvals (lcap,); ldiag (L, R).  Off-diagonal entries: ovals,
    ocols (global columns) and orows (local row, sentinel mloc), each
    (ocap,)."""

    rows: torch.Tensor
    eidx: torch.Tensor
    evalid: torch.Tensor
    cols: torch.Tensor
    ldiag: torch.Tensor
    lvals: torch.Tensor
    ovals: torch.Tensor
    ocols: torch.Tensor
    orows: torch.Tensor
    lower: bool
    unit_diag: bool
    mloc: int
    shape: Tuple[int, int]
    p: int
    rank: int


def dist_triangular_solve_inspect(a, mesh: RowMesh, uplo: str = "lower",
                                  diag: str = "explicit") -> DistTrsvPlan:
    """Host inspect: this rank's level schedule of its diagonal block and
    its off-diagonal entries, in the common padded geometry."""
    a = to_csr(a)
    m, n = a.shape
    if m != n:
        raise ValueError("triangular solve requires square A")
    lower = _check_uplo(uplo)
    unit = _check_diag(diag)
    p, d = mesh.size, mesh.rank
    mloc = -(-m // p)
    g_rows, g_cols, g_vals = host_arrays(a)
    g_rows = g_rows.astype(np.int64)
    g_cols = g_cols.astype(np.int64)
    dev = g_rows // mloc
    diag_blk = dev == g_cols // mloc

    sel = (dev == d) & diag_blk
    lv = g_vals[sel]
    lr = g_rows[sel] - d * mloc
    lc = g_cols[sel] - d * mloc
    r1 = max(0, min((d + 1) * mloc, m) - min(d * mloc, m))
    lrp = np.zeros(r1 + 1, np.int64)
    np.add.at(lrp[1:], lr, 1)
    lrp = np.cumsum(lrp)
    order = np.lexsort((lc, lr))
    lv, lc2 = lv[order], lc[order].astype(np.int32)
    levels, diag_pos, nl = native.level_schedule(r1, len(lv), lrp, lc2,
                                                 lower, unit)
    row_of = np.repeat(np.arange(r1), np.diff(lrp))
    off_mask = (lc2 < row_of) if lower else (lc2 > row_of)
    osel = (dev == d) & ~diag_blk
    counts = np.bincount(levels, minlength=max(nl, 1)) if r1 else \
        np.zeros(1, np.int64)
    rowlen = np.zeros(r1, np.int64)
    np.add.at(rowlen, row_of, off_mask)
    L, R, W, ocap, lcap = mesh.reduce_ints(
        [max(nl, 1), max(int(counts.max()), 1),
         max(int(rowlen.max()) if r1 else 1, 1), max(int(osel.sum()), 1),
         max(len(lv), 1)], "max")

    rows_a = np.full((L, R), mloc, np.int32)
    eidx_a = np.zeros((L, R, W), np.int32)
    evalid_a = np.zeros((L, R, W), bool)
    cols_a = np.zeros((L, R, W), np.int32)
    ldiag_a = np.full((L, R), -1, np.int32)
    lvals_a = np.zeros(lcap, g_vals.dtype)
    ovals_a = np.zeros(ocap, g_vals.dtype)
    ocols_a = np.zeros(ocap, np.int32)
    orows_a = np.full(ocap, mloc, np.int32)
    lvals_a[:len(lv)] = lv
    k = int(osel.sum())
    ovals_a[:k] = g_vals[osel]
    ocols_a[:k] = g_cols[osel]
    orows_a[:k] = g_rows[osel] - d * mloc
    if r1:
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        j_of = np.empty(r1, np.int64)
        j_of[np.argsort(levels, kind="stable")] = \
            np.arange(r1) - np.repeat(starts, counts)
        rows_a[levels, j_of] = np.arange(r1, dtype=np.int32)
        ldiag_a[levels, j_of] = diag_pos.astype(np.int32)
        c = np.cumsum(off_mask)
        base = np.concatenate([[0], c])[lrp[:-1]]
        rank_in_row = (c - 1) - np.repeat(base, np.diff(lrp))
        om = off_mask.astype(bool)
        lv_e, j_e = levels[row_of[om]], j_of[row_of[om]]
        r_e = rank_in_row[om]
        eidx_a[lv_e, j_e, r_e] = np.arange(len(lv))[om].astype(np.int32)
        evalid_a[lv_e, j_e, r_e] = True
        cols_a[lv_e, j_e, r_e] = lc2[om]

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)

    return DistTrsvPlan(
        rows=put(rows_a), eidx=put(eidx_a), evalid=put(evalid_a),
        cols=put(cols_a), ldiag=put(ldiag_a), lvals=put(lvals_a),
        ovals=put(ovals_a), ocols=put(ocols_a), orows=put(orows_a),
        lower=lower, unit_diag=unit, mloc=mloc, shape=(m, n), p=p, rank=d)


def _local_solve(plan: DistTrsvPlan, rhs: torch.Tensor) -> torch.Tensor:
    """The diagonal block's level sweep: each level's rows at once, row
    r's x = (rhs_r - sum of its solved off-diagonal terms) / its
    diagonal; the sentinel row mloc takes the padding."""
    mloc = plan.mloc
    x = rhs.new_zeros(mloc + 1)
    rhs = torch.cat([rhs, rhs.new_zeros(1)])
    for lv in range(plan.rows.shape[0]):
        r = plan.rows[lv].long()
        av = torch.where(plan.evalid[lv], plan.lvals[plan.eidx[lv].long()],
                         0).to(rhs.dtype)
        dot = (av * x[plan.cols[lv].long()]).sum(dim=-1)
        dpos = plan.ldiag[lv].long()
        dval = torch.where(dpos >= 0, plan.lvals[dpos.clamp(min=0)],
                           1).to(rhs.dtype)
        x[r] = (rhs[r] - dot) / dval
    return x[:mloc]


def dist_triangular_solve(plan: DistTrsvPlan, b: torch.Tensor,
                          mesh: RowMesh) -> torch.Tensor:
    """x = A^{-1} b with b this rank's (mloc,) piece; returns its (mloc,)
    piece of x.  p steps, each one broadcast of the solved piece."""
    p, mloc, d = plan.p, plan.mloc, mesh.rank
    check_mesh_matches(p, mesh, "dist_triangular_solve", rank=plan.rank)
    if b.shape[0] != mloc:
        raise ValueError(f"b length {b.shape[0]} != local {mloc}")
    dt = torch.promote_types(plan.lvals.dtype, b.dtype)
    x_glob = b.new_zeros(p * mloc, dtype=dt)
    steps = range(p) if plan.lower else range(p - 1, -1, -1)
    for step in steps:
        piece = b.new_zeros(mloc, dtype=dt)
        if step == d:
            # fold the pieces solved so far through the off-diagonal
            # entries, then solve the diagonal block
            adj = piece.new_zeros(mloc + 1).index_add_(
                0, plan.orows.long(),
                plan.ovals.to(dt) * x_glob[plan.ocols.long()])[:mloc]
            piece = _local_solve(plan, b.to(dt) - adj)
        x_glob[step * mloc:(step + 1) * mloc] = mesh.broadcast(piece, step)
    return x_glob[d * mloc:(d + 1) * mloc]

"""Distributed unstructured SpMV and SpMM: per-rank ROUTE2 and SELL plans
— counterpart of ``spblas_tpu/parallel/route_spmv.py``.

Each rank's row block gets its own ROUTE2 plan, built with the JAX
package's common geometry so that every rank's arrays are bit-equal to
its slice of JAX's stacked plan: one window factor g from the global
density, one supercell height and any-lane flag from every block's
expected cell fill, and the chunk streams padded to the largest rank's
chunk count (a multiple of 8; padding chunks carry vA = 0 and publish
nothing).  Each rank builds only its own plan and the ranks agree on the
padding by a MAX all-reduce of their geometry.  One process a rank needs
none of that padding; it is kept for the parity and trimming it is on
the speed queue.

:func:`dist_route_spmv` all-gathers x, then runs ``route2_spmv_padded``
(``csrc/route2_spmv.cu``) over the rank's plan: one launch a launch range,
one on a plan without aux levels.  :func:`dist_sell_spmm` all-gathers B
and runs the port's SELL ``bucket_matmul`` as torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.kernels import route2 as _r2
from spblas_tpu_torch.kernels import route2_kernel as _r2k
from spblas_tpu_torch.kernels import sell as _sell
from spblas_tpu_torch.parallel.mesh import RowMesh, check_mesh_matches
from spblas_tpu_torch.parallel.rowblock import local_rowptr


@dataclasses.dataclass(frozen=True)
class DistRoutePlan:
    """This rank's ROUTE2 plan (``route``: tile, val, slab_base, y_base
    and src_flag are ``[rank]`` of the JAX plan's stacked arrays, g,
    x_rows, dist_max, any_lane and row_window_mult its common fields),
    with the port's own launch starts.  ``out_rows`` and ``has_aux`` are
    the JAX plan's stacked pane height and aux flag; each rank's kernel
    sizes its pane from its own plan."""

    route: _r2.Route2Plan
    shape: Tuple[int, int]
    mloc: int
    nloc: int
    out_rows: int
    has_aux: bool
    p: int
    rank: int

    tile = property(lambda self: self.route.tile)
    val = property(lambda self: self.route.val)
    slab_base = property(lambda self: self.route.slab_base)
    y_base = property(lambda self: self.route.y_base)
    src_flag = property(lambda self: self.route.src_flag)
    g = property(lambda self: self.route.g)
    x_rows = property(lambda self: self.route.x_rows)
    dist_max = property(lambda self: self.route.dist_max)
    any_lane = property(lambda self: self.route.any_lane)
    row_window_mult = property(lambda self: self.route.row_window_mult)


def _pad_rows(arr: np.ndarray, rows: int, value=0,
              edge: bool = False) -> np.ndarray:
    """``arr`` grown to ``rows`` rows: the last row repeated (``edge``) or
    ``value``."""
    padn = rows - arr.shape[0]
    if edge and arr.shape[0]:
        pad = np.repeat(arr[-1:], padn, axis=0)
    else:
        pad = np.full((padn,) + arr.shape[1:], value, arr.dtype)
    return np.concatenate([arr, pad])


def partition_route(a, mesh: RowMesh) -> DistRoutePlan:
    """Host inspect step: this rank's ROUTE2 plan, in the common SPMD
    geometry of every rank's."""
    a = to_csr(a)
    p, d = mesh.size, mesh.rank
    m, n = a.shape
    mloc = -(-m // p)
    nloc = -(-n // p)
    nnz = a.nnz
    rowptr = np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), nnz)

    # common g from the global density (a per-rank choice could differ
    # across skewed blocks); common publish geometry from every block's
    # expected elements per cell: supercells first, any-lane where they
    # are not taken and most blocks are starved
    g = _r2.pick_window_g(mloc, n, max(nnz // p, 1))
    window = g * _r2.SLOTS
    block_nnz = [int(rowptr[min((r + 1) * mloc, m)]
                     - rowptr[min(r * mloc, m)]) for r in range(p)]
    e_cell = [k * window / max(mloc * n, 1) * _r2.ROW_WINDOW
              for k in block_nnz]
    ww = _r2.pick_row_window_mult(min(e_cell), max_rows=mloc)
    any_lane = ww == 1 and sum(e < 768.0 for e in e_cell) * 2 > p

    lo, hi, sub_rp = local_rowptr(rowptr, d, mloc, m)
    # hub rows and rotations pinned off: the JAX plan carries neither
    A = _r2._build_route2_arrays(
        sub_rp, _t.to_numpy(a.colind[lo:hi]), _t.to_numpy(a.values[lo:hi]),
        (mloc, n), hi - lo, any_lane=any_lane, row_window_mult=ww,
        hub_deg=0, rotate=False, g=g)
    own_out = max(A["y_rows"] + A["aux_rows"], _r2.SUBS * g)
    nch, x_rows, out_rows, has_aux, dist_max = mesh.reduce_ints(
        [len(A["tiles"]), A["x_rows"], own_out, A["n_aux_chunks"] > 0,
         A["dist_max"]], "max")
    # whole groups of 8 chunks, so every rank's tail stays flag-homogeneous
    nch = -(-nch // 8) * 8
    A.update(tiles=_pad_rows(A["tiles"], nch), vals=_pad_rows(A["vals"], nch),
             srcs=_pad_rows(A["srcs"], nch, -1), sb=_pad_rows(A["sb"], nch),
             yb=_pad_rows(A["yb"], nch),
             flags=_pad_rows(A["flags"], nch, edge=True),
             x_rows=x_rows, dist_max=dist_max)
    return DistRoutePlan(route=_r2.plan_from_arrays(A, mesh.device),
                         shape=(m, n), mloc=mloc, nloc=nloc,
                         out_rows=out_rows, has_aux=bool(has_aux), p=p,
                         rank=d)


def dist_route_spmv(plan: DistRoutePlan, x: torch.Tensor, mesh: RowMesh
                    ) -> torch.Tensor:
    """y = A @ x with x this rank's (nloc,) piece (as ``dist_spmv``);
    returns its (mloc,) piece of y: one all-gather of x, then the rank's
    plan on ``route2_spmv_padded``."""
    check_mesh_matches(plan.p, mesh, "dist_route_spmv", rank=plan.rank)
    n = plan.shape[1]
    if x.shape[0] != plan.nloc:
        raise ValueError(
            f"operand length {x.shape[0]} != local n {plan.nloc}; "
            "use partition_vector")
    xg = mesh.all_gather(x).reshape(-1)[:n]
    pane = _r2k.route2_spmv_padded(plan.route, _r2k.pack_x2(plan.route, xg))
    return pane.view(-1)[: plan.mloc].to(x.dtype)


# ------------------------------------------------------------------ #
# distributed unstructured SpMM: per-rank SELL plans
# ------------------------------------------------------------------ #

@dataclasses.dataclass(frozen=True)
class DistSellPlan:
    """This rank's SELL plan in the common bucket geometry: the bucket
    widths are the union over ranks and each bucket's rows the most any
    rank has (pad rows gather B row 0 with value 0); ``[rank]`` of the
    JAX plan's stacked arrays."""

    bucket_values: Tuple[torch.Tensor, ...]   # each (mb, Wb) f32
    bucket_cols: Tuple[torch.Tensor, ...]     # each (mb, Wb) int32
    pos: torch.Tensor                         # (mloc,) int32 concat slot
    shape: Tuple[int, int]
    mloc: int
    nloc: int
    p: int
    rank: int


# a slot for each bucket width: the ladder's, then powers of two past it
_LADDER = _sell._WIDTH_LADDER
_NWIDTHS = len(_LADDER) + 64


def _width_slot(w: int) -> int:
    return _LADDER.index(w) if w in _LADDER else len(_LADDER) + \
        (w - 1).bit_length()


def _slot_width(i: int) -> int:
    return _LADDER[i] if i < len(_LADDER) else 1 << (i - len(_LADDER))


def partition_sell(a, mesh: RowMesh) -> DistSellPlan:
    """Host inspect step: this rank's SELL bucketing, padded to the
    common geometry (a MAX all-reduce of every rank's bucket rows)."""
    a = to_csr(a)
    p, d = mesh.size, mesh.rank
    m, n = a.shape
    mloc = -(-m // p)
    nloc = -(-n // p)
    nnz = a.nnz
    rowptr = np.minimum(_t.to_numpy(a.rowptr).astype(np.int64), nnz)
    lo, hi, sub_rp = local_rowptr(rowptr, d, mloc, m)
    sub = CSR.from_arrays(_t.to_numpy(a.values[lo:hi]), sub_rp,
                          _t.to_numpy(a.colind[lo:hi]), (mloc, n),
                          nnz=hi - lo, device="cpu")
    q = _sell.build_sell_plan(sub)
    own = {int(b.values.shape[1]): b for b in q.buckets}
    rows = [0] * _NWIDTHS
    for w, b in own.items():
        rows[_width_slot(w)] = int(b.values.shape[0])
    rows = mesh.reduce_ints(rows, "max")
    widths = [_slot_width(i) for i, r in enumerate(rows) if r]
    mb_of = {w: rows[_width_slot(w)] for w in widths}

    bucket_values, bucket_cols = [], []
    for w in widths:
        vs = np.zeros((mb_of[w], w), np.float32)
        cs = np.zeros((mb_of[w], w), np.int32)
        b = own.get(w)
        if b is not None:
            vs[: b.values.shape[0]] = _t.to_numpy(b.values)
            cs[: b.values.shape[0]] = _t.to_numpy(b.cols)
        bucket_values.append(vs)
        bucket_cols.append(cs)
    # each local concat slot -> its slot in the common geometry
    total = sum(mb_of.values())
    remap = np.full(sum(int(b.values.shape[0]) for b in own.values()) + 1,
                    total, np.int64)
    off_local = off_common = 0
    for w in widths:
        nb = int(own[w].values.shape[0]) if w in own else 0
        remap[off_local: off_local + nb] = off_common + np.arange(nb)
        off_local += nb
        off_common += mb_of[w]
    qpos = _t.to_numpy(q.pos).astype(np.int64)
    pos = remap[np.minimum(qpos, len(remap) - 1)]

    def put(arr):
        return torch.from_numpy(arr).to(mesh.device)

    return DistSellPlan(
        bucket_values=tuple(put(v) for v in bucket_values),
        bucket_cols=tuple(put(c) for c in bucket_cols),
        pos=put(pos.astype(np.int32)), shape=(m, n), mloc=mloc, nloc=nloc,
        p=p, rank=d)


def dist_sell_spmm(plan: DistSellPlan, b: torch.Tensor, mesh: RowMesh
                   ) -> torch.Tensor:
    """C = A @ B for B this rank's (nloc, k) rows; returns its (mloc, k)
    rows of C: one all-gather of B, then the SELL row gathers."""
    check_mesh_matches(plan.p, mesh, "dist_sell_spmm", rank=plan.rank)
    n = plan.shape[1]
    if b.shape[0] != plan.nloc:
        raise ValueError(
            f"operand leading dim {b.shape[0]} != local n {plan.nloc}")
    k = b.shape[-1]
    bg = mesh.all_gather(b).reshape(-1, k)[:n]
    parts = [_sell.bucket_matmul(v, c, bg).float()
             for v, c in zip(plan.bucket_values, plan.bucket_cols)]
    parts.append(bg.new_zeros((1, k), dtype=torch.float32))
    return torch.cat(parts).index_select(0, plan.pos).to(b.dtype)

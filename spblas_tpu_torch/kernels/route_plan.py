"""ROUTE v1 plan: the chunked gather/permute/reduce layout for power-law
sparsity — the host builder of ``spblas_tpu/kernels/route_plan.py`` for
the port.

The matrix is cut into cells of one 1024-row stripe by one g*1024-column
window (g any integer up to 8).  Each cell's nonzeros pack into (8, 128)
chunks of 1024 slots carrying three layouts joined by two in-register
permutations, all fields precomputed by the builder:

  gather layout   an element sits at tile sublane (its slab sublane & 7);
                  its 7-bit lane l and 3-bit octant pick x2[sb + 8*oct +
                  sublane, l]
  scatter layout  a lane column is a stack of row segments (<= 8
                  elements of one row on consecutive sublanes); per-row
                  sums are in-column segmented prefixes masked by the
                  within-segment distance
  y layout        segment sums route to slots of an (8, 128) output
                  window at y_base; rows split across chunks accumulate

Each permutation is an arbitrary bijection of the 1024 slots realised as
three pulls (sublane, lane, sublane); the native packer finds them by
8-edge-colouring the lane multigraph.  Packed per slot (two int32 tiles
and one f32 value tile, 12 B a slot):

  tile1: -(3) | l(7) | oct(3) | q1(3) | q2(7) | q3(3)     gather + perm 1
  tile3: dist(3) | vA(1) | p1(3) | p2(7) | p3(3)          reduce + perm 2

Rows needing more than one segment in a cell send the extra segment sums
to an aux region past y; a recursively built plan (``aux_plan``, about 8x
smaller) reduces them back into y.  Columns of degree above 96 would
overflow a gather class: each is copied to 8 replica slots past x
(``hot_cols``) and its elements spread over the copies.

The builder is the JAX package's, line for line: numpy plus the port's
own copy of the C++ packer (``native/src/route_pack.cpp``), so every plan
array is bit-equal to the JAX plan's.  Beside them, :func:`fuse_levels`
derives what the one-launch kernel needs and the JAX plan lacks: each
level's ``slab_base`` and ``y_base`` rebased into one buffer
(``fused_sb``, ``fused_yb``) and the root's :class:`V1Layout`.  The plan
is a frozen dataclass of torch tensors on the CSR's device, and there is
no python packer fallback.  :func:`route_spmv_numpy` is the exact
sequential simulator of the kernel (``kernels/route_spmv.py``,
``csrc/route_spmv.cu``), level by level.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.route2 import _host

LANES = 128
SUBS = 8
SLOTS = SUBS * LANES          # 1024 slots per chunk
ROW_WINDOW = SLOTS            # chunk rows live in one 1024-row window

# tile1 fields: lane l, octant, permute-1 pulls q1 (sublane), q2 (lane),
# q3 (sublane); tile3 fields: dist, vA, permute-2 pulls p1, p2, p3
T1_L, T1_OCT, T1_Q1, T1_Q2, T1_Q3 = 3, 10, 13, 16, 23
T3_DIST, T3_VA, T3_P1, T3_P2, T3_P3 = 0, 3, 4, 7, 14

_HOT_COL_THRESHOLD = 96
_MAX_DEPTH = 8


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """ROUTE v1 SpMV plan, its arrays on one device."""

    tile1: torch.Tensor       # (nchunks, 8, 128) int32  gather + permute 1
    tile3: torch.Tensor       # (nchunks, 8, 128) int32  reduce + permute 2
    val: torch.Tensor         # (nchunks, 8, 128) f32    values, gather layout
    slab_base: torch.Tensor   # (nchunks,) int32  x slab offset (pane rows)
    y_base: torch.Tensor      # (nchunks,) int32  y window offset (pane rows)
    val_src: torch.Tensor     # (nchunks, 8, 128) int32  CSR entry (-1: none)
    aux_plan: Optional["RoutePlan"]   # reduces the aux slots into y
    hot_cols: torch.Tensor    # (nhot,) int32 replicated hot columns
    g: int
    shape: Tuple[int, int]
    x_rows: int
    y_rows: int
    aux_len: int
    n_pad: int
    fill: float
    # one-launch buffer (fuse_levels): rebased slab and window bases of
    # this level; the layout on the root only
    fused_sb: Optional[torch.Tensor] = None   # (nchunks,) int32
    fused_yb: Optional[torch.Tensor] = None   # (nchunks,) int32
    layout: Optional["V1Layout"] = None

    @property
    def nchunks(self) -> int:
        return int(self.tile1.shape[0])

    @property
    def aux_rows(self) -> int:
        """Pane rows past ``y_rows`` holding the aux segment sums."""
        return (self.aux_len + LANES - 1) // LANES + SUBS \
            if self.aux_len else 0

    @property
    def pane_rows(self) -> int:
        return self.y_rows + self.aux_rows

    def update_values(self, values: torch.Tensor) -> "RoutePlan":
        """Re-target at new CSR values, same sparsity: one gather.
        Non-entry slots (``val_src`` < 0) keep their baked coefficients
        (padding 0); the aux plan's 1.0 carriers are not entries."""
        if values.numel() == 0:
            values = values.new_zeros(1)
        src = self.val_src.clamp(min=0).long()
        v = torch.where(self.val_src >= 0,
                        values[src].to(self.val.dtype), self.val)
        return dataclasses.replace(self, val=v)


@dataclasses.dataclass(frozen=True)
class V1Layout:
    """The buffer one apply of a v1 plan runs in, in rows of 128 f32:
    the y region ``[0, y_rows)`` every level publishes its y windows
    into, then for each level d >= 1 the region ``[x_offs[d],
    src_rows[d])`` holding its packed x, which level d - 1 fills with its
    aux windows (so it is ``max(aux_rows[d-1], x_rows[d])`` rows), then
    the counters.  Level 0 reads the packed x (``src_rows[0]`` its
    x_rows)."""

    level_ends: Tuple[int, ...]   # running chunk count, level by level
    x_offs: Tuple[int, ...]       # first row of each level's x (0: none)
    src_rows: Tuple[int, ...]     # one past the last row each level reads
    buf_rows: int                 # rows before the counters

    @property
    def nlevels(self) -> int:
        return len(self.level_ends)


def plan_levels(plan: RoutePlan) -> list:
    """A v1 plan and its aux plans, level by level."""
    out = []
    while plan is not None:
        out.append(plan)
        plan = plan.aux_plan
    return out


def fuse_levels(plan: RoutePlan) -> RoutePlan:
    """The plan with every level's rebased ``fused_sb`` / ``fused_yb``
    and the root's :class:`V1Layout`.  A y window (``y_base < y_rows``)
    keeps its row; an aux window moves into the next level's x region;
    a slab of level d >= 1 moves into level d's x region.  Raises where a
    level past the first has hot columns (the level before publishes no
    replicas; aux plans have none: each aux slot is one entry)."""
    levels = plan_levels(plan)
    if len(levels) > _MAX_DEPTH:
        raise ValueError(f"{len(levels)} levels, at most {_MAX_DEPTH}")
    if any(p.hot_cols.numel() for p in levels[1:]):
        raise ValueError("an aux level has hot columns: the one-launch "
                         "apply packs only level 0's")
    y_rows = plan.y_rows
    if any(p.y_rows != y_rows for p in levels):
        raise ValueError("levels disagree on y_rows")
    x_offs, src_rows, off = [0], [plan.x_rows], y_rows
    for prev, p in zip(levels, levels[1:]):
        x_offs.append(off)
        off += max(prev.aux_rows, p.x_rows)
        src_rows.append(off)
    layout = V1Layout(
        level_ends=tuple(itertools.accumulate(p.nchunks for p in levels)),
        x_offs=tuple(x_offs), src_rows=tuple(src_rows), buf_rows=off)
    out = None
    for d in reversed(range(len(levels))):
        p = levels[d]
        yb = p.y_base.long()
        if d + 1 < len(levels):
            yb = torch.where(yb >= y_rows, yb - y_rows + x_offs[d + 1], yb)
        out = dataclasses.replace(
            p, aux_plan=out,
            fused_sb=(p.slab_base.long() + x_offs[d]).to(torch.int32),
            fused_yb=yb.to(torch.int32), layout=layout if d == 0 else None)
    return out


def _pick_g(n: int, max_g: int = 8) -> int:
    """Smallest g whose window covers all of n, else ``max_g``.  Unlike
    the ROUTE2 search, any integer g (the octant select takes any)."""
    for g in range(1, max_g + 1):
        if g * SLOTS >= n:
            return g
    return max_g


def build_route_plan(rowptr, colind, values, shape: Tuple[int, int],
                     nnz: int, g: Optional[int] = None,
                     device=None) -> RoutePlan:
    """Build the ROUTE v1 plan from CSR arrays (numpy or tensors) on the
    host, and place it on ``device`` (default ``cuda``).  O(nnz log nnz)
    host work; the hot loop is the native packer."""
    return fuse_levels(_build_level(rowptr, colind, values, shape, nnz, g,
                                    device, 0))


def _build_level(rowptr, colind, values, shape, nnz, g, device, _depth):
    """One level and, recursively, its aux plan (JAX's builder)."""
    if _depth >= _MAX_DEPTH:
        raise RuntimeError("ROUTE aux recursion did not finish in "
                           f"{_MAX_DEPTH} levels")
    dev = _t.resolve_device(device)
    m, n = shape
    rowptr = _host(rowptr).astype(np.int64)
    colind = _host(colind).astype(np.int64)[:nnz]
    values = _host(values)[:nnz]

    rows = np.repeat(np.arange(m, dtype=np.int64),
                     np.diff(np.minimum(rowptr, nnz)))
    cols = colind
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    ent = order.astype(np.int64)

    # hot columns would overflow the 128-per-sublane-class gather budget:
    # replicate each 8x past x, one copy per class, and spread its
    # elements round-robin over the copies
    n_pad = -(-n // SLOTS) * SLOTS if n else SLOTS
    hot_cols = np.zeros(0, np.int64)
    if nnz:
        coldeg = np.bincount(cols, minlength=n)
        hot_cols = np.flatnonzero(coldeg > _HOT_COL_THRESHOLD)
    if len(hot_cols):
        hid = np.full(n, -1, np.int64)
        hid[hot_cols] = np.arange(len(hot_cols))
        ishot = hid[cols] >= 0
        t = hid[cols[ishot]]
        rr = np.arange(ishot.sum()) % SUBS
        cols = cols.copy()
        cols[ishot] = (n_pad + (t // LANES) * SLOTS + rr * LANES
                       + (t % LANES))
        order = np.lexsort((cols, rows))
        rows, cols, ent = rows[order], cols[order], ent[order]
    n_ext = n_pad + -(-len(hot_cols) // LANES) * SLOTS if len(hot_cols) \
        else n

    if g is None:
        g = _pick_g(n_ext)
    window = g * SLOTS

    # cells: row-major over (stripe, window); (row, col) order inside
    stripe = rows // ROW_WINDOW
    cellc = cols // window
    cell_order = np.lexsort((cols, rows, cellc, stripe))
    rows, cols, ent = rows[cell_order], cols[cell_order], ent[cell_order]

    y_rows = (m + LANES - 1) // LANES + SUBS
    ncells_cols = n_ext // window + 2
    cell_key = stripe[cell_order] * ncells_cols + cellc[cell_order]
    vals_sorted = values[ent] if len(values) else np.zeros(0, np.float32)

    if len(rows):
        bounds = np.flatnonzero(np.diff(cell_key)) + 1
        starts = np.concatenate([[0], bounds])
        packed = _pack_all(rows, cols, vals_sorted, ent, starts, g, window,
                           y_rows)
    else:   # one zero chunk
        zero = np.zeros((1, SUBS, LANES), np.int32)
        packed = (zero, zero, np.zeros((1, SUBS, LANES), np.float32),
                  np.full((1, SUBS, LANES), -1, np.int32),
                  np.zeros(1, np.int32), np.zeros(1, np.int32), 0,
                  np.zeros(0, np.int64), np.zeros(0, np.int64))
    (t1_a, t3_a, vt_a, st_a, sb_a, yb_a, aux_n, aux_slots,
     aux_rows_g) = packed

    x_rows = (n_ext + LANES - 1) // LANES + SUBS * g
    aux_plan = None
    aux_len = int(aux_n)
    if aux_len:
        order2 = np.lexsort((aux_slots, aux_rows_g))
        rows_r, slots_r = aux_rows_g[order2], aux_slots[order2]
        rp2 = np.zeros(m + 1, np.int64)
        np.add.at(rp2[1:], rows_r, 1)
        aux_plan = _build_level(
            np.cumsum(rp2), slots_r, np.ones(len(slots_r), np.float32),
            (m, aux_len), len(slots_r), None, dev, _depth + 1)
    fill = nnz / max(t1_a.shape[0] * SLOTS, 1)

    def put(arr):
        return torch.as_tensor(arr).to(dev)

    return RoutePlan(
        tile1=put(t1_a), tile3=put(t3_a), val=put(vt_a.astype(np.float32)),
        slab_base=put(sb_a), y_base=put(yb_a), val_src=put(st_a),
        aux_plan=aux_plan, hot_cols=put(hot_cols.astype(np.int32)),
        g=g, shape=(m, n), x_rows=x_rows, y_rows=y_rows, aux_len=aux_len,
        n_pad=n_pad, fill=float(fill))


def _pack_all(rows, cols, vals_sorted, ent, starts, g, window, y_rows):
    """Pack every cell into chunks with the native packer.  Returns (t1,
    t3, val, src, sb, yb, aux_n, aux_slots, aux_rows_global)."""
    ne = len(rows)
    ncells = len(starts)
    cell_start = np.concatenate([starts, [ne]]).astype(np.int64)
    lrow = (rows % ROW_WINDOW).astype(np.int32)
    lcol = (cols % window).astype(np.int32)
    cell_sb = ((cols[starts] // window) * (window // LANES)).astype(
        np.int32)
    cell_yb = ((rows[starts] // ROW_WINDOW)
               * (ROW_WINDOW // LANES)).astype(np.int32)

    (nch, elem_chunk, elem_gatpos, t1_a, t3_a, chunk_cell, chunk_auxwin,
     aux_n, aux_slot, aux_lrow, aux_cell) = native.route_pack(
         ne, ncells, cell_start, lrow, lcol)
    vt_a = np.zeros((nch, SUBS, LANES), np.float32)
    st_a = np.full((nch, SUBS, LANES), -1, np.int32)
    gu = elem_gatpos >> 7
    gl = elem_gatpos & 127
    vt_a[elem_chunk, gu, gl] = vals_sorted
    st_a[elem_chunk, gu, gl] = ent
    sb_a = cell_sb[chunk_cell]
    yb_a = np.where(chunk_auxwin < 0, cell_yb[chunk_cell],
                    y_rows + chunk_auxwin * SUBS).astype(np.int32)
    aux_rows_g = (cell_yb[aux_cell].astype(np.int64) * LANES + aux_lrow)
    return (t1_a.copy(), t3_a.copy(), vt_a, st_a, sb_a, yb_a, aux_n,
            aux_slot.astype(np.int64), aux_rows_g)


# ------------------------------------------------------------------ #
# numpy simulator (kernel-semantics oracle, sequential over chunks)
# ------------------------------------------------------------------ #

def pack_x(x: np.ndarray, plan: RoutePlan) -> np.ndarray:
    """x (n,) -> padded (x_rows, 128) pane, hot-column replicas filled."""
    n = plan.shape[1]
    x = np.asarray(x)
    x2 = np.zeros((plan.x_rows, LANES), x.dtype)
    flat = x2.reshape(-1)
    flat[:n] = x
    for t, col in enumerate(_t.to_numpy(plan.hot_cols)):
        base = plan.n_pad + (t // LANES) * SLOTS + (t % LANES)
        flat[base:base + SLOTS:LANES] = x[col]
    return x2


def route_spmv_numpy(plan: RoutePlan, x: np.ndarray) -> np.ndarray:
    """Exact numpy mirror of the kernel semantics, the recursive aux
    reduction included."""
    m, n = plan.shape
    g = plan.g
    x2 = pack_x(x, plan).astype(np.float32)
    y2 = np.zeros((plan.pane_rows, LANES), np.float32)

    t1 = _t.to_numpy(plan.tile1)
    t3 = _t.to_numpy(plan.tile3)
    val = _t.to_numpy(plan.val)
    sb = _t.to_numpy(plan.slab_base)
    yb = _t.to_numpy(plan.y_base)
    jj = np.broadcast_to(np.arange(LANES)[None, :], (SUBS, LANES))
    ii = np.broadcast_to(np.arange(SUBS)[:, None], (SUBS, LANES))

    for k in range(plan.nchunks):
        a = t1[k]
        b = t3[k]
        l = (a >> T1_L) & 127
        oct_ = (a >> T1_OCT) & 7
        q1 = (a >> T1_Q1) & 7
        q2 = (a >> T1_Q2) & 127
        q3 = (a >> T1_Q3) & 7
        slab = x2[sb[k]:sb[k] + SUBS * g]
        vx = np.zeros((SUBS, LANES), np.float32)
        for gg in range(g):
            ug = slab[gg * SUBS:(gg + 1) * SUBS][ii, l]
            vx = np.where(oct_ == gg, ug, vx)
        c = vx * val[k]
        c = c[q1, jj]
        c = c[ii, q2]
        c = c[q3, jj]
        dist = (b >> T3_DIST) & 7
        P = c.copy()
        for d in (1, 2, 4):
            sh = np.roll(P, d, axis=0)
            sh[:d] = 0
            P = P + np.where(dist >= d, sh, 0.0)
        vA = (b >> T3_VA) & 1
        p1 = (b >> T3_P1) & 7
        p2 = (b >> T3_P2) & 127
        p3 = (b >> T3_P3) & 7
        RS = P
        RS = RS[p1, jj]
        RS = RS[ii, p2]
        RS = RS[p3, jj]
        y2[yb[k]:yb[k] + SUBS] += RS * vA
    y = y2.reshape(-1)[:m]
    if plan.aux_plan is not None:
        aux = y2.reshape(-1)[plan.y_rows * LANES:
                             plan.y_rows * LANES + plan.aux_len]
        y = y + route_spmv_numpy(plan.aux_plan, aux)
    return y

"""ROUTE2 plans: the general-sparsity SpMV layout, the fused SpGEMM
numeric (ROUTE2-mul) and the level-scheduled triangular solve — the host
builders of ``spblas_tpu/kernels/route2.py`` for the port.

A plan cuts the matrix into (8, 128) chunks of 1024 slots.  One int32
tile per chunk carries every routing field (bit layout below) and one f32
tile the values in scatter layout, so a chunk is 8 KB of plan stream.
Per chunk the kernel (``csrc/route2_spmv.cu``, wrapper in
``kernels/route2_kernel.py``) computes:

  t1[a,l]  = pane[sb + r2[a,l], l]      slab-row route
  t2[a,jd] = t1[a, lf[a,jd]]            lane gather
  t3[d,jd] = t2[sd2[d,jd], jd]          depth drop
  c        = t3 * val                   multiply
  P        = segmented prefix of c down the 8 depths (dist-masked)
  RS[i,j]  = P[pend[i,j], j]            publish value (any_lane: a second
                                        lane gather by lsrc), masked by vA
  y[yb + 8*subw + i, j] += RS[i,j]      publish (rotated plans un-rotate
                                        by rho first)

Rows with more segments than a cell can publish spill partial sums to an
aux region of the output pane; later flag-1 (aux) chunks gather from the
pane and reduce them, level by level.  Flag-2 (hub) chunks sum their
whole tile to one scalar.

The builder is the JAX package's, line for line where it matters: numpy
plus the port's own copy of the C++ packer (``spblas_tpu_torch/native``),
so every plan array is bit-equal to the JAX plan's.  It differs in three
ways: the plan is a frozen dataclass of torch tensors on the CSR's
device; there is no python packer fallback (the native library builds or
raises); and ``_drain_aux`` records the chunk index at which each aux
level starts, carried as ``Route2Plan.launch_starts``, since CUDA blocks
run in no order and each aux level is its own launch.

The mul half (``Route2MulPlan``, ``build_route2_mul_plan``) packs a
slot-sorted SpGEMM expansion stream (slot, A entry, B entry) into chunks
with two gather chains, one into the A value pane and one into the B
pane (aux chunks: the out pane), and no value tile.  It is built as
JAX builds it, every array bit-equal, with the same three differences (no
python packer: ``_GatherSide``, ``_MulChunk`` and ``_pack_mul_cell`` are
not carried), and it records the chunk index at which each aux level
starts as ``Route2MulPlan.launch_starts``.  The plan also keeps the
stream it was packed from (``Route2MulPlan.expansion``, a
``mul_fill.SlotStream``): on the card the numeric is one launch of the
slot fill ``csrc/mul_fill.cu`` over it (wrapper
``route2_kernel.route2_mul``), and the tiles run in the plain version,
which the CPU tests hold to JAX's kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.mul_fill import SlotStream, build_slot_stream

# the ROUTE geometry (spblas_tpu/kernels/route_plan.py)
LANES = 128
SUBS = 8
SLOTS = 1024
ROW_WINDOW = SLOTS            # 1024-row stripes

# tile bit layout (all fields in one int32):
#   r2   [0:8)   full slab row of the routed column    (at (a, l))
#   lf   [8:15)  lane source for the lane gather       (at (a, jd))
#   sd2  [15:18) sublane source for the depth drop     (at (d, jd))
#   dist [18:21) within-segment distance               (at (d, jd))
#   pend [21:24) depth of published segment end        (at final slot)
#   vA   [24:25) publish mask                          (at final slot)
#   lsrc [25:32) any-lane publish: the accumulation lane this publish
#                reads its segment sum from (at the publish slot); its
#                pend rides the carrier slot (pend, acc_lane)
# B_SUBW (bits 29-31, supercell publish sub-window) and B_SEL (bit 28,
# which of a rotated chunk's two rotations a publish used) share the lsrc
# range in home-lane plans.  Fields reaching bit 31 are read as
# ``(t >> B) & mask``.
B_R2, B_LF, B_SD2, B_DIST, B_PEND, B_VA = 0, 8, 15, 18, 21, 24
B_LSRC = 25
B_SUBW = 29
B_SEL = 28
MAX_G = 32                    # r2 field spans 8g <= 256 slab rows
# chunks of one slab a work item of the slab-staged SpMV kernel
# (csrc/route2_spmv.cu's route2_slab_kernel), and the launch ranges it
# takes: those of SLAB_MIN_CHUNKS chunks or more (smaller ones, the aux
# levels, run a block a chunk)
SLAB_ITEM = 8
SLAB_MIN_CHUNKS = 2048
# the persistent solve (csrc/route2_spmv.cu's route2_solve_kernel) runs
# each stretch of consecutive launch ranges of at most this many chunks on
# one block, levels in order, with no cross-block wait between them
# (0: every range spread over the blocks)
SOLVE_STRETCH_CHUNKS = 1


@dataclasses.dataclass(frozen=True)
class SolveWork:
    """The persistent solve's work list, int32 tensors on the plan's
    device.  An item is one chunk of a launch range wider than
    ``stretch`` chunks, or a whole stretch of consecutive narrower
    ranges; the items of one wide range, or the one item of a stretch,
    form a step, and a step starts only once every item of the step
    before it is done."""

    item_start: torch.Tensor   # (nitems + 1,) first chunk of each item
    item_step: torch.Tensor    # (nitems,) step of each item
    step_need: torch.Tensor    # (nsteps,) items of each step
    stretch: int
    nchunks: int
    width: int                 # the most items of one step

    @property
    def nitems(self) -> int:
        return int(self.item_step.shape[0])

    @property
    def nsteps(self) -> int:
        return int(self.step_need.shape[0])


@dataclasses.dataclass(frozen=True)
class Route2Plan:
    """ROUTE2 SpMV plan, its arrays on one device."""

    tile: torch.Tensor        # (nchunks, 8, 128) int32  all routing fields
    val: torch.Tensor         # (nchunks, 8, 128) f32    values, scatter layout
    slab_base: torch.Tensor   # (nchunks,) int32  source slab offset (pane rows)
    y_base: torch.Tensor      # (nchunks,) int32  publish window (pane rows)
    src_flag: torch.Tensor    # (nchunks,) int32  0: x pane, 1: y pane, 2: hub
    val_src: torch.Tensor     # (nchunks, 8, 128) int32  CSR entry (-1: none)
    ext_cols: torch.Tensor    # (K,) int32 columns copied to the extension
    g: int
    shape: Tuple[int, int]
    nat_slots: int
    x_rows: int
    y_rows: int
    aux_rows: int
    n_aux_chunks: int
    fill: float
    # largest within-segment distance: the prefix runs only the steps
    # it needs
    dist_max: int = 7
    # any-lane publish plans carry B_LSRC carriers (one more lane gather)
    any_lane: bool = False
    # supercell height: one chunk publishes into a row_window_mult*1024-row
    # window through the 3 sub-window bits
    row_window_mult: int = 1
    # hub-split plans carry flag-2 chunks
    has_hub: bool = False
    # per-chunk publish rotations rho0 | rho1 << 10 (rotated plans only)
    rho: Optional[torch.Tensor] = None
    rotated: bool = False
    # first chunk of each launch: (0,) then one start per aux level; no
    # chunk of a launch reads a pane row another chunk of it writes
    launch_starts: Tuple[int, ...] = (0,)
    # the slab-staged kernel's work list of each launch range of
    # SLAB_MIN_CHUNKS chunks or more, None for the others: made on the
    # host when the plan is built (build_slab_work), carried through
    # value updates
    slab_work: Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]], ...] = ()
    # solve plans: the persistent solve's work list (build_solve_work),
    # made on the host with the plan and carried through value updates
    solve_work: Optional[SolveWork] = None

    @property
    def nchunks(self) -> int:
        return int(self.tile.shape[0])

    @property
    def pane_rows(self) -> int:
        return self.y_rows + self.aux_rows

    def launch_ranges(self) -> List[Tuple[int, int]]:
        """[(lo, hi)) chunk range of each launch, in launch order."""
        ends = self.launch_starts[1:] + (self.nchunks,)
        return list(zip(self.launch_starts, ends))

    def update_values(self, values: torch.Tensor) -> "Route2Plan":
        """Re-target at new CSR values, same sparsity: one gather.
        Non-entry slots (``val_src`` < 0) keep their baked coefficients:
        aux reduction carriers multiply partial sums by 1.0, padding by
        0.0."""
        if values.numel() == 0:
            values = values.new_zeros(1)
        src = self.val_src.clamp(min=0).long()
        v = torch.where(self.val_src >= 0,
                        values[src].to(self.val.dtype), self.val)
        return dataclasses.replace(self, val=v)

    def update_solve_values(self, values: torch.Tensor,
                            diag_of_entry=None) -> "Route2Plan":
        """Re-bake a solve plan's coefficients ``-a_ij/d_i`` from new CSR
        values, same sparsity, on the values' device (numeric re-runs
        stay on the substitution kernel).  ``diag_of_entry`` maps entry
        k to its row's diagonal entry (None for an implicit unit
        diagonal).  Non-entry slots keep their baked values (aux
        reduction carriers 1.0, padding 0)."""
        coeff = -values
        if diag_of_entry is not None:
            coeff = coeff / values[diag_of_entry.long()]
        if coeff.numel() == 0:
            coeff = coeff.new_zeros(1)
        src = self.val_src.clamp(min=0).long()
        v = torch.where(self.val_src >= 0,
                        coeff[src].to(self.val.dtype), self.val)
        return dataclasses.replace(self, val=v)


# ------------------------------------------------------------------ #
# builder
# ------------------------------------------------------------------ #

SUPERCELL_TARGET = 8192.0


def _tile_dist_max(tiles: np.ndarray) -> int:
    """max of the 3-bit dist field over a (n, 8, 128) tile array, through
    a reused scratch block instead of two full-size temporaries."""
    n = tiles.shape[0]
    if not tiles.size:
        return 0
    mask = np.int32(7 << B_DIST)
    step = 4096
    buf = np.empty((min(step, n),) + tiles.shape[1:], np.int32)
    dm = 0
    for i in range(0, n, step):
        blk = tiles[i:i + step]
        b = buf[:blk.shape[0]]
        np.bitwise_and(blk, mask, out=b)
        dm = max(dm, int(b.max()))
    return dm >> B_DIST


def pick_row_window_mult(e_cell: float,
                         max_rows: Optional[int] = None) -> int:
    """Supercell height: double W while the expected elements per
    supercell stay under ~8 chunks' worth (quantisation waste <= ~12 %),
    capped at W = 8 (3 sub-window bits) and, when given, at
    ``max_rows`` (the paned builder's panel: the wide publish spans
    1024*W rows)."""
    ww = 1
    while (ww < 8 and e_cell * ww < SUPERCELL_TARGET
           and (max_rows is None or ROW_WINDOW * ww * 2 <= max_rows)):
        ww *= 2
    return ww


def pick_window_g(m: int, n: int, nnz: int, max_g: int = MAX_G) -> int:
    """Window factor targeting ~2k elements per (1024-row x g*1024-col)
    cell: g >= 2*m*n/(nnz*SLOTS), a power of two up to ``max_g``, and no
    wider than n needs.  The solve builder caps it at 16 (its chunks
    gather from the output pane, whose geometry is the level schedule)."""
    want = max(1, (2 * m * n) // (max(nnz, 1) * SLOTS) + 1)
    g = 1
    while g < want and g < max_g:
        g *= 2
    return min(g, _pick_g(max(n, 1), max_g))


def _pick_g(n: int, max_g: int = MAX_G) -> int:
    for g in (1, 2, 4, 8, 16, 32):
        if g > max_g:
            break
        if g * SLOTS >= n:
            return g
    return max_g


def _host(arr) -> np.ndarray:
    return _t.to_numpy(arr) if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)


def build_route2_plan(rowptr, colind, values, shape: Tuple[int, int],
                      nnz: int, any_lane: Optional[bool] = None,
                      row_window_mult: Optional[int] = None,
                      hub_deg: Optional[int] = None,
                      rotate: Optional[bool] = None,
                      device=None) -> Route2Plan:
    """Build the ROUTE2 plan from CSR arrays (numpy or tensors) on the
    host, and place it on ``device`` (default ``cuda``).

    O(nnz log nnz) host work; the hot path is the native per-cell chunk
    packer.  Every option left at None is chosen as the JAX builder
    chooses it: ``any_lane``, ``row_window_mult`` and ``rotate`` from the
    expected elements per cell, and ``hub_deg`` off."""
    dev = _t.resolve_device(device)
    A = _build_route2_arrays(_host(rowptr), _host(colind), _host(values),
                             shape, nnz, any_lane=any_lane,
                             row_window_mult=row_window_mult,
                             hub_deg=hub_deg, rotate=rotate)
    return plan_from_arrays(A, dev)


def plan_from_arrays(A: dict, dev) -> Route2Plan:
    """The Route2Plan of :func:`_build_route2_arrays`' host arrays on
    ``dev``, with its slab work lists (``parallel/route_spmv.py`` pads
    the arrays to a common chunk count first)."""

    def put(arr):
        return torch.as_tensor(arr).to(dev)

    return Route2Plan(
        tile=put(A["tiles"]), val=put(A["vals"]), slab_base=put(A["sb"]),
        y_base=put(A["yb"]), src_flag=put(A["flags"]),
        val_src=put(A["srcs"]), ext_cols=put(A["ext"]),
        g=A["g"], shape=A["shape"], nat_slots=A["nat_slots"],
        x_rows=A["x_rows"], y_rows=A["y_rows"], aux_rows=A["aux_rows"],
        n_aux_chunks=A["n_aux_chunks"], fill=A["fill"],
        dist_max=A["dist_max"], any_lane=A["any_lane"],
        row_window_mult=A["row_window_mult"], has_hub=A["has_hub"],
        rho=put(A["rho"]) if A["rotated"] else None, rotated=A["rotated"],
        launch_starts=A["launch_starts"],
        slab_work=build_slab_work(A["sb"], A["launch_starts"], dev))


def _build_route2_arrays(rowptr, colind, values, shape: Tuple[int, int],
                         nnz: int, any_lane: Optional[bool],
                         row_window_mult: Optional[int],
                         hub_deg: Optional[int],
                         rotate: Optional[bool],
                         g: Optional[int] = None) -> dict:
    """Host phase of :func:`build_route2_plan`: the plan as numpy arrays
    plus static fields.  The paned builder (``kernels/route_paned.py``)
    calls it per row panel with its own window factor ``g``."""
    m, n = shape
    rowptr = np.asarray(rowptr).astype(np.int64)
    colind = np.asarray(colind).astype(np.int64)[:nnz]
    values = np.asarray(values)[:nnz]

    if g is None:
        g = pick_window_g(m, n, nnz)
    window = g * SLOTS

    rows = native.expand_rowptr(m, nnz, np.minimum(rowptr, nnz))
    ent = np.arange(nnz, dtype=np.int64)

    # r2 addresses the full slab row, so no column class rebalancing is
    # needed; the extension region stays in the plan schema, empty
    nat_slots = -(-max(n, 1) // window) * window
    ext_cols = np.zeros(0, np.int64)

    # window-major overflow spill pays only when spilled segments are
    # long enough to amortise their aux reduction: expected per-(row,
    # window) degree >= 3
    seg_len_est = nnz * window / max(m * n, 1)
    spill = seg_len_est >= 3.0
    # supercell height: stacking W stripes per cell multiplies the
    # expected elements per cell by W (home-lane plans only)
    e_cell = seg_len_est * ROW_WINDOW
    if row_window_mult is None:
        row_window_mult = (1 if any_lane is True
                           else pick_row_window_mult(e_cell))
    ww = int(row_window_mult)
    row_window = ROW_WINDOW * ww
    # any-lane publish only on starved cell grids that supercells leave
    if any_lane is None:
        any_lane = ww == 1 and e_cell < 768.0
    if any_lane and ww > 1:
        raise ValueError("supercells use the lsrc bits; any_lane must be "
                         "off when row_window_mult > 1")

    # per-chunk publish rotations: auto only on clearly starved
    # supercell grids (home-lane only: the sel bit shares the lsrc range)
    if rotate is None:
        rotate = ww > 1 and e_cell * ww < 4096.0
    rotate = bool(rotate) and not any_lane

    # hub split: rows of degree >= hub_deg leave the coloured packing and
    # sit at identity lanes in flag-2 chunks (off unless asked for)
    if hub_deg is None:
        hub_deg = 0
    h_stream = None
    if hub_deg:
        deg = np.diff(np.minimum(rowptr[:m + 1], nnz))
        hub_elem = (deg >= hub_deg)[rows]
        if hub_elem.any():
            h_stream = (rows[hub_elem], colind[hub_elem],
                        values[hub_elem], ent[hub_elem])
            rows, colind, values, ent = (rows[~hub_elem],
                                         colind[~hub_elem],
                                         values[~hub_elem],
                                         ent[~hub_elem])

    # one 8W-row pane window per 1024W-row supercell stripe
    y_rows = -(-max(m, 1) // row_window) * (SUBS * ww)
    state = _BuildState(g, y_rows)
    spilled = _pack_stream(rows, colind, values, ent, g, window, state,
                           spill=spill, any_lane=any_lane,
                           row_window=row_window, rotate=rotate)
    if spilled is not None:
        _pack_spill_native(*spilled, g, window, state,
                           row_window=row_window, rotate=rotate)

    # hub chunks (flag 2) come after the flag-0 run, each run padded to
    # whole groups of 8 so per-group flags stay homogeneous
    n_hub_chunks = 0
    if h_stream is not None:
        _pad_to_cb(state, 0)
        n_hub_chunks = _pack_hub_stream(*h_stream, g, window,
                                        row_window, state)
        _pad_to_cb(state, 2)

    # aux levels: reduce spilled segment sums (in the aux region of the
    # output pane) back into y, recursively; each level reads only slots
    # written by earlier chunks
    if state.aux_pending:
        _pad_to_cb(state, 0)
    n_aux_chunks, aux_starts = _drain_aux(state, g, window,
                                          any_lane=any_lane,
                                          row_window=row_window,
                                          rotate=rotate)

    if not len(state.tiles):
        state.append_empty()

    nchunks = len(state.tiles)
    fill = nnz / max(nchunks * SLOTS, 1)
    aux_rows = state.aux_rows()
    if aux_rows and ww > 1:
        # the wide publish spans 8*ww rows from any aux window base
        aux_rows += SUBS * (ww - 1)
    total_slots = nat_slots + len(ext_cols)
    x_rows = max(-(-total_slots // LANES), 1)
    x_rows = -(-x_rows // (SUBS * g)) * (SUBS * g)
    tiles_np = state.tiles.stack()
    dist_max = _tile_dist_max(tiles_np) if nchunks else 0
    return dict(
        tiles=tiles_np, vals=state.vals.stack(),
        srcs=state.srcs.stack(),
        sb=state.sb.stack(),
        yb=state.yb.stack(),
        flags=state.flags.stack(),
        ext=ext_cols.astype(np.int32),
        g=g, shape=(m, n), nat_slots=int(nat_slots), x_rows=x_rows,
        y_rows=y_rows, aux_rows=aux_rows, n_aux_chunks=n_aux_chunks,
        fill=float(fill), dist_max=dist_max, any_lane=bool(any_lane),
        row_window_mult=ww, has_hub=n_hub_chunks > 0,
        rho=state.rho.stack(), rotated=bool(rotate),
        launch_starts=(0,) + tuple(aux_starts))


def _pad_to_cb(state: "_BuildState", flag: int, cb: int = 8) -> None:
    """Pad the chunk list to a whole group of ``cb`` with zero chunks
    carrying ``flag`` (the TPU kernel picks one body per group)."""
    pad = (-len(state.tiles)) % cb
    if not pad:
        return
    state.tiles.append_fill(pad)
    state.vals.append_fill(pad)
    state.srcs.append_fill(pad)
    state.sb.append_fill(pad)
    state.yb.append_fill(pad)
    state.flags.extend_const(flag, pad)
    state.rho.append_fill(pad)


def _pack_hub_stream(rows, cols, vals, ent, g: int, window: int,
                     row_window: int, state: "_BuildState") -> int:
    """Pack hub-row elements into flag-2 chunks (vectorised numpy).

    Per (row, x-window) group, an element with in-window column c sits
    at slot (sublane, c & 127) with r2 = c >> 7: identity lanes, no lane
    gather, no colouring.  A lane class with more than 8 columns
    round-robins across the group's chunks.  Each chunk's publish slot
    receives the full tile sum; the group's partial sums accumulate in
    the output pane.  Returns the chunk count."""
    if len(rows) == 0:
        return 0
    order = np.lexsort((cols, rows))
    rows, cols, vals, ent = (rows[order], cols[order], vals[order],
                             ent[order])
    win = cols // window
    lane = (cols & 127).astype(np.int64)
    grp_change = np.concatenate(
        [[True], (rows[1:] != rows[:-1]) | (win[1:] != win[:-1])])
    grp_id = np.cumsum(grp_change) - 1
    n_groups = int(grp_id[-1]) + 1
    g_first = np.flatnonzero(grp_change)

    # rank within (group, lane) class
    key_order = np.lexsort((lane, grp_id))
    gl = grp_id[key_order] * LANES + lane[key_order]
    gl_change = np.concatenate([[True], gl[1:] != gl[:-1]])
    idx = np.arange(len(gl))
    cls_start = np.maximum.accumulate(np.where(gl_change, idx, 0))
    rank_sorted = idx - cls_start
    rank = np.empty(len(gl), np.int64)
    rank[key_order] = rank_sorted

    # chunks per group = ceil(max class size / 8)
    maxc = np.zeros(n_groups, np.int64)
    np.maximum.at(maxc, grp_id[key_order], rank_sorted + 1)
    nch_g = -(-maxc // SUBS)
    chunk_base = np.concatenate([[0], np.cumsum(nch_g)])
    total = int(chunk_base[-1])

    chunk = chunk_base[grp_id] + rank % nch_g[grp_id]
    sub = rank // nch_g[grp_id]

    tiles = np.zeros((total, SUBS, LANES), np.int32)
    vt = np.zeros((total, SUBS, LANES), np.float32)
    st = np.full((total, SUBS, LANES), -1, np.int32)
    tiles[chunk, sub, lane] = ((cols % window) >> 7).astype(np.int32)
    vt[chunk, sub, lane] = vals
    st[chunk, sub, lane] = np.where(ent >= 0, ent, -1).astype(np.int32)

    g_row = rows[g_first]
    g_win = win[g_first]
    lr = g_row % row_window
    pos = lr % SLOTS
    pub = ((1 << B_VA) | ((lr // SLOTS) << B_SUBW)).astype(np.int64)
    chunk_grp = np.repeat(np.arange(n_groups), nch_g)
    tiles[np.arange(total), (pos >> 7)[chunk_grp],
          (pos & 127)[chunk_grp]] |= pub[chunk_grp].astype(np.int32)

    sb = (g_win * (window // LANES)).astype(np.int32)
    yb = ((g_row // row_window) * (row_window // LANES)).astype(np.int32)
    state.tiles.extend(tiles)
    state.vals.extend(vt)
    state.srcs.extend(st)
    state.sb.extend(sb[chunk_grp])
    state.yb.extend(yb[chunk_grp])
    state.flags.extend_const(2, total)
    state.rho.extend_const(0, total)
    return total


def _drain_aux(state: "_BuildState", g: int, window: int,
               any_lane: bool = True,
               row_window: int = ROW_WINDOW,
               rotate: bool = False) -> Tuple[int, List[int]]:
    """Pack the pending aux partial sums into reduction chunks (levels
    recurse until dry, at most 8).  Returns the number of chunks appended
    and the chunk index at which each level starts."""
    n_aux_chunks = 0
    starts = []
    level = 0
    while state.aux_pending and level < 8:
        level += 1
        a_slots, a_rows = _aux_pending_arrays(state)
        first = len(state.tiles)
        starts.append(first)
        # aux "columns" are absolute output-pane slot positions
        _pack_stream(a_rows, a_slots,
                     np.ones(len(a_slots), np.float32),
                     np.full(len(a_slots), -1, np.int64),
                     g, window, state, src_flag=1,
                     any_lane=any_lane, row_window=row_window,
                     rotate=rotate)
        n_aux_chunks += len(state.tiles) - first
    if state.aux_pending:
        raise RuntimeError("aux reduction did not finish in 8 levels")
    return n_aux_chunks, starts


def _gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]``, threaded natively for the dtypes the library takes."""
    out = native.gather(idx, src)
    return out if out is not None else src[idx]


def _aux_pending_arrays(state: "_BuildState"):
    """Drain ``state.aux_pending``, a list of (slot_array, row_array)
    pairs, into (slots, rows) int64 arrays."""
    aux = state.aux_pending
    state.aux_pending = []
    slots = np.concatenate([np.asarray(s, np.int64) for s, _ in aux])
    rows = np.concatenate([np.asarray(r, np.int64) for _, r in aux])
    return slots, rows


class _RunList:
    """Per-chunk plan arrays accumulated as runs (one ndarray block per
    packer call), concatenated once at the end."""

    def __init__(self, item_shape, dtype, fill=0):
        self._shape = tuple(item_shape)
        self._dtype = dtype
        self._fill = fill
        self._runs: List[np.ndarray] = []
        self._n = 0

    def __len__(self):
        return self._n

    def append_fill(self, count: int = 1):
        """``count`` items of the fill value (zero tiles / -1 srcs)."""
        if count <= 0:
            return
        a = np.full((count,) + self._shape, self._fill, self._dtype)
        self._runs.append(a)
        self._n += count

    def extend(self, arr):
        """A whole run ``(k, *item_shape)`` (kept by reference)."""
        a = np.asarray(arr, self._dtype)
        if a.shape[1:] != self._shape:
            raise ValueError(f"run shape {a.shape} != {self._shape}")
        self._runs.append(a)
        self._n += a.shape[0]

    def extend_const(self, value, count: int):
        if count <= 0:
            return
        self._runs.append(np.full((count,) + self._shape, value,
                                  self._dtype))
        self._n += count

    def stack(self) -> np.ndarray:
        if not self._runs:
            return np.zeros((0,) + self._shape, self._dtype)
        if len(self._runs) == 1:
            return self._runs[0]
        out = np.concatenate(self._runs)
        self._runs = [out]
        return out


class _BuildState:
    def __init__(self, g: int, y_rows: int):
        self.g = g
        self.y_rows = y_rows          # aux region starts here (pane rows)
        self.tiles = _RunList((SUBS, LANES), np.int32)
        self.vals = _RunList((SUBS, LANES), np.float32)
        self.srcs = _RunList((SUBS, LANES), np.int32, fill=-1)
        self.sb = _RunList((), np.int32)
        self.yb = _RunList((), np.int32)
        self.flags = _RunList((), np.int32)
        self.rho = _RunList((), np.int32)   # rotate mode (0 otherwise)
        self.n_aux_windows = 0        # aux windows of 1024 slots, closed
        self.aux_base = 0             # pane row where aux slots start
        self.aux_pending: list = []   # (abs slot array, row array) pairs
        self.chunk_levels: list = []  # solve: per packer call, chunk levels

    def aux_rows(self) -> int:
        # slack of one full slab (8g rows) so flag-1 chunks can read an
        # aligned slab window past the last aux slot
        return (self.n_aux_windows * SUBS + SUBS * self.g
                if self.n_aux_windows else 0)

    def open_aux_windows(self, n_windows: int) -> None:
        """Mark the native call's aux windows as closed (levels never
        reopen earlier windows)."""
        if self.n_aux_windows == 0 and n_windows:
            self.aux_base = self.y_rows
        self.n_aux_windows = max(self.n_aux_windows, n_windows)

    def append_empty(self):
        self.tiles.append_fill(1)
        self.vals.append_fill(1)
        self.srcs.append_fill(1)
        self.sb.append_fill(1)
        self.yb.append_fill(1)
        self.flags.append_fill(1)
        self.rho.append_fill(1)


def _pack_stream(rows, cols, vals, ent, g, window, state: _BuildState,
                 src_flag: int = 0, spill: bool = False,
                 any_lane: bool = True, row_window: int = ROW_WINDOW,
                 rotate: bool = False, cell_level=None):
    """Sort a (row, col) element stream into cells and pack each cell.

    Targets are the element rows (direct y accumulation).  With
    ``spill=True`` each cell's Poisson-tail overflow comes back as
    (rows, cols, vals, ent) subarrays for window-major repacking.  With
    ``cell_level`` (one dependency level per element, the solve builder)
    the level is the most significant part of the cell key, so chunks
    come out level by level, and each chunk's level is appended to
    ``state.chunk_levels``."""
    if len(rows) == 0:
        return None
    # packed single-key argsort ordering by (cell, local row, local col);
    # local coordinates and cell bases come back from the sorted key's
    # bit fields
    lrow_bits = (row_window - 1).bit_length()
    w_bits = (window - 1).bit_length()
    nstripe = (int(rows.max()) >> lrow_bits) + 1
    ncellc = (int(cols.max()) >> w_bits) + 1
    lvl_mult = nstripe * ncellc
    max_cell = lvl_mult
    if cell_level is not None:
        max_cell = lvl_mult * (int(cell_level.max()) + 1)
    if max_cell << (15 + lrow_bits) < (1 << 62):
        key = native.route2_keys(rows, cols, lrow_bits, w_bits, ncellc,
                                 lvl=cell_level, lvl_mult=lvl_mult)
        srt = native.argsort_i64(key)
        if srt is None:
            order = np.argsort(key, kind="stable")
            key_s = key[order]
        else:
            order, key_s = srt
        lrow_s = ((key_s >> 15) & (row_window - 1)).astype(np.int32)
        lcol_s = (key_s & (window - 1)).astype(np.int32)
        cell_key = key_s >> (15 + lrow_bits)
    else:  # astronomically many cells: sort by a lexsort instead
        cell_id = (rows // row_window) * ncellc + cols // window
        if cell_level is not None:
            cell_id = cell_id + cell_level * lvl_mult
        order = np.lexsort((cols, rows, cell_id))
        cell_key = cell_id[order]
        lrow_s = (rows[order] % row_window).astype(np.int32)
        lcol_s = (cols[order] % window).astype(np.int32)
    vals_s, ent_s = _gather(vals, order), _gather(ent, order)
    bounds = np.flatnonzero(np.diff(cell_key)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(lrow_s)]])
    cell_ids = cell_key[starts]
    cell_sb = ((cell_ids % ncellc)
               * (window // LANES)).astype(np.int32)
    cell_yb = (((cell_ids // ncellc) % nstripe)
               * (row_window // LANES)).astype(np.int32)
    spill_idx = _pack_cells_native(lrow_s, lcol_s, vals_s, ent_s, starts,
                                   ends, cell_sb, cell_yb, g, window,
                                   state, src_flag, spill=spill,
                                   any_lane=any_lane,
                                   row_window=row_window, rotate=rotate,
                                   cell_level=(None if cell_level is None
                                               else cell_ids // lvl_mult))
    if spill and len(spill_idx):
        ck = cell_key[spill_idx]
        r_sp = (((ck // ncellc) % nstripe) * row_window
                + lrow_s[spill_idx]).astype(np.int64)
        c_sp = ((ck % ncellc) * window
                + lcol_s[spill_idx]).astype(np.int64)
        return (r_sp, c_sp, vals_s[spill_idx], ent_s[spill_idx])
    return None


def _pack_cells_native(lrow, lcol, vals, ent, starts, ends, cell_sb,
                       cell_yb, g, window, state: _BuildState,
                       src_flag: int, spill: bool = False,
                       any_lane: bool = True,
                       row_window: int = ROW_WINDOW,
                       rotate: bool = False, cell_level=None):
    """Native cell packer over the cell-sorted stream (``lrow``/``lcol``
    window-local int32 coordinates, ``cell_sb``/``cell_yb`` the per-cell
    slab and pane bases, ``cell_level`` the per-cell dependency level of
    a solve); returns the spilled stream indices (possibly empty)."""
    ne = len(lrow)
    ncells = len(starts)
    cell_start = np.concatenate([starts, [ne]]).astype(np.int64)
    (nch, tiles, chunk_cell, chunk_auxwin, chunk_group, elem_group,
     elem_scat, n_windows, aux_slot, aux_lrow, aux_cell,
     spill_idx, chunk_rho) = native.route2_pack(
         ne, ncells, cell_start, lrow, lcol,
         aux_windows_in=state.n_aux_windows, spill=spill,
         any_lane=any_lane, row_window=row_window, rotate=rotate)
    # group val/src tiles (chunk copies share their group's values);
    # spilled elements were never committed and are skipped
    ngroup = int(chunk_group.max()) + 1 if nch else 0
    vt, st = native.fill_group_tiles(ngroup, elem_group, elem_scat,
                                     vals, ent, spill_idx=spill_idx)
    state.open_aux_windows(n_windows)
    yb = np.where(chunk_auxwin < 0, cell_yb[chunk_cell],
                  state.aux_base + chunk_auxwin * SUBS).astype(np.int32)
    state.tiles.extend(tiles)
    state.vals.extend(_gather(vt, chunk_group))
    state.srcs.extend(_gather(st, chunk_group))
    state.sb.extend(cell_sb[chunk_cell])
    state.yb.extend(yb)
    state.flags.extend_const(src_flag, nch)
    state.rho.extend(chunk_rho)
    if cell_level is not None:
        state.chunk_levels.append(cell_level[chunk_cell])
    if len(aux_slot):
        state.aux_pending.append(
            (state.aux_base * LANES + aux_slot.astype(np.int64),
             cell_yb[aux_cell].astype(np.int64) * LANES + aux_lrow))
    return spill_idx


def _pack_spill_native(rows, cols, vals, ent, g, window,
                       state: _BuildState,
                       row_window: int = ROW_WINDOW,
                       rotate: bool = False) -> None:
    """Window-major repack of the per-cell Poisson-tail overflow: cells
    span all stripes of one x window, every segment publishes to an aux
    slot (spill_only), and the pending targets carry the global row."""
    # packed key (window-major): (wkey << (15 + r_bits)) | (row << 15)
    # | lcol, the order of lexsort((cols, rows, cols // window))
    w_bits = (window - 1).bit_length()
    r_bits = max(int(rows.max()).bit_length(), 1) if len(rows) else 1
    ncellw = (int(cols.max()) >> w_bits) + 1 if len(cols) else 1
    srt = None
    if (ncellw << (15 + r_bits)) < (1 << 62):
        srt = native.argsort_i64(
            native.route2_keys(rows, cols, r_bits, w_bits, ncellw))
    if srt is not None:
        order, key_s = srt
        rows = ((key_s >> 15) & (((np.int64(1)) << r_bits) - 1))
        lcol = (key_s & (window - 1)).astype(np.int32)
        wkey = key_s >> (15 + r_bits)
    else:
        order = np.lexsort((cols, rows, cols // window))
        rows, cols = rows[order], cols[order]
        lcol = (cols % window).astype(np.int32)
        wkey = cols // window
    vals, ent = _gather(vals, order), _gather(ent, order)
    bounds = np.flatnonzero(np.diff(wkey)) + 1
    starts = np.concatenate([[0], bounds])
    ne = len(rows)
    cell_start = np.concatenate([starts, [ne]]).astype(np.int64)
    (nch, tiles, chunk_cell, chunk_auxwin, chunk_group, elem_group,
     elem_scat, n_windows, aux_slot, aux_lrow, aux_cell, _,
     _) = native.route2_pack(
         ne, len(starts), cell_start,
         rows.astype(np.int32),                 # global rows
         lcol, aux_windows_in=state.n_aux_windows, spill_only=True,
         # spill chunks publish aux-only; any_lane off keeps the lsrc
         # range clear of the subw/sel fields
         any_lane=False, row_window=row_window, rotate=rotate)
    cell_sb = (wkey[starts] * (window // LANES)).astype(np.int32)
    ngroup = int(chunk_group.max()) + 1 if nch else 0
    vt, st = native.fill_group_tiles(ngroup, elem_group, elem_scat,
                                     vals, ent)
    state.open_aux_windows(n_windows)
    # spill chunks publish only to aux windows
    yb = (state.aux_base + chunk_auxwin * SUBS).astype(np.int32)
    state.tiles.extend(tiles)
    state.vals.extend(_gather(vt, chunk_group))
    state.srcs.extend(_gather(st, chunk_group))
    state.sb.extend(cell_sb[chunk_cell])
    state.yb.extend(yb)
    state.flags.extend_const(0, nch)           # they read the x pane
    state.rho.extend_const(0, nch)
    if len(aux_slot):
        state.aux_pending.append(
            (state.aux_base * LANES + aux_slot.astype(np.int64),
             aux_lrow.astype(np.int64)))       # target = global row


# ------------------------------------------------------------------ #
# the one-launch-per-level triangular solve plan
# ------------------------------------------------------------------ #

# (row, x-window) pairs with more entries than this are hub segments, the
# only source of aux spills (HUB_T in native/src/route2_pack.cpp)
_HUB_T = 16


def build_route2_solve_plan(rowptr, colind, values, shape, nnz: int,
                            levels, diag_pos, unit_diag: bool,
                            lower: bool, any_lane: bool = False,
                            device=None) -> Route2Plan:
    """Level-scheduled triangular solve plan, placed on ``device``
    (default ``cuda``).

    Solving (aA) x = b row by row gives x_i = b_i/(a d_i) - sum_j
    (a_ij/d_i) x_j, so the solve is the accumulation y <- y0 + sum
    (-a_ij/d_i) y[j] with y0 = b/(a d): a ROUTE2 plan whose chunks all
    gather from the output pane (flag 1) and are packed in dependency
    level order.  Values are baked (coefficients -a_ij/d_i);
    :meth:`Route2Plan.update_solve_values` re-bakes them.

    The arrays are the JAX builder's, bit for bit: consecutive non-hub
    levels pack in one native call with the level folded into the cell
    key (the packer flushes at every cell boundary, so a chunk holds one
    level), and a level with hub rows packs alone, its aux reductions
    right after it.  The port also records where each level's chunks and
    each aux level start, as ``launch_starts``: the TPU runs the chunks
    in grid order, CUDA runs one launch per range."""
    dev = _t.resolve_device(device)
    A = _build_route2_solve_arrays(_host(rowptr), _host(colind),
                                   _host(values), shape, nnz,
                                   np.asarray(levels),
                                   np.asarray(diag_pos), unit_diag, lower,
                                   any_lane)

    def put(arr):
        return torch.as_tensor(arr).to(dev)

    return Route2Plan(
        tile=put(A["tiles"]), val=put(A["vals"]), slab_base=put(A["sb"]),
        y_base=put(A["yb"]), src_flag=put(A["flags"]),
        val_src=put(A["srcs"]), ext_cols=put(np.zeros(0, np.int32)),
        g=A["g"], shape=A["shape"], nat_slots=A["x_rows"] * LANES,
        x_rows=A["x_rows"], y_rows=A["y_rows"], aux_rows=A["aux_rows"],
        n_aux_chunks=A["n_aux_chunks"], fill=A["fill"],
        dist_max=A["dist_max"], any_lane=bool(any_lane),
        launch_starts=A["launch_starts"],
        slab_work=build_slab_work(A["sb"], A["launch_starts"], dev),
        solve_work=build_solve_work(A["launch_starts"], len(A["sb"]), dev))


def build_solve_work(launch_starts: Tuple[int, ...], nchunks: int, device,
                     stretch: Optional[int] = None) -> SolveWork:
    """The :class:`SolveWork` of a solve plan's launch ranges: a range of
    at most ``stretch`` (default ``SOLVE_STRETCH_CHUNKS``) chunks joins
    the stretch of narrow ranges before it, or starts one; a wider range
    is a step of one item a chunk."""
    stretch = SOLVE_STRETCH_CHUNKS if stretch is None else int(stretch)
    ends = tuple(launch_starts[1:]) + (int(nchunks),)
    starts, steps, need = [], [], []
    in_stretch = False
    for lo, hi in zip(launch_starts, ends):
        if hi <= lo:
            continue
        if hi - lo <= stretch:
            if not in_stretch:            # the stretch's one item
                starts.append(np.array([lo]))
                steps.append(np.array([len(need)]))
                need.append(1)
                in_stretch = True
            continue
        in_stretch = False
        starts.append(np.arange(lo, hi))
        steps.append(np.full(hi - lo, len(need)))
        need.append(hi - lo)

    def put(parts):
        arr = np.concatenate(parts) if parts else np.zeros(0)
        return torch.from_numpy(arr.astype(np.int32)).to(device)

    return SolveWork(item_start=put(starts + [np.array([nchunks])]),
                     item_step=put(steps), step_need=put([np.array(need)]),
                     stretch=stretch, nchunks=int(nchunks),
                     width=max(need, default=0))


def _build_route2_solve_arrays(rowptr, colind, values, shape, nnz: int,
                               levels, diag_pos, unit_diag: bool,
                               lower: bool, any_lane: bool) -> dict:
    """Host phase of :func:`build_route2_solve_plan`."""
    m = int(shape[0])
    rowptr = np.asarray(rowptr).astype(np.int64)
    colind = np.asarray(colind).astype(np.int64)[:nnz]
    vals_h = np.asarray(values)[:nnz].astype(np.float64)
    levels = np.asarray(levels).astype(np.int64)
    lo = np.minimum(rowptr[:-1], nnz)
    hi = np.minimum(rowptr[1:], nnz)
    rows = np.repeat(np.arange(m, dtype=np.int64), hi - lo)
    ent = np.arange(nnz, dtype=np.int64)
    off = (colind < rows) if lower else (colind > rows)
    d = np.ones(m, np.float64)
    if not unit_diag:
        d = vals_h[np.asarray(diag_pos).astype(np.int64)]
    coeff = -(vals_h / d[rows])

    g = pick_window_g(m, m, nnz, max_g=16)
    window = g * SLOTS

    y_rows = -(-max(m, 1) // ROW_WINDOW) * SUBS
    state = _BuildState(g, y_rows)
    starts = []

    e_rows = rows[off]
    e_cols = colind[off]
    e_coeff = coeff[off].astype(np.float32)
    e_ent = ent[off]
    e_lv = levels[e_rows] if len(e_rows) else np.zeros(0, np.int64)
    order = np.argsort(e_lv, kind="stable")
    e_rows, e_cols = e_rows[order], e_cols[order]
    e_coeff, e_ent, e_lv = e_coeff[order], e_ent[order], e_lv[order]
    n_aux_chunks = 0
    if len(e_lv):
        # hub levels: any (row, window) with more than _HUB_T entries
        rw_key = e_rows * ((m // window) + 2) + e_cols // window
        _, rw_inv, rw_cnt = np.unique(rw_key, return_inverse=True,
                                      return_counts=True)
        hub_lv = np.unique(e_lv[rw_cnt[rw_inv] > _HUB_T])
        is_hub_lv = np.isin(e_lv, hub_lv)
        bounds = np.flatnonzero((np.diff(e_lv) != 0)
                                & (is_hub_lv[1:] | is_hub_lv[:-1])) + 1
        b_starts = np.concatenate([[0], bounds])
        b_ends = np.concatenate([bounds, [len(e_lv)]])
        for s0, s1 in zip(b_starts, b_ends):
            first = len(state.tiles)
            _pack_stream(e_rows[s0:s1], e_cols[s0:s1], e_coeff[s0:s1],
                         e_ent[s0:s1], g, window, state, src_flag=1,
                         any_lane=any_lane, cell_level=e_lv[s0:s1])
            lv = state.chunk_levels.pop()
            if (np.diff(lv) < 0).any():
                raise RuntimeError("solve chunks left level order")
            starts += [first + int(i) for i in np.concatenate(
                [[0], np.flatnonzero(np.diff(lv)) + 1])]
            if state.aux_pending and lv[0] != lv[-1]:
                # aux partial sums land after the whole batch: a later
                # level of it would gather an incomplete row
                raise RuntimeError("a multi-level solve batch spilled to "
                                   "the aux region")
            n_aux, aux_starts = _drain_aux(state, g, window,
                                           any_lane=any_lane)
            n_aux_chunks += n_aux
            starts += aux_starts

    if not len(state.tiles):
        state.append_empty()
    nchunks = len(state.tiles)
    aux_rows = state.aux_rows()
    pane_rows = y_rows + aux_rows
    # whole slab windows: a chunk reads 8g pane rows from its slab base
    x_rows = max(pane_rows, SUBS * g)
    x_rows = -(-x_rows // (SUBS * g)) * (SUBS * g)
    tiles_np = state.tiles.stack()
    return dict(
        tiles=tiles_np, vals=state.vals.stack(), srcs=state.srcs.stack(),
        sb=state.sb.stack(), yb=state.yb.stack(),
        flags=state.flags.stack(), g=g, shape=(m, m), x_rows=x_rows,
        y_rows=y_rows, aux_rows=aux_rows, n_aux_chunks=n_aux_chunks,
        fill=float(len(e_rows) / max(nchunks * SLOTS, 1)),
        dist_max=_tile_dist_max(tiles_np),
        launch_starts=tuple(starts) if starts else (0,))


def route2_solve_numpy(plan: Route2Plan, y0: np.ndarray) -> np.ndarray:
    """Numpy oracle of the solve: the SpMV simulator with the output pane
    initialised from y0 and every chunk reading it, sequential over
    chunks (the JAX package's)."""
    m = plan.shape[0]
    y2 = np.zeros((max(plan.pane_rows, plan.x_rows), LANES), np.float32)
    y2.reshape(-1)[:m] = np.asarray(y0, np.float32)
    g = plan.g
    tiles = _t.to_numpy(plan.tile)
    vals = _t.to_numpy(plan.val)
    sbs = _t.to_numpy(plan.slab_base)
    ybs = _t.to_numpy(plan.y_base)
    jj = np.broadcast_to(np.arange(LANES)[None, :], (SUBS, LANES))
    ii = np.broadcast_to(np.arange(SUBS)[:, None], (SUBS, LANES))
    for k in range(plan.nchunks):
        t = tiles[k].astype(np.int64)
        sb = int(sbs[k])
        slab = np.zeros((SUBS * g, LANES), np.float32)
        avail = min(SUBS * g, y2.shape[0] - sb)
        if avail > 0:
            slab[:avail] = y2[sb:sb + avail]
        r2 = (t >> B_R2) & 255
        t1 = slab[np.minimum(r2, SUBS * g - 1), jj]
        t2 = t1[ii, (t >> B_LF) & 127]
        t3 = t2[(t >> B_SD2) & 7, jj]
        c = t3 * vals[k]
        dist = (t >> B_DIST) & 7
        P = c.copy()
        for dd in (1, 2, 4):
            sh = np.roll(P, dd, axis=0)
            sh[:dd] = 0
            P = P + np.where(dist >= dd, sh, 0.0)
        RS = P[(t >> B_PEND) & 7, jj]
        if plan.any_lane:
            RS = RS[ii, (t >> B_LSRC) & 127]
        RS = RS * ((t >> B_VA) & 1)
        yb = int(ybs[k])
        y2[yb:yb + SUBS] += RS
    return y2.reshape(-1)[:m]


# ------------------------------------------------------------------ #
# numpy simulator (kernel-semantics oracle, sequential over chunks)
# ------------------------------------------------------------------ #

def pack_x2(x: np.ndarray, plan: Route2Plan) -> np.ndarray:
    n = plan.shape[1]
    x = np.asarray(x, np.float32)
    x2 = np.zeros((plan.x_rows, LANES), np.float32)
    flat = x2.reshape(-1)
    flat[:n] = x
    ext = _t.to_numpy(plan.ext_cols)
    if len(ext):
        flat[plan.nat_slots:plan.nat_slots + len(ext)] = x[ext]
    return x2


def route2_spmv_numpy(plan: Route2Plan, x: np.ndarray) -> np.ndarray:
    """Exact numpy mirror of the ROUTE2 kernel semantics on an in-order
    grid (aux chunks read the output pane as earlier chunks left it)."""
    m, n = plan.shape
    g = plan.g
    x2 = pack_x2(x, plan)
    y2 = np.zeros((plan.pane_rows, LANES), np.float32)

    tiles = _t.to_numpy(plan.tile)
    vals = _t.to_numpy(plan.val)
    sbs = _t.to_numpy(plan.slab_base)
    ybs = _t.to_numpy(plan.y_base)
    flags = _t.to_numpy(plan.src_flag)
    rhos = _t.to_numpy(plan.rho) if plan.rotated else None
    jj = np.broadcast_to(np.arange(LANES)[None, :], (SUBS, LANES))
    ii = np.broadcast_to(np.arange(SUBS)[:, None], (SUBS, LANES))

    for k in range(plan.nchunks):
        t = tiles[k].astype(np.int64)
        pane = x2 if flags[k] != 1 else y2
        sb = int(sbs[k])
        slab = np.zeros((SUBS * g, LANES), np.float32)
        avail = min(SUBS * g, pane.shape[0] - sb)
        if avail > 0:
            slab[:avail] = pane[sb:sb + avail]
        r2 = (t >> B_R2) & 255
        t1 = slab[np.minimum(r2, SUBS * g - 1), jj]
        vA = (t >> B_VA) & 1
        if flags[k] == 2:
            # hub chunk: identity lanes, full-tile reduce to one scalar
            RS = vA * float((t1 * vals[k]).sum())
        else:
            lf = (t >> B_LF) & 127
            t2 = t1[ii, lf]
            sd2 = (t >> B_SD2) & 7
            t3 = t2[sd2, jj]
            c = t3 * vals[k]
            dist = (t >> B_DIST) & 7
            P = c.copy()
            for d in (1, 2, 4):
                sh = np.roll(P, d, axis=0)
                sh[:d] = 0
                P = P + np.where(dist >= d, sh, 0.0)
            pend = (t >> B_PEND) & 7
            RS = P[pend, jj]
            if plan.any_lane:
                RS = RS[ii, (t >> B_LSRC) & 127]
            RS = RS * vA
        yb = int(ybs[k])
        ww = plan.row_window_mult
        if plan.rotated and flags[k] != 2:
            # sublane un-rotation per rotation class (kernel mirror)
            rho = int(rhos[k])
            r0, r1 = (rho >> 7) & 7, (rho >> 17) & 7
            sel = (t >> B_SEL) & 1
            u0 = np.where(sel == 0, RS, 0.0)[(ii + r0) & 7, jj]
            u1 = np.where(sel == 1, RS, 0.0)[(ii + r1) & 7, jj]
            if ww == 1:
                y2[yb:yb + SUBS] += u0 + u1
            else:
                s0 = (np.where(sel == 0, t, 0)[(ii + r0) & 7, jj]
                      >> B_SUBW) & 7
                s1 = (np.where(sel == 1, t, 0)[(ii + r1) & 7, jj]
                      >> B_SUBW) & 7
                for sw in range(ww):
                    y2[yb + sw * SUBS: yb + (sw + 1) * SUBS] += (
                        np.where(s0 == sw, u0, 0.0)
                        + np.where(s1 == sw, u1, 0.0))
        elif ww == 1:
            y2[yb:yb + SUBS] += RS
        else:
            subw = (t >> B_SUBW) & 7
            for sw in range(ww):
                y2[yb + sw * SUBS: yb + (sw + 1) * SUBS] += \
                    np.where(subw == sw, RS, 0.0)
    return y2.reshape(-1)[:m]


# ------------------------------------------------------------------ #
# ROUTE2-mul: the fused SpGEMM numeric plan (dual gather chains)
# ------------------------------------------------------------------ #
#
# No value tile: values come fresh from the A and B panes every call,
# so a numeric run with new values needs no update step.  tile1 carries
# the B chain and the common fields (r2, lf, sd2, dist, pend, vA at the
# SpMV bit positions); tile2 the A chain:
#   r2_a [0:8) at (aA, la) | lf_a [8:15) at (aA, jd) | sd2_a [15:18) at
#   (d, jd)

B2_R2, B2_LF, B2_SD2 = 0, 8, 15


@dataclasses.dataclass(frozen=True)
class Route2MulPlan:
    """Resident fused SpGEMM numeric plan, its arrays on one device."""

    tile1: torch.Tensor       # (nchunks, 8, 128) int32  B chain + common
    tile2: torch.Tensor       # (nchunks, 8, 128) int32  A chain
    a_base: torch.Tensor      # (nchunks,) int32  A slab offset (pane rows)
    b_base: torch.Tensor      # (nchunks,) int32  B (or out) slab offset
    src_flag: torch.Tensor    # (nchunks,) int32  0: B pane, 1: out pane
    y_base: torch.Tensor      # (nchunks,) int32  out window offset
    g_a: int
    g_b: int
    a_rows: int
    b_rows: int
    y_rows: int
    aux_rows: int
    n_aux_chunks: int
    capacity: int
    fill: float
    dist_max: int = 7
    # first chunk of each launch: (0,) then one start per aux level; no
    # chunk of a launch reads a pane row another chunk of it writes
    launch_starts: Tuple[int, ...] = (0,)
    # the slot-sorted stream the tiles were packed from, which the CUDA
    # numeric reads (kernels/mul_fill.py); None on a plan carried from JAX
    expansion: Optional[SlotStream] = None

    @property
    def nchunks(self) -> int:
        return int(self.tile1.shape[0])

    @property
    def pane_rows(self) -> int:
        return self.y_rows + self.aux_rows

    def launch_ranges(self) -> List[Tuple[int, int]]:
        """[(lo, hi)) chunk range of each launch, in launch order."""
        ends = self.launch_starts[1:] + (self.nchunks,)
        return list(zip(self.launch_starts, ends))


def slab_items(slab_base: np.ndarray, lo: int, hi: int,
               item: int = SLAB_ITEM) -> Tuple[np.ndarray, np.ndarray]:
    """The chunks [lo, hi) grouped by the slab they read: ``order``, the
    chunk indices sorted stably by ``slab_base`` (stream order within a
    slab), and ``starts``, the positions in ``order`` where each work
    item begins, then ``hi - lo``: an item is at most ``item`` chunks of
    one slab.  Both int32."""
    order = lo + np.argsort(slab_base[lo:hi], kind="stable")
    sb = slab_base[order]
    runs = np.flatnonzero(np.r_[True, sb[1:] != sb[:-1]]) if len(sb) else []
    ends = np.r_[runs[1:], len(sb)] if len(sb) else []
    starts = [np.arange(a, b, item) for a, b in zip(runs, ends)]
    starts = np.concatenate(starts + [np.array([len(sb)])])
    return order.astype(np.int32), starts.astype(np.int32)


def build_slab_work(slab_base: np.ndarray, launch_starts: Tuple[int, ...],
                    device, min_chunks: Optional[int] = None
                    ) -> Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]],
                               ...]:
    """``Route2Plan.slab_work`` from the plan's host ``slab_base``:
    :func:`slab_items` of each launch range of ``min_chunks`` (default
    ``SLAB_MIN_CHUNKS``) chunks or more as int32 tensors on ``device``,
    None for the smaller ranges."""
    min_chunks = SLAB_MIN_CHUNKS if min_chunks is None else min_chunks
    sb = np.asarray(slab_base)
    ends = tuple(launch_starts[1:]) + (len(sb),)
    return tuple(
        tuple(torch.from_numpy(a).to(device) for a in slab_items(sb, lo, hi))
        if hi - lo >= min_chunks else None
        for lo, hi in zip(launch_starts, ends))


def mul_pane_g(length: int, max_g: int = MAX_G) -> int:
    """Window factor spanning a value pane of ``length`` entries (the mul
    chains address whole panes; shared with the paned builder so every
    panel's geometry matches)."""
    g = 1
    while g * SLOTS < length and g < max_g:
        g *= 2
    return g


def build_route2_mul_plan(slots, src_a, src_b, a_len: int, b_len: int,
                          capacity: int, device=None) -> Route2MulPlan:
    """Build the fused numeric plan from the slot-sorted (valid-only)
    expansion stream, and place it on ``device`` (default ``cuda``).
    ``a_len``/``b_len`` size the A/B panes (A has the constant-1 slot at
    index a_len - 1, appended by the caller)."""
    dev = _t.resolve_device(device)
    A = _build_route2_mul_arrays(slots, src_a, src_b, a_len, b_len,
                                 capacity)
    expansion = build_slot_stream(slots, src_a, src_b, a_len, b_len, dev)

    def put(arr):
        return torch.as_tensor(arr).to(dev)

    return Route2MulPlan(
        tile1=put(A["t1"]), tile2=put(A["t2"]), a_base=put(A["ab"]),
        b_base=put(A["bb"]), src_flag=put(A["flags"]), y_base=put(A["yb"]),
        g_a=A["g_a"], g_b=A["g_b"], a_rows=A["a_rows"], b_rows=A["b_rows"],
        y_rows=A["y_rows"], aux_rows=A["aux_rows"],
        n_aux_chunks=A["n_aux_chunks"], capacity=capacity, fill=A["fill"],
        dist_max=A["dist_max"], launch_starts=A["launch_starts"],
        expansion=expansion)


def _build_route2_mul_arrays(slots, src_a, src_b, a_len: int, b_len: int,
                             capacity: int, g_a: Optional[int] = None,
                             g_b: Optional[int] = None) -> dict:
    """Host phase of :func:`build_route2_mul_plan`: sort, pack, aux
    drain and flag alignment, as numpy arrays plus static fields and the
    aux levels' ``launch_starts``.  The paned builder
    (``kernels/route_mul_paned.py``) calls it per output-slot panel with
    a common (g_a, g_b)."""
    slots = np.asarray(slots, np.int64)
    src_a = np.asarray(src_a, np.int64)
    src_b = np.asarray(src_b, np.int64)

    # both panes are covered whole (windows grow to span the full A / B
    # value arrays, capped at g = 32)
    if g_a is None:
        g_a = mul_pane_g(a_len)
    if g_b is None:
        g_b = mul_pane_g(b_len)
    win_a = g_a * SLOTS
    win_b = g_b * SLOTS

    y_rows = -(-max(capacity, 1) // ROW_WINDOW) * SUBS
    stripe = slots // ROW_WINDOW
    ka = src_a // win_a
    kb = src_b // win_b
    # packed single-key argsort (stripe, kb, ka, slots)
    n_ka = int(ka.max()) + 2 if len(ka) else 1
    n_kb = int(kb.max()) + 2 if len(kb) else 1
    n_sl = int(slots.max()) + 2 if len(slots) else 1
    key = ((stripe * n_kb + kb) * n_ka + ka)
    srt = native.argsort_i64(key * n_sl + slots)
    order = srt[0] if srt is not None else \
        np.argsort(key * n_sl + slots, kind="stable")
    slots, src_a, src_b = slots[order], src_a[order], src_b[order]
    cell_key = key[order]

    state = _MulBuildState(max(g_a, g_b), y_rows)
    if len(slots):
        bounds = np.flatnonzero(np.diff(cell_key)) + 1
        starts = np.concatenate([[0], bounds])
        _pack_mul_stream(slots, src_a, src_b, starts, win_a, win_b, state,
                         src_flag=0)

    # aux levels: reduction chunks reading the out pane; the A chain
    # reads the constant-1 slot (index a_len - 1).  Each level reads slots
    # only earlier levels wrote, so each starts a launch.
    n_aux_chunks = 0
    level = 0
    level_starts = []
    while state.aux_pending and level < 8:
        level += 1
        aux = state.aux_pending
        state.aux_pending = []
        a_slots = np.concatenate([p[0] for p in aux])
        tgts = np.concatenate([p[1] for p in aux])
        n_as = int(a_slots.max()) + 1 if len(a_slots) else 1
        if len(tgts) and (int(tgts.max()) + 1) * n_as < (1 << 62):
            srt2 = native.argsort_i64(tgts * n_as + a_slots)
            order2 = srt2[0] if srt2 is not None else \
                np.lexsort((a_slots, tgts))
        else:
            order2 = np.lexsort((a_slots, tgts))
        first = state.n
        level_starts.append(first)
        # out-pane slots play the B-column role; windows sized win_b
        key2 = (tgts[order2] // ROW_WINDOW
                * (int(a_slots.max()) // win_b + 2)
                + a_slots[order2] // win_b)
        bounds2 = np.flatnonzero(np.diff(key2)) + 1
        starts2 = np.concatenate([[0], bounds2])
        _pack_mul_stream(tgts[order2],
                         np.full(len(a_slots), a_len - 1, np.int64),
                         a_slots[order2], starts2, win_a, win_b, state,
                         src_flag=1)
        n_aux_chunks += state.n - first
    if state.aux_pending:
        raise RuntimeError("route2-mul: aux levels did not drain in 8")

    if not state.n:
        state.append_empty()

    t1_np = state.t1[0] if len(state.t1) == 1 else np.concatenate(state.t1)
    t2_np = state.t2[0] if len(state.t2) == 1 else np.concatenate(state.t2)
    ab_np = state.ab.stack()
    bb_np = state.bb.stack()
    yb_np = state.yb.stack()
    flags_np = state.flags.stack()

    # align the flag transition to a CB (= 8) chunk-group boundary, as the
    # TPU kernel's grid wants; the zero pad chunks publish nothing
    trans = np.flatnonzero(flags_np == 1)
    if len(trans):
        t0 = int(trans[0])
        pad_n = (-t0) % 8
        if pad_n:
            zblk = np.zeros((pad_n, SUBS, LANES), np.int32)
            t1_np = np.concatenate([t1_np[:t0], zblk, t1_np[t0:]])
            t2_np = np.concatenate([t2_np[:t0], zblk, t2_np[t0:]])
            at = [t0] * pad_n
            ab_np = np.insert(ab_np, at, 0)
            bb_np = np.insert(bb_np, at, 0)
            yb_np = np.insert(yb_np, at, 0)
            flags_np = np.insert(flags_np, at, 0)
            level_starts = [s + pad_n for s in level_starts]

    nchunks = t1_np.shape[0]
    a_rows = -(-max(a_len, 1) // LANES)
    a_rows = -(-a_rows // (SUBS * g_a)) * (SUBS * g_a)
    b_rows = -(-max(b_len, 1) // LANES)
    b_rows = -(-b_rows // (SUBS * g_b)) * (SUBS * g_b)
    dist_max = _tile_dist_max(t1_np) if nchunks else 0
    return dict(
        t1=t1_np, t2=t2_np, ab=ab_np, bb=bb_np, flags=flags_np, yb=yb_np,
        g_a=g_a, g_b=g_b, a_rows=a_rows, b_rows=b_rows, y_rows=y_rows,
        aux_rows=(len(state.aux_windows) * SUBS + SUBS * max(g_a, g_b)
                  if state.aux_windows else 0),
        n_aux_chunks=n_aux_chunks,
        fill=len(slots) / max(nchunks * SLOTS, 1), dist_max=dist_max,
        launch_starts=(0,) + tuple(level_starts))


def _pack_mul_stream(slots, sa, sb, starts, win_a, win_b,
                     state: "_MulBuildState", src_flag: int) -> None:
    """Pack a cell-sorted mul stream with the native packer
    (``native/src/route2_pack.cpp`` spblas_route2_mul_pack)."""
    ne = len(slots)
    cell_start = np.concatenate([starts, [ne]]).astype(np.int64)
    ls = (slots % ROW_WINDOW).astype(np.int32)
    la_ = (sa % win_a).astype(np.int32)
    lb_ = (sb % win_b).astype(np.int32)
    (nch, t1, t2, chunk_cell, chunk_auxwin, n_windows, aux_slot,
     aux_lslot, aux_cell) = native.route2_mul_pack(
        ne, len(starts), cell_start, ls, la_, lb_,
        aux_windows_in=len(state.aux_windows))
    starts = np.asarray(starts, np.int64)
    cell_ab = ((sa[starts] // win_a) * (win_a // LANES)).astype(np.int32)
    cell_bb = ((sb[starts] // win_b) * (win_b // LANES)).astype(np.int32)
    cell_yb = ((slots[starts] // ROW_WINDOW) * SUBS).astype(np.int32)
    if state.aux_windows == [] and n_windows:
        state.aux_base = state.y_rows
    while len(state.aux_windows) < n_windows:
        state.aux_windows.append(np.full(LANES, SUBS, np.int64))
    yb = np.where(chunk_auxwin < 0, cell_yb[chunk_cell],
                  state.aux_base + chunk_auxwin * SUBS).astype(np.int32)
    state.t1.append(np.ascontiguousarray(t1))
    state.t2.append(np.ascontiguousarray(t2))
    state.n += int(nch)
    state.ab.extend(cell_ab[chunk_cell])
    state.bb.extend(cell_bb[chunk_cell])
    state.yb.extend(yb)
    state.flags.extend_const(src_flag, nch)
    if len(aux_slot):
        state.aux_pending.append((
            state.aux_base * LANES + np.asarray(aux_slot, np.int64),
            cell_yb[aux_cell].astype(np.int64) * LANES
            + np.asarray(aux_lslot, np.int64)))


class _MulBuildState:
    """t1/t2 hold blocks of chunks ((k, 8, 128) each, one per packer
    call); ``n`` counts chunks.  aux_pending holds (abs_slots, targets)
    int64 array pairs."""

    def __init__(self, g, y_rows):
        self.g = g
        self.y_rows = y_rows
        self.t1, self.t2 = [], []
        self.n = 0
        self.ab = _RunList((), np.int32)
        self.bb = _RunList((), np.int32)
        self.yb = _RunList((), np.int32)
        self.flags = _RunList((), np.int32)
        self.aux_windows = []
        self.aux_base = 0
        self.aux_pending = []

    def append_empty(self):
        self.t1.append(np.zeros((1, SUBS, LANES), np.int32))
        self.t2.append(np.zeros((1, SUBS, LANES), np.int32))
        self.n += 1
        for runs in (self.ab, self.bb, self.yb, self.flags):
            runs.append_fill(1)


def route2_mul_numpy(plan: Route2MulPlan, a_arr, b_arr) -> np.ndarray:
    """Exact numpy mirror of the mul kernel on an in-order grid (aux
    chunks read the out pane as earlier chunks left it; the prefix's
    wrapped rows are zero)."""
    A = np.zeros((plan.a_rows, LANES), np.float32)
    A.reshape(-1)[: len(a_arr)] = np.asarray(a_arr, np.float32)
    B = np.zeros((plan.b_rows, LANES), np.float32)
    B.reshape(-1)[: len(b_arr)] = np.asarray(b_arr, np.float32)
    O = np.zeros((plan.pane_rows, LANES), np.float32)
    t1s, t2s = _t.to_numpy(plan.tile1), _t.to_numpy(plan.tile2)
    abs_, bbs = _t.to_numpy(plan.a_base), _t.to_numpy(plan.b_base)
    ybs, fls = _t.to_numpy(plan.y_base), _t.to_numpy(plan.src_flag)
    jj = np.broadcast_to(np.arange(LANES)[None, :], (SUBS, LANES))
    ii = np.broadcast_to(np.arange(SUBS)[:, None], (SUBS, LANES))

    def chain(t, slab, g, b_r2, b_lf, b_sd2):
        r2 = (t >> b_r2) & 255
        u = slab[np.minimum(r2, SUBS * g - 1), jj]
        u = u[ii, (t >> b_lf) & 127]
        return u[(t >> b_sd2) & 7, jj]

    def slab_of(pane, base, g):
        s = np.zeros((SUBS * g, LANES), np.float32)
        avail = min(SUBS * g, pane.shape[0] - base)
        if avail > 0:
            s[:avail] = pane[base:base + avail]
        return s

    for k in range(plan.nchunks):
        t1 = t1s[k].astype(np.int64)
        t2 = t2s[k].astype(np.int64)
        pane_b = B if fls[k] == 0 else O
        ta = chain(t2, slab_of(A, int(abs_[k]), plan.g_a), plan.g_a,
                   B2_R2, B2_LF, B2_SD2)
        tb = chain(t1, slab_of(pane_b, int(bbs[k]), plan.g_b), plan.g_b,
                   B_R2, B_LF, B_SD2)
        c = ta * tb
        dist = (t1 >> B_DIST) & 7
        P = c.copy()
        for d in (1, 2, 4):
            sh = np.roll(P, d, axis=0)
            sh[:d] = 0
            P = P + np.where(dist >= d, sh, 0.0)
        RS = P[(t1 >> B_PEND) & 7, jj] * ((t1 >> B_VA) & 1)
        yb = int(ybs[k])
        O[yb:yb + SUBS] += RS
    return O.reshape(-1)[: plan.capacity]

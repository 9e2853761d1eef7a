"""Paned ROUTE2: ROUTE2 SpMV past the TPU's VMEM residency — counterpart
of ``spblas_tpu/kernels/route_paned.py``.

Rows are split into panels, each built by the ROUTE2 builder
(``route2._build_route2_arrays``) on its row slice, so the chunk
geometry, bit layout and chunk body are ROUTE2's.  Inside a panel the
flag-0 chunks are regrouped by x pane (``pane_rows`` rows of 128), each
pane's run padded to whole groups of 8 chunks, and the aux (flag-1)
chunks, which read the panel's own output pane, run at its end after
every feeder.  On the TPU the panes stream through a VMEM double buffer
driven by per-group event streams (``eva``/``evb``/``evw``/``evs``);
the port keeps those streams bit-equal to JAX's, but on Hopper x stays
in device memory and the kernel reads the slab at row ``pane *
pane_rows + sb`` directly.

The builder is the JAX package's, so every JAX field is bit-equal to the
JAX plan's.  Beside them each panel carries host metadata the JAX plan
lacks: ``pane``, the x pane of each chunk, and ``launch_starts``, where
the flag-0 run and each aux level start (the ROUTE2 builder's starts
shifted past the regrouped flag-0 run), since CUDA blocks run in no
order and each aux level is its own launch.

On a CUDA tensor :func:`route_paned_spmv_padded` launches the
hand-written kernel ``csrc/route_paned_spmv.cu`` (which replaces the TPU
kernel ``route_paned.py::_paned_kernel``) once per launch range of a
panel; on a CPU tensor it runs :func:`route_paned_spmv_reference`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spblas_tpu_torch import _build, native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.route2 import (
    LANES, MAX_G, ROW_WINDOW, SLOTS, SUBS, _build_route2_arrays, _host,
    pick_row_window_mult)
from spblas_tpu_torch.kernels.route2_kernel import chunk_reference

# chunks per group of the TPU kernel (one source pane per group)
CB = 8
# the TPU's scalar memory caps one dispatch's chunks; kept for parity
# (ROADMAP Queue 1 item 18): past it the builder halves the panel
_CHUNKS_PER_DISPATCH = 60_000
# default x pane: 4096 rows of 128, a multiple of SUBS * MAX_G so slabs
# never straddle a pane boundary
_PANE_ROWS = 4096
# default panel rows (the TPU's VMEM-resident y panel)
_PANEL_ROWS = 524_288
# chunks per step of the plain version
_REF_BLOCK = 4096


@dataclasses.dataclass(frozen=True)
class PanedPanel:
    """One row panel of a paned plan, its arrays on one device."""

    tile: torch.Tensor        # (nc, 8, 128) int32
    val: torch.Tensor         # (nc, 8, 128) f32
    sb: torch.Tensor          # (nc,) int32  pane-relative slab base (flag 0)
    yb: torch.Tensor          # (nc,) int32  window base in the panel pane
    fl: torch.Tensor          # (nc,) int32  0: read x, 1: the panel pane
    eva: torch.Tensor         # (nc/8,) int32  pane*2+slot to start, or -1
    evb: torch.Tensor         # (nc/8,) int32  second start (group 0)
    evw: torch.Tensor         # (nc/8,) int32  slot to wait on, or -1
    evs: torch.Tensor         # (nc/8,) int32  slot this group reads
    src_pos: torch.Tensor     # (L,) int32  flat val position of each entry
    src_idx: torch.Tensor     # (L,) int32  its global CSR entry
    rho: torch.Tensor         # (nc,) int32  rho0 | rho1 << 10 (0 unrotated)
    pane: torch.Tensor        # (nc,) int32  x pane of each chunk (0: aux)
    rows: int
    out_rows: int
    has_aux: bool
    dist_max: int
    any_lane: bool = False
    rotated: bool = False
    # first chunk of each launch: the flag-0 run, then one per aux level
    launch_starts: Tuple[int, ...] = (0,)

    @property
    def nchunks(self) -> int:
        return int(self.tile.shape[0])

    def launch_ranges(self) -> List[Tuple[int, int]]:
        """[(lo, hi)) chunk range of each launch, in launch order."""
        ends = self.launch_starts[1:] + (self.nchunks,)
        return list(zip(self.launch_starts, ends))


@dataclasses.dataclass(frozen=True)
class RoutePanedPlan:
    panels: Tuple[PanedPanel, ...]
    shape: Tuple[int, int]
    g: int
    pane_rows: int
    x_rows_pad: int
    fill: float
    # supercell height, common to every panel
    row_window_mult: int = 1

    @property
    def nchunks(self) -> int:
        return sum(p.nchunks for p in self.panels)

    def update_values(self, values: torch.Tensor) -> "RoutePanedPlan":
        """Re-target at new CSR values, same sparsity: one gather and
        scatter per panel; aux and padding slots keep their baked
        coefficients."""
        panels = []
        for p in self.panels:
            flat = p.val.reshape(-1).clone()
            flat[p.src_pos.long()] = values[p.src_idx.long()].to(
                torch.float32)
            panels.append(dataclasses.replace(p, val=flat.view(p.val.shape)))
        return dataclasses.replace(self, panels=tuple(panels))


def _paned_g(m: int, n: int, nnz: int) -> int:
    """Window factor: the ~2k-elements-per-cell target of
    ``pick_window_g``, allowed up to MAX_G."""
    want = max(1, (2 * m * n) // (max(nnz, 1) * SLOTS) + 1)
    g = 1
    while g < want and g < MAX_G:
        g *= 2
    return g


def estimate_paned_bytes(m: int, n: int, nnz: int,
                         g: Optional[int] = None) -> int:
    """Plan-stream size estimate (tile + val = 8 KB a chunk): occupied
    cells plus the element mass."""
    if g is None:
        g = _paned_g(m, n, nnz)
    stripes = -(-m // ROW_WINDOW)
    windows = -(-n // (g * SLOTS))
    cells = stripes * windows
    occ = cells * (1.0 - np.exp(-nnz / max(cells, 1)))
    est_chunks = occ + nnz / SLOTS
    return int(est_chunks * SLOTS * 8)


def build_route_paned_plan(rowptr, colind, values, shape: Tuple[int, int],
                           nnz: int, g: Optional[int] = None,
                           panel_rows: int = _PANEL_ROWS,
                           pane_rows: int = _PANE_ROWS,
                           row_window_mult: Optional[int] = None,
                           device=None) -> RoutePanedPlan:
    """Per-panel ROUTE2 builds plus the pane-major regroup, from CSR
    arrays (numpy or tensors), placed on ``device`` (default ``cuda``).
    ``panel_rows`` adapts downward when a panel would exceed the
    per-dispatch chunk budget."""
    dev = _t.resolve_device(device)
    m, n = shape
    rowptr = _host(rowptr).astype(np.int64)
    colind = _host(colind).astype(np.int64)[:nnz]
    values = _host(values)[:nnz]
    if g is None:
        g = _paned_g(m, n, nnz)
    if pane_rows % (SUBS * g):
        raise ValueError(f"pane_rows {pane_rows} must hold whole slabs of "
                         f"{SUBS * g} rows")

    window = g * SLOTS
    e_cell = nnz * window * ROW_WINDOW / max(m * n, 1)
    ww = row_window_mult
    if ww is None:
        ww = pick_row_window_mult(e_cell, max_rows=panel_rows)
    row_window = ROW_WINDOW * ww

    panel_rows = max(row_window, (panel_rows // row_window) * row_window)
    host_panels = []
    x_rows = None
    total_slots = 0
    r0 = 0
    while r0 < m:
        rows_p = min(panel_rows, m - r0)
        sub = _panel_arrays(rowptr, colind, values, r0, rows_p, n, g, ww)
        if (sub["tiles"].shape[0] > _CHUNKS_PER_DISPATCH
                and rows_p > row_window):
            # too many chunks for one dispatch: halve this panel
            panel_rows = max(row_window,
                             (rows_p // 2 // row_window) * row_window)
            continue
        host_panels.append(_regroup_by_pane(sub, pane_rows, rows_p))
        x_rows = sub["x_rows"]
        total_slots += sub["tiles"].shape[0] * SLOTS
        r0 += rows_p

    x_rows_pad = -(-x_rows // pane_rows) * pane_rows

    def put(arr):
        return torch.as_tensor(arr).to(dev)

    panels = tuple(
        PanedPanel(**{k: put(v) for k, v in hp["arrays"].items()},
                   rows=hp["rows"], out_rows=hp["out_rows"],
                   has_aux=hp["has_aux"], dist_max=hp["dist_max"],
                   any_lane=hp["any_lane"], rotated=hp["rotated"],
                   launch_starts=hp["launch_starts"])
        for hp in host_panels)
    return RoutePanedPlan(
        panels=panels, shape=(m, n), g=g, pane_rows=pane_rows,
        x_rows_pad=x_rows_pad, fill=float(nnz) / max(total_slots, 1),
        row_window_mult=ww)


def _panel_arrays(rowptr, colind, values, r0, rows_p, n, g, ww):
    e0 = int(min(rowptr[r0], len(colind)))
    e1 = int(min(rowptr[r0 + rows_p], len(colind)))
    sub_rp = rowptr[r0:r0 + rows_p + 1] - rowptr[r0]
    sub = _build_route2_arrays(sub_rp, colind[e0:e1], values[e0:e1],
                               (rows_p, n), e1 - e0,
                               any_lane=False if ww > 1 else None,
                               row_window_mult=ww, hub_deg=0, rotate=None,
                               g=g)
    sub["e0"] = e0
    return sub


def _regroup_by_pane(sub: dict, pane_rows: int, rows_p: int) -> dict:
    """Sort flag-0 chunks pane-major, pad every (pane, flag) run to CB
    groups, rebase slab offsets pane-relative, and emit the per-group
    event streams.  The final chunk order is one gather index array
    (-1: a zero pad chunk) driving the native tile gather; the values
    refresh streams come from the source chunks' entries mapped through
    the same order."""
    tiles, vals, srcs = sub["tiles"], sub["vals"], sub["srcs"]
    sb, yb, fl = sub["sb"], sub["yb"], sub["flags"]
    rho_in = sub["rho"]
    idx0 = np.flatnonzero(fl == 0)
    idx1 = np.flatnonzero(fl != 0)
    pane = sb[idx0] // pane_rows
    order = np.argsort(pane, kind="stable")
    idx0, pane = idx0[order], pane[order]

    used = np.unique(pane) if len(pane) else np.zeros(0, np.int64)
    slot_of = {int(p): i & 1 for i, p in enumerate(used)}
    next_of = {int(p): (int(used[i + 1]) if i + 1 < len(used) else -1)
               for i, p in enumerate(used)}

    # gather segments: per pane run [chunk indices..., pads], the aux
    # run, a final pad
    seg_idx, seg_sb, seg_yb, seg_pane = [], [], [], []
    eva, evb, evw, evs = [], [], [], []
    bounds = np.flatnonzero(np.diff(pane)) + 1 if len(pane) else []
    starts = np.concatenate([[0], bounds]) if len(pane) else []
    ends = np.concatenate([bounds, [len(pane)]]) if len(pane) else []
    first_pane = True
    ntot = 0
    for s0, s1 in zip(starts, ends):
        p = int(pane[s0])
        slot = slot_of[p]
        first_g = ntot // CB
        run = idx0[s0:s1]
        seg_idx.append(run.astype(np.int32))
        seg_sb.append((sb[run] - p * pane_rows).astype(np.int32))
        seg_yb.append(yb[run].astype(np.int32))
        pad = (-len(run)) % CB
        if pad:
            seg_idx.append(np.full(pad, -1, np.int32))
            seg_sb.append(np.zeros(pad, np.int32))
            seg_yb.append(np.zeros(pad, np.int32))
        seg_pane.append(np.full(len(run) + pad, p, np.int32))
        ntot += len(run) + pad
        while len(eva) < ntot // CB:
            eva.append(-1)
            evb.append(-1)
            evw.append(-1)
            evs.append(slot)
        # events on the first group of this pane's run: wait for this
        # pane and start the next one into the other slot; the very
        # first group also starts this pane
        nxt = next_of[p]
        start_next = (nxt * 2 + slot_of[nxt]) if nxt >= 0 else -1
        if first_pane:
            eva[first_g] = p * 2 + slot
            evb[first_g] = start_next
            first_pane = False
        else:
            eva[first_g] = start_next
            evb[first_g] = -1
        evw[first_g] = slot

    # aux chunks at the end (they read the panel pane, no pane events)
    n_flag0 = ntot
    if len(idx1):
        seg_idx.append(idx1.astype(np.int32))
        seg_sb.append(sb[idx1].astype(np.int32))
        seg_yb.append(yb[idx1].astype(np.int32))
        ntot += len(idx1)
    pad = (-ntot) % CB
    if pad:
        seg_idx.append(np.full(pad, -1, np.int32))
        seg_sb.append(np.zeros(pad, np.int32))
        seg_yb.append(np.zeros(pad, np.int32))
        ntot += pad
    while len(eva) < ntot // CB:
        eva.append(-1)
        evb.append(-1)
        evw.append(-1)
        evs.append(0)

    if ntot == 0:                      # empty panel: one zero group
        seg_idx.append(np.full(CB, -1, np.int32))
        seg_sb.append(np.zeros(CB, np.int32))
        seg_yb.append(np.zeros(CB, np.int32))
        ntot = CB
        eva.append(-1)
        evb.append(-1)
        evw.append(-1)
        evs.append(0)

    gidx = np.concatenate(seg_idx)
    out_sb = np.concatenate(seg_sb)
    out_yb = np.concatenate(seg_yb)
    out_pane = np.zeros(ntot, np.int32)
    if n_flag0:
        out_pane[:n_flag0] = np.concatenate(seg_pane)
    out_fl = np.zeros(ntot, np.int32)
    if len(idx1):
        out_fl[n_flag0:] = 1
    if n_flag0 == 0 and ntot:
        # an all-empty panel's pad group reads the zeroed panel pane
        out_fl[:] = 1
    out_t = native.gather_tiles_fill(gidx, tiles,
                                     np.zeros((SUBS, LANES), np.int32))
    out_v = native.gather_tiles_fill(gidx, vals,
                                     np.zeros((SUBS, LANES), np.float32))

    out_rows = max(sub["y_rows"] + sub["aux_rows"], SUBS * sub["g"])
    out_rows = -(-out_rows // (SUBS * sub["g"])) * (SUBS * sub["g"])
    # values refresh streams: each entry slot's flat position and global
    # CSR entry (panel srcs are panel-local; offset by e0), mapped per
    # source chunk: output chunk i with gidx[i] = c takes c's entries
    nc = tiles.shape[0]
    src_flat = srcs.reshape(nc, SLOTS)
    sp = np.flatnonzero(src_flat.reshape(-1) >= 0)
    sp_ent = src_flat.reshape(-1)[sp]
    sp_off = (sp % SLOTS).astype(np.int64)
    cnt = np.zeros(nc + 1, np.int64)
    np.add.at(cnt, (sp // SLOTS) + 1, 1)
    cstart = np.cumsum(cnt)
    live = gidx >= 0
    out_cnt = np.where(live, cstart[np.maximum(gidx, 0) + 1]
                       - cstart[np.maximum(gidx, 0)], 0)
    total = int(out_cnt.sum())
    out_slot = np.repeat(np.arange(ntot, dtype=np.int64), out_cnt)
    base = np.concatenate([[0], np.cumsum(out_cnt)])[:-1]
    within = np.arange(total, dtype=np.int64) - np.repeat(base, out_cnt)
    src_off = cstart[np.maximum(gidx, 0)][out_slot] + within
    pos = (out_slot * SLOTS + sp_off[src_off]).astype(np.int32)
    idx = (sp_ent[src_off] + sub["e0"]).astype(np.int32)
    out_rho = np.where(gidx >= 0, rho_in[np.maximum(gidx, 0)],
                       0).astype(np.int32)
    # the route2 builder's aux level starts, shifted past the regrouped
    # flag-0 run (its aux chunks are one contiguous tail, kept in order)
    aux_starts = sub["launch_starts"][1:]
    launch_starts = (0,) + tuple(n_flag0 + s - int(idx1[0])
                                 for s in aux_starts)
    return dict(
        arrays=dict(tile=out_t, val=out_v, sb=out_sb, yb=out_yb, fl=out_fl,
                    eva=np.array(eva, np.int32), evb=np.array(evb, np.int32),
                    evw=np.array(evw, np.int32), evs=np.array(evs, np.int32),
                    src_pos=pos, src_idx=idx, rho=out_rho, pane=out_pane),
        rows=rows_p, out_rows=out_rows,
        has_aux=len(idx1) > 0 or n_flag0 == 0,
        dist_max=sub["dist_max"], any_lane=sub["any_lane"],
        rotated=sub["rotated"], launch_starts=launch_starts)


# ------------------------------------------------------------------ #
# executor
# ------------------------------------------------------------------ #

def pack_x2(plan: RoutePanedPlan, x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: the flat (x_rows_pad * 128,) f32 pane,
    x in front, zeros past it."""
    return F.pad(x.float(), (0, plan.x_rows_pad * LANES - plan.shape[1])
                 ).contiguous()


def route_paned_spmv_reference(plan: RoutePanedPlan, panel: PanedPanel,
                               x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one panel: the zeroed (out_rows, 128)
    panel pane, then each launch range in order, in blocks of chunks;
    flag-0 chunks gather from x at row ``pane * pane_rows + sb``, flag-1
    chunks from the panel pane at row ``sb``.  Returns the panel pane."""
    xs = x2.view(-1, LANES)
    out = torch.zeros(panel.out_rows, LANES, dtype=torch.float32,
                      device=x2.device)
    kw = dict(g=plan.g, dist_max=panel.dist_max, any_lane=panel.any_lane,
              ww=plan.row_window_mult, rotated=panel.rotated)
    for lo, hi in panel.launch_ranges():
        for b0 in range(lo, hi, _REF_BLOCK):
            ks = torch.arange(b0, min(b0 + _REF_BLOCK, hi),
                              device=x2.device)
            fl = panel.fl[ks]
            for flag, src in ((0, xs), (1, out)):
                sel = ks[fl == flag]
                if not sel.numel():
                    continue
                sb = panel.sb[sel].long()
                if flag == 0:
                    sb = sb + panel.pane[sel].long() * plan.pane_rows
                chunk_reference(panel.tile[sel], panel.val[sel], sb,
                                panel.yb[sel], panel.fl[sel],
                                panel.rho[sel], src, out, **kw)
    return out


def _check_operands(plan: RoutePanedPlan, panel: PanedPanel,
                    x2: torch.Tensor) -> None:
    ints = (panel.tile, panel.sb, panel.yb, panel.fl, panel.rho, panel.pane)
    arrays = ints + (panel.val,)
    if any(a.device != x2.device for a in arrays):
        raise ValueError(f"plan on {panel.tile.device}, x2 on {x2.device}")
    if any(a.dtype != torch.int32 for a in ints):
        raise TypeError("plan index arrays must be int32")
    if panel.val.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError(f"val and x2 must be float32, got "
                        f"{panel.val.dtype} and {x2.dtype}")
    nc = panel.nchunks
    if panel.tile.shape != (nc, SUBS, LANES) \
            or panel.val.shape != panel.tile.shape \
            or any(a.shape != (nc,) for a in ints[1:]) \
            or x2.shape != (plan.x_rows_pad * LANES,):
        raise ValueError(f"bad shapes: tile {tuple(panel.tile.shape)}, "
                         f"val {tuple(panel.val.shape)}, "
                         f"x2 {tuple(x2.shape)}")
    if not all(a.is_contiguous() for a in arrays + (x2,)):
        raise ValueError("plan arrays and x2 must be contiguous")


# (tile, val, sb, yb, fl, pane, rho, lo, hi, x2, x_rows, pane_rows, out,
#  out_rows, g, dist_max, any_lane, ww, rotated, stream) of
# route_paned_spmv_f32
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) * 2 + (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def route_paned_spmv_padded(plan: RoutePanedPlan, panel: PanedPanel,
                            x2: torch.Tensor) -> torch.Tensor:
    """One panel over the packed x ``x2`` (from :func:`pack_x2`);
    returns its (out_rows, 128) f32 panel pane.  CUDA tensors launch
    ``route_paned_spmv.cu`` once per launch range, on the current
    stream; CPU tensors take :func:`route_paned_spmv_reference`."""
    _check_operands(plan, panel, x2)
    if not _t.on_cuda(x2):
        return route_paned_spmv_reference(plan, panel, x2)
    out = torch.zeros(panel.out_rows, LANES, dtype=torch.float32,
                      device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    fn = _build.function("route_paned_spmv", "route_paned_spmv_f32",
                         _ARGTYPES)
    for lo, hi in panel.launch_ranges():
        if hi <= lo:
            continue
        _build.check(fn(
            panel.tile.data_ptr(), panel.val.data_ptr(),
            panel.sb.data_ptr(), panel.yb.data_ptr(), panel.fl.data_ptr(),
            panel.pane.data_ptr(), panel.rho.data_ptr(), lo, hi,
            x2.data_ptr(), plan.x_rows_pad, plan.pane_rows, out.data_ptr(),
            panel.out_rows, plan.g, panel.dist_max, int(panel.any_lane),
            plan.row_window_mult, int(panel.rotated), stream),
            "route_paned_spmv")
        route_paned_spmv_padded.launches += 1
    return out


route_paned_spmv_padded.launches = 0


def route_paned_spmv(plan: RoutePanedPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through a paned plan, in x's dtype (computed in f32):
    each panel's first ``rows`` slots, concatenated."""
    x2 = pack_x2(plan, x)
    parts = [route_paned_spmv_padded(plan, p, x2).view(-1)[:p.rows]
             for p in plan.panels]
    return torch.cat(parts).to(x.dtype)

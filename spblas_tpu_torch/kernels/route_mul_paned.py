"""Paned ROUTE2-mul: the fused SpGEMM numeric past the resident engine's
envelope — counterpart of ``spblas_tpu/kernels/route_mul_paned.py``.

Output slots are split into panels, each built by the resident builder
(``route2._build_route2_mul_arrays``) on its slot slice with a common
(g_a, g_b), so chunk geometry, bit layout and the chunk body are the
resident engine's.  Inside a panel the flag-0 chunks are regrouped by B
pane (``pane_rows`` rows of 128), each pane's run padded to whole groups
of 8 chunks, and the aux (flag-1) chunks, which read the panel's own out
pane, run at its end after every feeder, in level order.  On the TPU the
B panes stream through a VMEM double buffer driven by per-group event
streams (``eva``/``evb``/``evw``/``evs``); the port keeps those streams
bit-equal to JAX's, and its plain tile walker reads the slab at row
``pane * pane_rows + bb`` of B directly.

The builder is the JAX package's, so every JAX field is bit-equal to the
JAX plan's.  Beside them each panel carries host metadata the JAX plan
lacks: ``pane``, the B pane of each chunk, and ``launch_starts``, where
the flag-0 run and each aux level start, for the plain tile walker
:func:`route2_mul_paned_reference`, which runs them in that order.

On the card the tiles are not read.  The plan also keeps the
slot-sorted expansion stream it was packed from
(``Route2MulPanedPlan.expansion``, a ``mul_fill.SlotStream``), and on
CUDA tensors :func:`route2_mul_paned` is one launch of the slot fill
``csrc/mul_fill.cu`` (which replaces the TPU kernel
``route_mul_paned.py::_paned_mul_kernel``): a gather of A and B and a
segmented sum, one owner a slot.  The TPU routes every product through
the tiles because it has no hardware gather; the 100k A·A plan is 3.3 %
full, 2.4 GB of tiles for 10M products.  On CPU tensors
:func:`route2_mul_paned` walks the tiles.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.mul_fill import (SlotStream,
                                               build_slot_stream, mul_fill,
                                               plan_stream)
from spblas_tpu_torch.kernels.route2 import (LANES, ROW_WINDOW, SLOTS, SUBS,
                                             _build_route2_mul_arrays,
                                             mul_pane_g)
from spblas_tpu_torch.kernels.route2_kernel import (_REF_BLOCK,
                                                    mul_chunk_reference,
                                                    pad_pane)

# chunks per group of the TPU kernel (one B pane per group)
CB = 8
# the TPU's scalar memory caps one dispatch's chunks; kept for parity
# (ROADMAP Queue 1 item 18): past it the builder halves the panel
_CHUNKS_PER_DISPATCH = 45_000
# streamed B pane: 4096 rows of 128, a multiple of SUBS * 32 so B slabs
# never straddle a pane boundary
_PANE_ROWS = 4096
# default output panel: 1M slots (the TPU's VMEM-resident y panel)
_PANEL_SLOTS = 1 << 20


@dataclasses.dataclass(frozen=True)
class MulPanedPanel:
    """One output-slot panel of a paned mul plan, its arrays on one
    device."""

    t1: torch.Tensor          # (nc, 8, 128) int32  B chain + common fields
    t2: torch.Tensor          # (nc, 8, 128) int32  A chain
    ab: torch.Tensor          # (nc,) int32  A slab base (A whole)
    bb: torch.Tensor          # (nc,) int32  pane-relative B slab base
                              #   (flag 0) / out-pane slab base (flag 1)
    yb: torch.Tensor          # (nc,) int32  out window base (panel pane)
    fl: torch.Tensor          # (nc,) int32  0: read B, 1: the panel pane
    eva: torch.Tensor         # (nc/8,) int32  pane*2+slot to start, or -1
    evb: torch.Tensor         # (nc/8,) int32  second start (group 0)
    evw: torch.Tensor         # (nc/8,) int32  slot to wait on, or -1
    evs: torch.Tensor         # (nc/8,) int32  slot this group reads
    pane: torch.Tensor        # (nc,) int32  B pane of each chunk (0: aux)
    slots: int
    out_rows: int
    has_aux: bool
    dist_max: int
    # first chunk of each launch: the flag-0 run, then one per aux level
    launch_starts: Tuple[int, ...] = (0,)

    @property
    def nchunks(self) -> int:
        return int(self.t1.shape[0])

    def launch_ranges(self) -> List[Tuple[int, int]]:
        """[(lo, hi)) chunk range of each launch, in launch order."""
        ends = self.launch_starts[1:] + (self.nchunks,)
        return list(zip(self.launch_starts, ends))


@dataclasses.dataclass(frozen=True)
class Route2MulPanedPlan:
    """Paned fused SpGEMM numeric plan (values gathered fresh from the A
    and B panes every call, as in ``Route2MulPlan``)."""

    panels: Tuple[MulPanedPanel, ...]
    g_a: int
    g_b: int
    a_rows: int
    b_rows_pad: int
    pane_rows: int
    capacity: int
    fill: float
    # the slot-sorted stream the panels were packed from, which the CUDA
    # fill reads (kernels/mul_fill.py); None on a plan carried from JAX
    expansion: Optional[SlotStream] = None

    @property
    def nchunks(self) -> int:
        return sum(p.nchunks for p in self.panels)


def build_route2_mul_paned_plan(slots, src_a, src_b, a_len: int,
                                b_len: int, capacity: int,
                                panel_slots: int = _PANEL_SLOTS,
                                pane_rows: int = _PANE_ROWS,
                                device=None, agree=None) -> Route2MulPanedPlan:
    """Per-panel mul packs plus the B-pane-major regroup, placed on
    ``device`` (default ``cuda``).  ``slots`` must be nondecreasing (the
    expansion stream of ``ops/spgemm`` is slot-sorted); ``panel_slots``
    adapts downward when a panel would exceed the per-dispatch chunk
    budget.

    ``agree``: for the ranks of an SPMD program that each build a plan of
    their own stream in lockstep (``parallel/spgemm``), a function that
    combines a list of host integers over the ranks by their maximum.
    The ranks then halve the panel together, and each panel takes the
    largest rank's chunk count (padded with flag-1 zero groups, which
    publish nothing), pane height and prefix depth, with ``has_aux``
    set.  Without it the plan is this stream's alone."""
    dev = _t.resolve_device(device)
    lockstep = agree is not None
    agree = agree or (lambda values: list(values))
    slots = np.asarray(slots, np.int64)
    src_a = np.asarray(src_a, np.int64)
    src_b = np.asarray(src_b, np.int64)
    g_a = mul_pane_g(a_len)
    g_b = mul_pane_g(b_len)
    if pane_rows % (SUBS * g_b):
        raise ValueError(f"pane_rows {pane_rows} must hold whole B slabs "
                         f"of {SUBS * g_b} rows")

    last_slot = agree([int(slots[-1]) if len(slots) else 0])[0]
    panel_slots = max(ROW_WINDOW, (panel_slots // ROW_WINDOW) * ROW_WINDOW)
    host_panels = []
    total_slots_packed = 0
    s0 = 0
    while s0 <= last_slot:
        cap_p = min(panel_slots, capacity - s0)
        lo = int(np.searchsorted(slots, s0, side="left"))
        hi = int(np.searchsorted(slots, s0 + cap_p, side="left"))
        sub = _build_route2_mul_arrays(
            slots[lo:hi] - s0, src_a[lo:hi], src_b[lo:hi], a_len, b_len,
            cap_p, g_a=g_a, g_b=g_b)
        if agree([int(sub["t1"].shape[0] > _CHUNKS_PER_DISPATCH
                      and cap_p > ROW_WINDOW)])[0]:
            panel_slots = max(ROW_WINDOW,
                              (cap_p // 2 // ROW_WINDOW) * ROW_WINDOW)
            continue
        host_panels.append(_regroup_mul_by_pane(sub, pane_rows, cap_p))
        total_slots_packed += sub["t1"].shape[0] * SLOTS
        s0 += cap_p
    # each panel's chunk count, pane height and prefix depth
    common = agree([v for hp in host_panels for v in (
        hp["arrays"]["t1"].shape[0], hp["out_rows"], hp["dist_max"])])

    a_rows = -(-max(a_len, 1) // LANES)
    a_rows = -(-a_rows // (SUBS * g_a)) * (SUBS * g_a)
    b_rows = -(-max(b_len, 1) // LANES)
    b_rows = -(-b_rows // (SUBS * g_b)) * (SUBS * g_b)
    b_rows_pad = -(-b_rows // pane_rows) * pane_rows

    def put(arr):
        return torch.as_tensor(arr).to(dev)

    panels = tuple(
        MulPanedPanel(**{k: put(v) for k, v in _pad_chunks(
                          hp["arrays"], common[3 * i]).items()},
                      slots=hp["slots"], out_rows=common[3 * i + 1],
                      has_aux=lockstep or hp["has_aux"],
                      dist_max=common[3 * i + 2],
                      launch_starts=hp["launch_starts"])
        for i, hp in enumerate(host_panels))
    return Route2MulPanedPlan(
        panels=panels, g_a=g_a, g_b=g_b, a_rows=a_rows,
        b_rows_pad=b_rows_pad, pane_rows=pane_rows, capacity=capacity,
        fill=len(slots) / max(total_slots_packed, 1),
        expansion=build_slot_stream(slots, src_a, src_b, a_len, b_len,
                                    dev))


def _pad_chunks(arrays: dict, nc: int) -> dict:
    """A panel's arrays with its chunk stream padded to ``nc`` chunks by
    flag-1 zero groups, which publish nothing (no event: -1)."""
    n_own = arrays["t1"].shape[0]
    if nc == n_own:
        return arrays
    out = dict(arrays)
    for key in ("t1", "t2", "ab", "bb", "yb", "fl", "pane"):
        arr = arrays[key]
        pad = np.zeros((nc - n_own,) + arr.shape[1:], arr.dtype)
        if key == "fl":
            pad[:] = 1
        out[key] = np.concatenate([arr, pad])
    for key in ("eva", "evb", "evw", "evs"):
        arr = arrays[key]
        out[key] = np.concatenate([arr, np.full(
            (nc // CB - arr.shape[0],), 0 if key == "evs" else -1,
            arr.dtype)])
    return out


def _regroup_mul_by_pane(sub: dict, pane_rows: int, cap_p: int) -> dict:
    """Sort flag-0 chunks B-pane-major, pad every (pane, flag) run to CB
    groups, rebase B slab offsets pane-relative, and emit the per-group
    event streams, each chunk's B pane and the panel's launch starts."""
    t1, t2 = sub["t1"], sub["t2"]
    ab, bb, yb, fl = sub["ab"], sub["bb"], sub["yb"], sub["flags"]
    idx0 = np.flatnonzero(fl == 0)
    idx1 = np.flatnonzero(fl != 0)
    pane = bb[idx0] // pane_rows
    order = np.argsort(pane, kind="stable")
    idx0, pane = idx0[order], pane[order]

    used = np.unique(pane) if len(pane) else np.zeros(0, np.int64)
    slot_of = {int(p): i & 1 for i, p in enumerate(used)}
    next_of = {int(p): (int(used[i + 1]) if i + 1 < len(used) else -1)
               for i, p in enumerate(used)}

    # one selection index per output chunk position (-1: zero padding),
    # runs padded to whole CB groups
    bounds = np.flatnonzero(np.diff(pane)) + 1 if len(pane) else []
    starts = (np.concatenate([[0], bounds]) if len(pane)
              else np.zeros(0, np.int64)).astype(np.int64)
    ends = (np.concatenate([bounds, [len(pane)]]) if len(pane)
            else np.zeros(0, np.int64)).astype(np.int64)
    cnt = ends - starts
    pad_cnt = -(-cnt // CB) * CB
    off = np.concatenate([[0], np.cumsum(pad_cnt)])
    total0 = int(off[-1])
    n1 = len(idx1)
    total1 = -(-n1 // CB) * CB if n1 else 0
    total = total0 + total1
    sel = np.full(max(total, CB), -1, np.int64)
    for r in range(len(starts)):            # one iteration per pane run
        sel[off[r]: off[r] + cnt[r]] = idx0[starts[r]: ends[r]]
    if n1:
        sel[total0: total0 + n1] = idx1
    total = len(sel)

    good = sel >= 0
    gi = np.maximum(sel, 0)
    out_t1 = np.where(good[:, None, None], t1[gi], 0).astype(np.int32)
    out_t2 = np.where(good[:, None, None], t2[gi], 0).astype(np.int32)
    out_ab = np.where(good, ab[gi], 0).astype(np.int32)
    out_yb = np.where(good, yb[gi], 0).astype(np.int32)
    # flag-0 chunks get pane-relative B slab bases; aux (flag 1) keep
    # their out-pane offsets; padding keeps its run's flag
    bb_adj = bb.astype(np.int64).copy()
    bb_adj[idx0] = bb[idx0] - pane * pane_rows
    out_bb = np.where(good, bb_adj[gi], 0).astype(np.int32)
    out_fl = np.zeros(total, np.int32)
    if n1:
        out_fl[total0:] = 1
        out_fl[np.flatnonzero(good)] = fl[sel[good]]
    # each flag-0 run's pane, its pad chunks included (aux: 0)
    out_pane = np.zeros(total, np.int32)
    for r in range(len(starts)):
        out_pane[off[r]: off[r + 1]] = pane[starts[r]]

    # per-group event streams (TPU metadata, kept bit-equal)
    ng = total // CB
    eva = np.full(ng, -1, np.int32)
    evb = np.full(ng, -1, np.int32)
    evw = np.full(ng, -1, np.int32)
    evs = np.zeros(ng, np.int32)
    first_pane = True
    for r in range(len(starts)):
        p = int(pane[starts[r]])
        slot = slot_of[p]
        g0 = int(off[r]) // CB
        g1 = int(off[r + 1]) // CB
        evs[g0:g1] = slot
        nxt = next_of[p]
        start_next = (nxt * 2 + slot_of[nxt]) if nxt >= 0 else -1
        if first_pane:
            eva[g0] = p * 2 + slot
            evb[g0] = start_next
            first_pane = False
        else:
            eva[g0] = start_next
        evw[g0] = slot

    g_b = sub["g_b"]
    out_rows = max(sub["y_rows"] + sub["aux_rows"], SUBS * g_b)
    out_rows = -(-out_rows // (SUBS * g_b)) * (SUBS * g_b)
    # the resident builder's aux level starts, moved past the regrouped
    # flag-0 run (its aux chunks are one contiguous tail, kept in order)
    launch_starts = (0,) + tuple(total0 + s - int(idx1[0])
                                 for s in sub["launch_starts"][1:])
    return dict(
        arrays=dict(t1=out_t1, t2=out_t2, ab=out_ab, bb=out_bb, yb=out_yb,
                    fl=out_fl, eva=eva, evb=evb, evw=evw, evs=evs,
                    pane=out_pane),
        slots=cap_p, out_rows=out_rows, has_aux=n1 > 0,
        dist_max=sub["dist_max"], launch_starts=launch_starts)


# ------------------------------------------------------------------ #
# executor
# ------------------------------------------------------------------ #

def pack_mul_panes(plan: Route2MulPanedPlan, a_arr: torch.Tensor,
                   b_arr: torch.Tensor):
    """The A and B panes of a paned plan (``a_rows``, ``b_rows_pad``)."""
    return pad_pane(a_arr, plan.a_rows), pad_pane(b_arr, plan.b_rows_pad)


def route2_mul_paned_reference(plan: Route2MulPanedPlan,
                               panel: MulPanedPanel, a2: torch.Tensor,
                               b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one panel: the zeroed (out_rows, 128)
    panel pane, then each launch range in order, in blocks of chunks;
    flag-0 chunks gather B at row ``pane * pane_rows + bb``, flag-1
    chunks the panel pane at row ``bb``.  Returns the panel pane."""
    a_s, b_s = a2.view(-1, LANES), b2.view(-1, LANES)
    out = torch.zeros(panel.out_rows, LANES, dtype=torch.float32,
                      device=a2.device)
    kw = dict(g_a=plan.g_a, g_b=plan.g_b, dist_max=panel.dist_max)
    for lo, hi in panel.launch_ranges():
        for b0 in range(lo, hi, _REF_BLOCK):
            ks = torch.arange(b0, min(b0 + _REF_BLOCK, hi),
                              device=a2.device)
            fl = panel.fl[ks]
            for flag, src in ((0, b_s), (1, out)):
                sel = ks[fl == flag]
                if not sel.numel():
                    continue
                bb = panel.bb[sel].long()
                if flag == 0:
                    bb = bb + panel.pane[sel].long() * plan.pane_rows
                mul_chunk_reference(panel.t1[sel], panel.t2[sel],
                                    panel.ab[sel], bb, panel.yb[sel], a_s,
                                    src, out, **kw)
    return out


def route2_mul_paned(plan: Route2MulPanedPlan, a_arr: torch.Tensor,
                     b_arr: torch.Tensor) -> torch.Tensor:
    """c_values (capacity,) f32 = the slot sums of A_arr[sa] * B_arr[sb].
    On CUDA tensors one launch of the slot fill (:func:`mul_fill`) over
    the plan's expansion stream writes the whole capacity; on CPU
    tensors the plain tile walker runs panel by panel, each panel's
    first ``slots`` slots concatenated and zero-padded to the
    capacity."""
    if _t.on_cuda(a_arr):
        return mul_fill(plan_stream(plan, "build_route2_mul_paned_plan"),
                        a_arr.float().contiguous(),
                        b_arr.float().contiguous(), plan.capacity)
    a2, b2 = pack_mul_panes(plan, a_arr, b_arr)
    parts = [route2_mul_paned_reference(plan, p, a2, b2).view(-1)[:p.slots]
             for p in plan.panels]
    out = torch.cat(parts) if parts else a2.new_zeros(0)
    return F.pad(out, (0, plan.capacity - out.shape[0]))

"""ROUTE v1 SpGEMM numeric plan (the ``route_mul`` engine) — counterpart
of ``spblas_tpu/kernels/route_mul.py``.

The plan runs the SpGEMM expansion stream

    c_values[slot] += A_arr[src_a] * B_arr[src_b]

through (8, 128) chunks of the ROUTE v1 machinery: two gathers, a
three-pull permutation into slot-segment layout, a segmented prefix down
the 8 depths, and a second three-pull permutation into the chunk's
1024-slot out window.  The plan also keeps the slot-sorted stream it was
packed from (``RouteMulPlan.expansion``, a ``mul_fill.SlotStream``):
on the card the numeric is one launch of the slot fill
``csrc/mul_fill.cu`` over it (wrapper ``kernels/route_mul_kernel.py``),
and the tiles run in the plain version, which the CPU tests hold to
JAX's kernel.

Gather roles (both sources are panes of 128-wide rows):
  src_b   elementwise: the element's tile sublane is its B slab
          sublane, lane and octant are free per element.
  src_a   column-constant two-step: each lane column is one (lane,
          octant) of the A slab, and a 3-bit per-element s7_a picks the
          slab sublane.

Packed metadata (three int32 tiles, 12 B a slot; no value tile):

  tile1: l_b(7) | oct_b(3) | q1(3) | q2(7) | q3(3)
  tile2: l_a(7) | oct_a(3) | s7_a(3)
  tile3: dist(3) | vA(1) | p1(3) | p2(7) | p3(3)

The builder is the JAX package's with its native packer (the port's copy
of ``route_pack.cpp``), so every array is bit-equal to the JAX plan's;
there is no python packer (the native library builds or raises), and the
plan is a frozen dataclass of torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.kernels.mul_fill import SlotStream, build_slot_stream
from spblas_tpu_torch.kernels.route_plan import LANES, SLOTS, SUBS, _pick_g

# tile bit fields (shift, mask)
T1_LB, T1_OB, T1_Q1, T1_Q2, T1_Q3 = (0, 127), (7, 7), (13, 7), (16, 127), \
    (23, 7)
T2_LA, T2_OA, T2_S7 = (0, 127), (7, 7), (10, 7)
T3_DIST, T3_VA, T3_P1, T3_P2, T3_P3 = (0, 7), (3, 1), (4, 7), (7, 127), \
    (14, 7)


@dataclasses.dataclass(frozen=True)
class RouteMulPlan:
    """ROUTE v1 SpGEMM numeric plan, its arrays on one device."""

    tile1: torch.Tensor     # (nchunks, 8, 128) int32
    tile2: torch.Tensor     # (nchunks, 8, 128) int32
    tile3: torch.Tensor     # (nchunks, 8, 128) int32
    a_base: torch.Tensor    # (nchunks,) int32  A slab offset (pane rows)
    b_base: torch.Tensor    # (nchunks,) int32  B slab offset (pane rows)
    o_base: torch.Tensor    # (nchunks,) int32  out window (pane rows)
    g_a: int
    g_b: int
    a_rows: int
    b_rows: int
    out_rows: int
    capacity: int
    fill: float
    # the slot-sorted stream the tiles were packed from, which the CUDA
    # numeric reads (kernels/mul_fill.py); None on a plan carried from JAX
    expansion: Optional[SlotStream] = None

    @property
    def nchunks(self) -> int:
        return int(self.tile1.shape[0])


def build_route_mul_plan(slots, src_a, src_b, a_len: int, b_len: int,
                         capacity: int, device=None) -> RouteMulPlan:
    """Build from the slot-sorted, valid-only expansion stream (slots
    non-decreasing; a slot's duplicates are the entries that sum into
    it), and place the plan on ``device`` (default ``cuda``).
    ``a_len``/``b_len`` size the resident source panes."""
    dev = _t.resolve_device(device)
    slots = np.asarray(slots, np.int64)
    src_a = np.asarray(src_a, np.int64)
    src_b = np.asarray(src_b, np.int64)
    expansion = build_slot_stream(slots, src_a, src_b, a_len, b_len, dev)
    g_a = _pick_g(a_len)
    g_b = _pick_g(b_len)
    win_a = g_a * SLOTS
    win_b = g_b * SLOTS

    # cells: (1024-slot window) x (src_b window) x (src_a window), in
    # slot order within each cell
    key = ((slots // SLOTS) * ((b_len // win_b) + 2)
           + src_b // win_b) * ((a_len // win_a) + 2) + src_a // win_a
    order = np.lexsort((slots, key))
    slots, src_a, src_b = slots[order], src_a[order], src_b[order]
    kys = key[order]

    if len(slots):
        bounds = np.flatnonzero(np.diff(kys)) + 1
        starts = np.concatenate([[0], bounds])
        ne = len(slots)
        nch, t1, t2, t3, chunk_cell = native.route_mul_pack(
            ne, len(starts), np.concatenate([starts, [ne]]),
            slots % SLOTS, src_a % win_a, src_b % win_b)
        ab = ((src_a[starts] // win_a) * (win_a // LANES))[chunk_cell]
        bb = ((src_b[starts] // win_b) * (win_b // LANES))[chunk_cell]
        ob = ((slots[starts] // SLOTS) * (SLOTS // LANES))[chunk_cell]
    else:
        nch = 0
    if nch == 0:       # one empty chunk
        t1 = t2 = t3 = np.zeros((1, SUBS, LANES), np.int32)
        ab = bb = ob = np.zeros(1, np.int64)
        nch = 1

    a_rows = (a_len + LANES - 1) // LANES + SUBS * g_a
    b_rows = (b_len + LANES - 1) // LANES + SUBS * g_b
    out_rows = (capacity + LANES - 1) // LANES + SUBS
    fill = len(slots) / max(nch * SLOTS, 1)

    def put(arr, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(arr, dtype)).to(dev)

    return RouteMulPlan(
        tile1=put(t1), tile2=put(t2), tile3=put(t3),
        a_base=put(ab, np.int32), b_base=put(bb, np.int32),
        o_base=put(ob, np.int32), g_a=g_a, g_b=g_b, a_rows=a_rows,
        b_rows=b_rows, out_rows=out_rows, capacity=int(capacity),
        fill=float(fill), expansion=expansion)


# ------------------------------------------------------------------ #
# numpy simulator
# ------------------------------------------------------------------ #

def _pack_pane(v: np.ndarray, rows: int) -> np.ndarray:
    p = np.zeros((rows, LANES), np.float32)
    p.reshape(-1)[: len(v)] = v
    return p


def route_mul_numpy(plan: RouteMulPlan, a_arr: np.ndarray,
                    b_arr: np.ndarray) -> np.ndarray:
    """Exact numpy mirror of the kernel, sequential over chunks (the JAX
    package's simulator; the prefix zero-fills its rolled-in rows)."""
    A = _pack_pane(np.asarray(a_arr, np.float32), plan.a_rows)
    B = _pack_pane(np.asarray(b_arr, np.float32), plan.b_rows)
    O = np.zeros((plan.out_rows, LANES), np.float32)
    t1 = _t.to_numpy(plan.tile1)
    t2 = _t.to_numpy(plan.tile2)
    t3 = _t.to_numpy(plan.tile3)
    ab = _t.to_numpy(plan.a_base)
    bb = _t.to_numpy(plan.b_base)
    ob = _t.to_numpy(plan.o_base)
    jj = np.broadcast_to(np.arange(LANES)[None, :], (SUBS, LANES))
    ii = np.broadcast_to(np.arange(SUBS)[:, None], (SUBS, LANES))

    for k in range(plan.nchunks):
        a, b2, b = t1[k], t2[k], t3[k]
        # B gather (elementwise; sublane = s7_b)
        l_b = a & 127
        o_b = (a >> 7) & 7
        slabB = B[bb[k]:bb[k] + SUBS * plan.g_b]
        vb = np.zeros((SUBS, LANES), np.float32)
        for gg in range(plan.g_b):
            ug = slabB[gg * SUBS:(gg + 1) * SUBS][ii, l_b]
            vb = np.where(o_b == gg, ug, vb)
        # A gather (column-constant two-step)
        l_a = b2 & 127
        o_a = (b2 >> 7) & 7
        s7a = (b2 >> 10) & 7
        slabA = A[ab[k]:ab[k] + SUBS * plan.g_a]
        ua = np.zeros((SUBS, LANES), np.float32)
        for gg in range(plan.g_a):
            ug = slabA[gg * SUBS:(gg + 1) * SUBS][ii, l_a]
            ua = np.where(o_a == gg, ug, ua)
        c = ua[s7a, jj] * vb
        # permute 1, prefix, permute 2
        c = c[(a >> 13) & 7, jj]
        c = c[ii, (a >> 16) & 127]
        c = c[(a >> 23) & 7, jj]
        dist = b & 7
        P = c.copy()
        for d in (1, 2, 4):
            sh = np.roll(P, d, axis=0)
            sh[:d] = 0
            P = P + np.where(dist >= d, sh, 0.0)
        RS = P[(b >> 4) & 7, jj]
        RS = RS[ii, (b >> 7) & 127]
        RS = RS[(b >> 14) & 7, jj]
        O[ob[k]:ob[k] + SUBS] += RS * ((b >> 3) & 1)
    return O.reshape(-1)[: plan.capacity]

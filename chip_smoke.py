#!/usr/bin/env python3
"""Chip smoke test of spblas_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``spblas_tpu_torch/csrc``
and its native library (ROUTE packers, RCM) from
``spblas_tpu_torch/native/src``, holds each kernel against its plain
PyTorch version on the card, drives the main paths
``multiply(scaled(2.0, matrix_opt(A)), x)`` and
``multiply(scaled(2.0, matrix_opt(A)), B)`` at full width against the
port's float64 base path, and times every kernel beside its bound, its
plain version and the cuSPARSE call (``torch.mv`` or ``@`` on a
``torch.sparse_csr_tensor``, timed here as a yardstick only; the port
never calls it).

SpMV cells: the 409,600-row banded headline matrix, the 1000x1000
stencil, the 800x800 FEM mesh, the 64^3 stencil, uniform 300k and 1M
degree-10 matrices, a complex64 uniform 100k matrix, the 131k R-MAT
graph as it comes and with its rows in the chooser's degree order, a
uniform 4M degree-10 matrix, the 300k matrix held in float64, a 131,072^2
matrix of half-full 8x128 blocks and the headline band under a random
symmetric permutation.  SpMM cells: the headline band at k = 256, uniform
100k degree 10 at k = 256 and 64, the block matrix at k = 256, the
permuted band at k = 64, the stencil at k = 64 and a complex64 band at
k = 32.

Tolerance everywhere: |y - y_ref| <= 64 * eps_f32 * scale * (|A|.|x|)
per row (per entry of C against (|A|.|B|) for SpMM), the dot-product
form of the test suite's 64*eps model, since the two sides sum in
different orders.

Output: progress lines, one JSON line per kernel shape and per main-path
matrix, the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line; without a CUDA device it exits 2 and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

import spblas_tpu_torch as sp
from spblas_tpu_torch import _build, native
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.convert import bsr_to_csr
from spblas_tpu_torch.kernels import banded, dia, route2
from spblas_tpu_torch.kernels import bsr_kernels as bk
from spblas_tpu_torch.kernels import route2_kernel as r2k
from spblas_tpu_torch.kernels import route_paned as rpn
from spblas_tpu_torch.kernels import route_plan as rpl
from spblas_tpu_torch.kernels import route_spmv as rsp
from spblas_tpu_torch.utils import generate as gen

EPS32 = torch.finfo(torch.float32).eps
DEVICE = "cuda"   # where the script makes its own operands
# data-sheet memory bandwidth (bytes/s) and non-tensor-core f32 peak
# (flop/s) by part; the first name fragment found in the card's name wins
_PARTS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
          ("H100", 3.35e12, 67e12), ("H200", 4.8e12, 67e12))
_SLEEP_CYCLES = 50_000_000   # ~25 ms of device sleep ahead of a chain
_REPLICA_BYTES = 256 << 20   # distinct inputs per chain exceed the 50 MB L2

# the workload: (case, m, n, bandwidth, panel dtype, seed) for the band
# kernel beside the headline (409,600 rows, half-bandwidth 50, the bench
# headline matrix); the main-path matrices with the plan kind the chooser
# must pick; one wide rectangle more for the DIA kernel
HEADLINE = ("banded_409600_h50", 409_600, 409_600, 100)
BAND_CASES = [("odd_h_wide", 100_037, 120_000, 15, None, 11),
              ("odd_h_tall_bf16", 60_001, 50_000, 66, torch.bfloat16, 13)]
DIA_MAIN = [("stencil_1000x1000", lambda: gen.generate_stencil_csr(
                (1000, 1000), seed=1)),
            ("fem_800x800", lambda: gen.generate_fem_graph_csr(
                800, 800, seed=2)),
            ("stencil_64^3", lambda: gen.generate_stencil_csr(
                (64, 64, 64), seed=3))]
# kernel-only DIA shapes: a wide rectangle, and a mesh past the 2.5M-row
# extent of the kernel gate (which the main path keeps for parity)
DIA_KERNEL_ONLY = [
    ("wide_rect_30000x2000000", lambda: gen.generate_banded_csr(
        30_000, 2_000_000, 9, seed=4)),
    ("stencil_2000x2000", lambda: gen.generate_stencil_csr(
        (2000, 2000), seed=6))]
# general sparsity: the bench's spmv_general_route matrices (bench.py:145,
# :794, seed 3) take kind route; a complex64 uniform matrix route_cx
ROUTE_MAIN = [("uniform_300k_deg10", lambda: gen.generate_csr(
                  300_000, 300_000, 3_000_000, seed=3)),
              ("uniform_1m_deg10", lambda: gen.generate_csr(
                  1_000_000, 1_000_000, 10_000_000, seed=3))]
CX_MAIN = ("uniform_100k_deg10_c64", lambda: gen.generate_csr(
    100_000, 100_000, 1_000_000, seed=5, complex_=True))
# the bench's R-MAT graph (bench.py:768, seed 5; hub fraction 0.78) takes
# route1_sorted; the same rows put in the chooser's degree order first
# make its sort the identity and take route1
RMAT_MAIN = ("rmat_131k_deg16", lambda: gen.generate_rmat_csr(
    131_072, 131_072 * 16, seed=5))
# the bench's spmv_general_paned_4m matrix (bench.py:606-619, seed 3):
# x and y past the VMEM rows, kind route_paned
PANED_MAIN = ("uniform_4m_deg10", lambda: gen.generate_csr(
    4_000_000, 4_000_000, 40_000_000, seed=3))
# SELL: the f32 values of uniform 300k held in float64 (ROUTE_MAIN[0])
SELL_MAIN = "uniform_300k_deg10_f64"
# kernel-only ROUTE2 plans of the 300k matrix beside the main-path ones:
# five rows of degree 20,000 added (aux levels; as flag-2 hub chunks with
# hub_deg=256), and the any-lane publish
ROUTE_HUB_ROWS = (5, 20_000)
# kernel-only paned plan of the same 300k matrix with the hub rows:
# small panels and panes, so it has several of each and aux levels
PANED_SMALL = dict(panel_rows=65_536, pane_rows=512)

# SpMM: the bench's spmm_banded (bench.py:574, the headline band at
# k = 256) and spmm_general cells (bench.py:583, :804: uniform 100k,
# degree 10, seed 3, at k = 256 and 64)
SPMM_BANDED_K = 256
GENERAL_SPMM = ("uniform_100k_deg10", lambda: gen.generate_csr(
    100_000, 100_000, 1_000_000, seed=3), (256, 64))
# block-dense: (block rows, block columns, stored blocks a block row,
# fill of a stored 8x128 block, seed) -> 131,072^2, 33.5M nonzeros
BSR_MAIN = ("bsr_131072_8x128", (16_384, 1_024, 4, 0.5, 81), 256)
# the headline band under a seeded symmetric permutation (band_perm)
PERM_MAIN = ("band_perm_409600_h50", 82, 64)
DIA_SPMM_K = 64
# complex64 values on the odd_h_wide structure (band_cx)
CX_BAND_MAIN = ("banded_100k_h7_c64_k32", 100_037, 120_000, 15, 11, 32)
# kernel-only SpMM shapes: odd k on odd_h_wide, bf16 panels; BSR blocks
# of (128, 128) and (8, 8) with empty block rows:
# (name, block rows, block columns, blocks a row, block shape,
#  every how many block rows is empty, k, seed)
BAND_SPMM_ONLY = [("odd_h_wide", 33), ("odd_h_tall_bf16", 64)]
BSR_ONLY = [("bsr_16384_128x128_empty_rows", 128, 128, 3, (128, 128), 4,
             256, 83),
            ("bsr_65536_8x8_empty_rows", 8_192, 8_192, 8, (8, 8), 5, 256,
             84)]
# distinct B operands of a timed SpMM chain, at most this many bytes
_SPMM_OPERAND_BYTES = 8 << 30

BAND_SOURCE = "spblas_tpu_torch/csrc/band_spmv.cu"
DIA_SOURCE = "spblas_tpu_torch/csrc/dia_spmv.cu"
ROUTE_SOURCE = "spblas_tpu_torch/csrc/route2_spmv.cu"
V1_SOURCE = "spblas_tpu_torch/csrc/route_spmv.cu"
PANED_SOURCE = "spblas_tpu_torch/csrc/route_paned_spmv.cu"
BAND_REPLACES = "spblas_tpu/kernels/banded.py:104"
DIA_REPLACES = "spblas_tpu/kernels/dia.py:146"
ROUTE_REPLACES = "spblas_tpu/kernels/route2_kernel.py:119"
V1_REPLACES = "spblas_tpu/kernels/route_spmv.py:82"
PANED_REPLACES = "spblas_tpu/kernels/route_paned.py:404"
BAND_SPMM_SOURCE = "spblas_tpu_torch/csrc/band_spmm.cu"
BSR_SPMV_SOURCE = "spblas_tpu_torch/csrc/bsr_spmv.cu"
BSR_SPMM_SOURCE = "spblas_tpu_torch/csrc/bsr_spmm.cu"
BAND_SPMM_REPLACES = "spblas_tpu/kernels/banded.py:164"
BAND_STREAM_REPLACES = "spblas_tpu/kernels/banded.py:403"
BSR_SPMV_REPLACES = "spblas_tpu/kernels/bsr_pallas.py:128"
BSR_SPMM_REPLACES = "spblas_tpu/kernels/bsr_pallas.py:33"
# wrapper -> kernel name, for the launch counts
WRAPPERS = {"band_spmv": banded.band_spmv_padded,
            "dia_spmv": dia.dia_spmv_padded,
            "route2_spmv": r2k.route2_spmv_padded,
            "route_spmv": rsp.route_spmv_padded,
            "route_paned_spmv": rpn.route_paned_spmv_padded,
            "band_spmm": banded.band_spmm_padded,
            "band_spmm_stream": banded.band_spmm_stream_padded,
            "bsr_spmv": bk.bsr_spmv_blocks,
            "bsr_spmm": bk.bsr_spmm_blocks}
# kind -> the kernels its main-path SpMV call must launch
KIND_KERNELS = {"band": ("band_spmv",), "bsr": ("bsr_spmv",),
                "band_perm": ("band_spmv",),
                "route": ("route2_spmv",), "route_cx": ("route2_spmv",),
                "route1": ("route_spmv",),
                "route1_sorted": ("route_spmv", "route2_spmv"),
                "route_paned": ("route_paned_spmv",)}
# kind -> the kernels its main-path SpMM call must launch (the band kind
# at the spmm_banded shape streams B: its resident B passes 6 MB)
SPMM_KIND_KERNELS = {"band": ("band_spmm_stream",), "bsr": ("bsr_spmm",),
                     "band_perm": ("band_spmm",), "band_cx": ("band_spmm",)}


class SmokeFailure(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def part_rates(name: str):
    for frag, bw, f32 in _PARTS:
        if frag in name:
            return bw, f32
    raise SmokeFailure(f"no data-sheet rates for {name!r}")


def bound(nbytes, flops, rates):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 peak."""
    bw, f32 = rates
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _wide(t):
    return t.to(torch.complex128) if t.is_complex() else t.double()


def row_check(y, y_ref, absdot, scale=1.0):
    """Per-row tolerance; returns max |y - y_ref|."""
    err = (_wide(y) - _wide(y_ref)).abs()
    lim = 64 * EPS32 * abs(scale) * absdot.double()
    bad = int((err > lim).sum())
    require(bad == 0, f"{bad} rows outside 64*eps*(|A||x|) "
                      f"(max err {float(err.max()):.3e})")
    return float(err.max())


def device_ms(fn, inputs, reps=None):
    """Mean device time of ``fn(*args)`` over a chain cycling through the
    distinct ``inputs``.  A device sleep queued ahead lets the host enqueue
    the whole chain first, so host overhead does not count."""
    reps = reps or max(20, 2 * len(inputs))
    fn(*inputs[0])                                   # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    e0.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def replicas(make, nbytes):
    """Enough distinct copies of an operand set that a chain over them
    streams more than the L2 cache holds."""
    k = min(32, max(2, math.ceil(_REPLICA_BYTES / max(nbytes, 1))))
    return [make() for _ in range(k)]


def cusparse(a):
    """The CSR as a torch sparse tensor (cuSPARSE behind torch.mv)."""
    return torch.sparse_csr_tensor(a.rowptr, a.colind[: a.nnz],
                                   a.values[: a.nnz], size=a.shape)


def library_ms(a, x):
    sp_a = cusparse(a)
    nbytes = a.nnz * 8 + (a.shape[0] + 1) * 4
    reps_in = replicas(lambda: (cusparse(dataclasses.replace(
        a, values=a.values.clone(), colind=a.colind.clone())),
        x.clone()), nbytes)
    torch.mv(sp_a, x)
    return device_ms(torch.mv, reps_in)


# ------------------------------------------------------------------ #
# phase 2: each kernel against its plain version on the card
# ------------------------------------------------------------------ #

def band_case(name, m, n, bandwidth, dtype, seed, rates, card, csr=None):
    a = csr if csr is not None else gen.generate_banded_csr(
        m, n, bandwidth, seed=seed)
    plan = banded.build_band_plan(a, dtype=dtype)
    x = gen.generate_vector(n, seed=seed + 1)
    xp = banded.pad_x(plan, x)
    y_k = banded.band_spmv_padded(plan.panels, xp)
    torch.cuda.synchronize()
    y_p = banded.band_spmv_reference(plan.panels, xp)
    err = row_check(y_k, y_p,
                    banded.band_spmv_reference(plan.panels.abs(), xp.abs()))
    log(f"[check] band_spmv {name}: in bound, max |err| {err:.3e}")
    nbytes = (plan.panels.numel() * plan.panels.element_size()
              + xp.numel() * 4 + plan.panels.shape[0] * 4)
    b_ms, b_by = bound(nbytes, 2 * plan.panels.numel(), rates)
    ins = replicas(lambda: (plan.panels.clone(), xp.clone()), nbytes)
    k_ms = device_ms(banded.band_spmv_padded, ins)
    p_ms = device_ms(banded.band_spmv_reference, ins)
    l_ms = library_ms(a, x)
    rec = {"kernel": "band_spmv", "case": name, "m": m, "n": n,
           "half_bw": bandwidth // 2, "width": plan.width,
           "panels": str(plan.panels.dtype).split(".")[-1], "nnz": a.nnz,
           "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
           "bound_by": b_by, "plain_ms": p_ms, "library_ms": l_ms,
           "nnz_s": a.nnz / (k_ms * 1e-3), "card": card}
    return rec


def band_tall_check():
    """The band kernel past 2^27 rows, where a 32-bit row index would
    wrap: a bf16 diagonal plan (W = 128) whose every row holds 1 in
    column 0, so y[r] = xp[(r // 128) * 128] exactly and every row must
    be written (y starts as torch.empty)."""
    rows = (1 << 27) + 4 * 128
    panels = torch.zeros(rows, 128, dtype=torch.bfloat16, device="cuda")
    panels[:, 0] = 1
    xp = (torch.arange(rows, device="cuda") % 997).float()
    y = banded.band_spmv_padded(panels, xp)
    want = xp[torch.arange(rows, device="cuda") // 128 * 128]
    bad = int((y != want).sum())
    require(bad == 0, f"band_spmv at {rows} rows: {bad} rows wrong")
    log(f"[check] band_spmv at {rows} rows (past 2^27): exact")
    del panels, xp, y, want
    torch.cuda.empty_cache()


def dia_case(name, a, seed, rates, card):
    plan = dia.build_dia_plan(a)
    x = gen.generate_vector(a.shape[1], seed=seed)
    x2, pad_lo = dia.pad_x(plan, x)
    y_k = dia.dia_spmv_padded(plan, x2, pad_lo)
    torch.cuda.synchronize()
    y_p = dia.dia_spmv_reference(plan.diags, plan.offsets, x2, pad_lo)
    err = row_check(y_k, y_p, dia.dia_spmv_reference(
        plan.diags.abs(), plan.offsets, x2.abs(), pad_lo))
    log(f"[check] dia_spmv {name}: in bound, max |err| {err:.3e}")
    total = plan.diags.numel()
    rows = plan.diags.shape[1] * 128
    # x: the span the shifted reads cover (a wide rectangle reads little
    # of its padded x)
    x_read = rows + max(plan.offsets) - min(plan.offsets)
    nbytes = total * 4 + x_read * 4 + rows * 4
    b_ms, b_by = bound(nbytes, 2 * total, rates)

    def copy():
        p = dataclasses.replace(plan, diags=plan.diags.clone())
        p.offsets_tensor        # made now, not inside the timed chain
        return p, x2.clone(), pad_lo

    ins = replicas(copy, nbytes)
    k_ms = device_ms(dia.dia_spmv_padded, ins)
    p_ms = device_ms(lambda p, xx, lo: dia.dia_spmv_reference(
        p.diags, p.offsets, xx, lo), ins)
    l_ms = library_ms(a, x)
    rec = {"kernel": "dia_spmv", "case": name, "m": a.shape[0],
           "n": a.shape[1], "ndiag": plan.ndiag,
           "offsets": [min(plan.offsets), max(plan.offsets)],
           "nnz": a.nnz, "max_abs_err": err, "kernel_ms": k_ms,
           "bound_ms": b_ms, "bound_by": b_by, "plain_ms": p_ms,
           "library_ms": l_ms, "nnz_s": a.nnz / (k_ms * 1e-3),
           "card": card}
    return rec


def hub_rows_csr(a, count, degree, seed):
    """``a`` with ``count`` rows given ``degree`` distinct random columns
    each (duplicates merged), as a CSR on the card."""
    m, n = a.shape
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(
        a.rowptr.cpu().numpy().astype(np.int64)))
    hub = np.repeat(rng.choice(m, count, replace=False), degree)
    cols = np.concatenate([a.colind[: a.nnz].cpu().numpy(),
                           rng.integers(0, n, len(hub))])
    vals = np.concatenate([a.values[: a.nnz].cpu().numpy(),
                           rng.uniform(0, 100, len(hub)).astype(np.float32)])
    rows = np.concatenate([rows, hub])
    _, idx = np.unique(rows * n + cols, return_index=True)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows[idx],
                                                        minlength=m))])
    return CSR.from_arrays(vals[idx], rowptr, cols[idx], (m, n),
                           nnz=len(idx), device=a.device)


def route2_case(name, a, kw, seed, rates, card, plan=None):
    """``route2_spmv`` on the ROUTE2 plan of ``a`` (built with ``kw``, or
    ``plan`` as given) against its plain version."""
    if plan is None:
        plan = route2.build_route2_plan(a.rowptr, a.colind, a.values,
                                        a.shape, a.nnz, device=a.device,
                                        **kw)
    x = gen.generate_vector(a.shape[1], seed=seed)
    x2 = r2k.pack_x2(plan, x)
    before = r2k.route2_spmv_padded.launches
    y_k = r2k.route2_spmv_padded(plan, x2)
    torch.cuda.synchronize()
    per_call = r2k.route2_spmv_padded.launches - before
    require(per_call == len(plan.launch_ranges()),
            f"route2_spmv {name}: {per_call} launches")
    y_p = r2k.route2_spmv_reference(plan, x2)
    err = row_check(y_k, y_p, r2k.route2_spmv_reference(
        dataclasses.replace(plan, val=plan.val.abs()), x2.abs()))
    log(f"[check] route2_spmv {name}: in bound, max |err| {err:.3e}")
    # each input read once (tile and values, the per-chunk scalars, the x
    # pane), the output pane written twice (zeroed, then accumulated)
    nch = plan.nchunks
    nbytes = (nch * (8 * 1024 + 12 + 4 * plan.rotated)
              + plan.x_rows * 512 + 2 * r2k.out_rows(plan) * 512)
    b_ms, b_by = bound(nbytes, 2 * nch * 1024, rates)

    def copy():
        p = dataclasses.replace(
            plan, tile=plan.tile.clone(), val=plan.val.clone(),
            slab_base=plan.slab_base.clone(), y_base=plan.y_base.clone(),
            src_flag=plan.src_flag.clone(),
            rho=plan.rho.clone() if plan.rotated else None)
        return p, x2.clone()

    ins = replicas(copy, nbytes)
    k_ms = device_ms(r2k.route2_spmv_padded, ins)
    p_ms = device_ms(r2k.route2_spmv_reference, ins)
    l_ms = library_ms(a, x)
    del ins
    torch.cuda.empty_cache()
    return {"kernel": "route2_spmv", "case": name, "m": a.shape[0],
            "n": a.shape[1], "nnz": a.nnz, "build": kw, "nchunks": nch,
            "fill": plan.fill, "g": plan.g, "ww": plan.row_window_mult,
            "rotated": plan.rotated, "any_lane": plan.any_lane,
            "has_hub": plan.has_hub, "n_aux_chunks": plan.n_aux_chunks,
            "launches_per_call": per_call, "max_abs_err": err,
            "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": p_ms, "library_ms": l_ms,
            "nnz_s": a.nnz / (k_ms * 1e-3), "card": card}


def v1_levels(plan):
    """A ROUTE v1 plan and its aux plans, level by level."""
    out = []
    while plan is not None:
        out.append(plan)
        plan = plan.aux_plan
    return out


def route_v1_case(name, a, plan, seed, rates, card):
    """``route_spmv`` on every level of a v1 plan against its plain
    version; each level's x is the aux slots of the plain version's pane
    of the level before, so both sides see the same inputs."""
    levels = v1_levels(plan)
    xin = gen.generate_vector(a.shape[1], seed=seed)
    x2s, refs = [], []
    for p in levels:
        x2s.append(rsp.pack_x(p, xin))
        refs.append(rsp.route_spmv_reference(p, x2s[-1]))
        start = p.y_rows * 128
        xin = refs[-1].view(-1)[start:start + p.aux_len]
    before = rsp.route_spmv_padded.launches
    err = 0.0
    for p, x2, y_p in zip(levels, x2s, refs):
        y_k = rsp.route_spmv_padded(p, x2)
        torch.cuda.synchronize()
        err = max(err, row_check(y_k, y_p, rsp.route_spmv_reference(
            dataclasses.replace(p, val=p.val.abs()), x2.abs())))
    per_call = rsp.route_spmv_padded.launches - before
    require(per_call == len(levels), f"route_spmv {name}: {per_call} "
                                     f"launches for {len(levels)} levels")
    log(f"[check] route_spmv {name}: in bound, max |err| {err:.3e}")
    # each input read once (tile1, tile3 and values, the per-chunk
    # scalars, the x pane), each output pane written twice (zeroed, then
    # accumulated), over every level
    nbytes = sum(p.nchunks * (12 * 1024 + 8) + p.x_rows * 512
                 + 2 * p.pane_rows * 512 for p in levels)
    nslots = sum(p.nchunks for p in levels) * 1024
    b_ms, b_by = bound(nbytes, 2 * nslots, rates)

    def copy():
        ps = [dataclasses.replace(
            p, tile1=p.tile1.clone(), tile3=p.tile3.clone(),
            val=p.val.clone(), slab_base=p.slab_base.clone(),
            y_base=p.y_base.clone()) for p in levels]
        return ps, [x2.clone() for x2 in x2s]

    def run_levels(ps, xs, fn=rsp.route_spmv_padded):
        for p, x2 in zip(ps, xs):
            fn(p, x2)

    ins = replicas(copy, nbytes)
    k_ms = device_ms(run_levels, ins)
    p_ms = device_ms(lambda ps, xs: run_levels(
        ps, xs, rsp.route_spmv_reference), ins)
    l_ms = library_ms(a, gen.generate_vector(a.shape[1], seed=seed))
    del ins
    torch.cuda.empty_cache()
    return {"kernel": "route_spmv", "case": name, "m": a.shape[0],
            "n": a.shape[1], "nnz": a.nnz, "levels": len(levels),
            "nchunks": [p.nchunks for p in levels], "fill": plan.fill,
            "g": plan.g, "hot_cols": plan.hot_cols.numel(),
            "launches_per_call": per_call, "max_abs_err": err,
            "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": p_ms, "library_ms": l_ms,
            "nnz_s": a.nnz / (k_ms * 1e-3), "card": card}


def paned_case(name, a, plan, seed, rates, card):
    """``route_paned_spmv`` on every panel of a paned plan against its
    plain version, panel by panel."""
    x = gen.generate_vector(a.shape[1], seed=seed)
    x2 = rpn.pack_x2(plan, x)
    before = rpn.route_paned_spmv_padded.launches
    err = 0.0
    for p in plan.panels:
        y_k = rpn.route_paned_spmv_padded(plan, p, x2)
        torch.cuda.synchronize()
        y_p = rpn.route_paned_spmv_reference(plan, p, x2)
        err = max(err, row_check(y_k, y_p, rpn.route_paned_spmv_reference(
            plan, dataclasses.replace(p, val=p.val.abs()), x2.abs())))
        del y_k, y_p
    per_call = rpn.route_paned_spmv_padded.launches - before
    want = sum(hi > lo for p in plan.panels for lo, hi in p.launch_ranges())
    require(per_call == want, f"route_paned_spmv {name}: {per_call} "
                              f"launches, want {want}")
    log(f"[check] route_paned_spmv {name}: in bound, max |err| {err:.3e}")
    # each input read once (tile and values, the per-chunk scalars sb,
    # yb, fl, pane and rho where rotated, x), each panel pane written
    # twice (zeroed, then accumulated)
    nbytes = plan.x_rows_pad * 512 + sum(
        p.nchunks * (8 * 1024 + 16 + 4 * p.rotated) + 2 * p.out_rows * 512
        for p in plan.panels)
    b_ms, b_by = bound(nbytes, 2 * plan.nchunks * 1024, rates)

    def copy():
        return dataclasses.replace(plan, panels=tuple(
            dataclasses.replace(
                p, tile=p.tile.clone(), val=p.val.clone(), sb=p.sb.clone(),
                yb=p.yb.clone(), fl=p.fl.clone(), rho=p.rho.clone(),
                pane=p.pane.clone()) for p in plan.panels)), x2.clone()

    def run_panels(pl, xx, fn=rpn.route_paned_spmv_padded):
        for p in pl.panels:
            fn(pl, p, xx)

    ins = replicas(copy, nbytes)
    k_ms = device_ms(run_panels, ins)
    p_ms = device_ms(lambda pl, xx: run_panels(
        pl, xx, rpn.route_paned_spmv_reference), ins)
    l_ms = library_ms(a, x)
    del ins
    torch.cuda.empty_cache()
    return {"kernel": "route_paned_spmv", "case": name, "m": a.shape[0],
            "n": a.shape[1], "nnz": a.nnz, "panels": len(plan.panels),
            "panes": plan.x_rows_pad // plan.pane_rows,
            "nchunks": plan.nchunks, "fill": plan.fill, "g": plan.g,
            "ww": plan.row_window_mult,
            "rotated": any(p.rotated for p in plan.panels),
            "aux_levels": max(len(p.launch_starts) - 1 for p in plan.panels),
            "launches_per_call": per_call, "max_abs_err": err,
            "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": p_ms, "library_ms": l_ms,
            "nnz_s": a.nnz / (k_ms * 1e-3), "card": card}


def chooser_perm(a):
    """The ROUTE chooser's own row order of ``a`` (degree descending, then
    the rows' column centre of mass), as ``plans._try_route_sorted``
    computes it."""
    m = a.shape[0]
    deg = np.diff(a.rowptr.cpu().numpy().astype(np.int64))
    com = np.zeros(m)
    np.add.at(com, np.repeat(np.arange(m), deg),
              a.colind[: a.nnz].cpu().numpy())
    return np.lexsort((com / np.maximum(deg, 1), -deg))


def chooser_order_csr(a):
    """``a`` with its rows in the chooser's order, so that its sort is the
    identity."""
    m, n = a.shape
    rp = a.rowptr.cpu().numpy().astype(np.int64)
    ci = a.colind[: a.nnz].cpu().numpy()
    vv = a.values[: a.nnz].cpu().numpy()
    deg = np.diff(rp)
    perm = chooser_perm(a)
    new_deg = deg[perm]
    entry = (np.repeat(rp[perm] - np.concatenate(
        [[0], np.cumsum(new_deg)[:-1]]), new_deg)
        + np.arange(int(new_deg.sum())))
    return CSR.from_arrays(vv[entry], np.concatenate([[0], np.cumsum(
        new_deg)]), ci[entry], (m, n), nnz=a.nnz, device=a.device)


def unpermute_csr(a):
    """The un-permute of ``route1_sorted`` on ``a`` as a matrix: row i
    holds a 1 in column inv[i], inv the inverse of the chooser's order."""
    m = a.shape[0]
    inv = np.empty(m, np.int64)
    inv[chooser_perm(a)] = np.arange(m)
    return CSR.from_arrays(np.ones(m, np.float32), np.arange(m + 1), inv,
                           (m, m), nnz=m, device=a.device)


def route_cx_case(name, a, p, seed, rates, card):
    """The four ``route2_spmv`` applies of a ``route_cx`` call (two value
    planes of one ROUTE2 structure times the two planes of x), each
    against its plain version, timed as one chain."""
    kind, pr, pi = p
    require(kind == "route", f"{name}: route_cx over {kind!r}")
    x = gen.generate_vector(a.shape[1], seed=seed, complex_=True)
    xs = [r2k.pack_x2(pr, x.real.float()), r2k.pack_x2(pr, x.imag.float())]
    err = 0.0
    for plane in (pr, pi):
        for x2 in xs:
            y_k = r2k.route2_spmv_padded(plane, x2)
            torch.cuda.synchronize()
            err = max(err, row_check(
                y_k, r2k.route2_spmv_reference(plane, x2),
                r2k.route2_spmv_reference(dataclasses.replace(
                    plane, val=plane.val.abs()), x2.abs())))
    log(f"[check] route2_spmv {name} (4 applies): in bound, max |err| "
        f"{err:.3e}")
    nch = pr.nchunks
    one = (nch * (8 * 1024 + 12 + 4 * pr.rotated) + pr.x_rows * 512
           + 2 * r2k.out_rows(pr) * 512)
    b_ms, b_by = bound(4 * one, 4 * 2 * nch * 1024, rates)

    def copy():
        return ([dataclasses.replace(q, val=q.val.clone()) for q in (pr, pi)],
                [x2.clone() for x2 in xs])

    def four(planes, x2s, fn=r2k.route2_spmv_padded):
        for q in planes:
            for x2 in x2s:
                fn(q, x2)

    ins = replicas(copy, 4 * one)
    k_ms = device_ms(four, ins)
    p_ms = device_ms(lambda q, x2: four(q, x2, r2k.route2_spmv_reference),
                     ins)
    l_ms = library_ms(a, x)
    del ins
    torch.cuda.empty_cache()
    return {"kernel": "route2_spmv", "case": name, "m": a.shape[0],
            "n": a.shape[1], "nnz": a.nnz, "applies": 4, "nchunks": nch,
            "fill": pr.fill, "max_abs_err": err, "kernel_ms": k_ms,
            "bound_ms": b_ms, "bound_by": b_by, "plain_ms": p_ms,
            "library_ms": l_ms, "nnz_s": a.nnz / (k_ms * 1e-3),
            "card": card}


def dense_operands(n, k, seed, cx=False, count=1):
    """``count`` seeded dense (n, k) operands made on the card, U[0, 100)
    like ``generate_dense`` (complex: two such planes)."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    out = []
    for _ in range(count):
        t = torch.rand(n, k, generator=g, device=DEVICE) * 100
        if cx:
            t = torch.complex(t, torch.rand(n, k, generator=g,
                                            device=DEVICE) * 100)
        out.append(t)
    return out


def library_mm_ms(a, b):
    """cuSPARSE SpMM (``@`` on a torch.sparse_csr_tensor) on the same
    matrix and B."""
    nbytes = a.nnz * 8 + (a.shape[0] + 1) * 4 + b.numel() * 4
    reps_in = replicas(lambda: (cusparse(dataclasses.replace(
        a, values=a.values.clone(), colind=a.colind.clone())), b.clone()),
        nbytes)
    return device_ms(torch.matmul, reps_in)


def band_spmm_case(name, plan, k, seed, rates, card, csr=None):
    """Both band SpMM kernels on one plan and one B against their plain
    version; returns one record per kernel."""
    b = dense_operands(plan.shape[1], k, seed)[0]
    bp = banded.pad_b(plan, b)
    c_p = banded.band_spmm_reference(plan.panels, bp)
    absd = banded.band_spmm_reference(plan.panels.abs(), bp.abs())
    rows, w = plan.panels.shape
    # panels, the padded B and C, each once; the padded product's flops
    nbytes = (plan.panels.numel() * plan.panels.element_size()
              + bp.numel() * 4 + rows * k * 4)
    b_ms, b_by = bound(nbytes, 2 * rows * w * k, rates)
    ins = replicas(lambda: (plan.panels.clone(), bp.clone()), nbytes)
    p_ms = device_ms(banded.band_spmm_reference, ins)
    l_ms = library_mm_ms(csr, b) if csr is not None else None
    recs = []
    for kname, fn in (("band_spmm", banded.band_spmm_padded),
                      ("band_spmm_stream", banded.band_spmm_stream_padded)):
        c_k = fn(plan.panels, bp)
        torch.cuda.synchronize()
        err = row_check(c_k, c_p, absd)
        log(f"[check] {kname} {name}: in bound, max |err| {err:.3e}")
        del c_k
        k_ms = device_ms(fn, ins)
        recs.append({"kernel": kname, "case": name, "m": plan.shape[0],
                     "n": plan.shape[1], "k": k, "width": w,
                     "panels": str(plan.panels.dtype).split(".")[-1],
                     "max_abs_err": err, "kernel_ms": k_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "plain_ms": p_ms,
                     "library_ms": l_ms,
                     "flop_s": 2 * rows * w * k / (k_ms * 1e-3),
                     "card": card})
    del ins, c_p, absd, bp
    torch.cuda.empty_cache()
    return recs


def bsr_cases(name, a, csr, k, seed, rates, card, spmv=True):
    """``bsr_spmv`` (when ``spmv``) and ``bsr_spmm`` on one BSR against
    their plain versions; returns their records."""
    v, rp, ci = a.values, a.block_rowptr, a.block_colind
    nnzb = a.nnz_blocks
    bh, bw = a.block_shape
    mb = rp.numel() - 1
    # the stored blocks (not the capacity padding), rowptr, colind, the
    # dense operand and the output, each once
    meta = (mb + 1) * 4 + nnzb * 4 + nnzb * bh * bw * 4
    recs = []
    if spmv:
        x = gen.generate_vector(a.shape[1], seed=seed)
        y_k = bk.bsr_spmv_blocks(v, rp, ci, x)
        torch.cuda.synchronize()
        err = row_check(y_k, bk.bsr_spmv_reference(v, rp, ci, x),
                        bk.bsr_spmv_reference(v.abs(), rp, ci, x.abs()))
        log(f"[check] bsr_spmv {name}: in bound, max |err| {err:.3e}")
        nbytes = meta + x.numel() * 4 + mb * bh * 4
        b_ms, b_by = bound(nbytes, 2 * nnzb * bh * bw, rates)
        ins = replicas(lambda: (v.clone(), rp.clone(), ci.clone(),
                                x.clone()), nbytes)
        k_ms = device_ms(bk.bsr_spmv_blocks, ins)
        p_ms = device_ms(bk.bsr_spmv_reference, ins)
        del ins
        recs.append({"kernel": "bsr_spmv", "case": name, "m": a.shape[0],
                     "n": a.shape[1], "block": [bh, bw], "nnz_blocks": nnzb,
                     "empty_block_rows": int((rp[1:] == rp[:-1]).sum()),
                     "max_abs_err": err, "kernel_ms": k_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "plain_ms": p_ms,
                     "library_ms": library_ms(csr, x),
                     "nnz_s": a.nnz / (k_ms * 1e-3), "card": card})
    b = dense_operands(a.shape[1], k, seed + 1)[0]
    c_k = bk.bsr_spmm_blocks(v, rp, ci, b)
    torch.cuda.synchronize()
    err = row_check(c_k, bk.bsr_spmm_reference(v, rp, ci, b),
                    bk.bsr_spmm_reference(v.abs(), rp, ci, b.abs()))
    log(f"[check] bsr_spmm {name} k={k}: in bound, max |err| {err:.3e}")
    del c_k
    nbytes = meta + b.numel() * 4 + mb * bh * k * 4
    flops = 2 * nnzb * bh * bw * k
    b_ms, b_by = bound(nbytes, flops, rates)
    ins = replicas(lambda: (v.clone(), rp.clone(), ci.clone(), b.clone()),
                   nbytes)
    k_ms = device_ms(bk.bsr_spmm_blocks, ins)
    p_ms = device_ms(bk.bsr_spmm_reference, ins)
    del ins
    recs.append({"kernel": "bsr_spmm", "case": f"{name}_k{k}",
                 "m": a.shape[0], "n": a.shape[1], "k": k, "block": [bh, bw],
                 "nnz_blocks": nnzb,
                 "empty_block_rows": int((rp[1:] == rp[:-1]).sum()),
                 "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "plain_ms": p_ms,
                 "library_ms": library_mm_ms(csr, b),
                 "flop_s": flops / (k_ms * 1e-3), "card": card})
    torch.cuda.empty_cache()
    return recs


def block_csr(mb, nbc, per_row, fill, seed):
    """A (mb*8, nbc*128) CSR on the card: every block row holds
    ``per_row`` distinct seeded 8x128 blocks, each entry of a block
    stored with probability ``fill``."""
    rng = np.random.default_rng(seed)
    bcols = np.sort(np.argsort(rng.random((mb, nbc)), axis=1)[:, :per_row],
                    axis=1)
    mask = rng.random((mb, 8, per_row, 128)) < fill
    bi, r, e, q = np.nonzero(mask)        # row-major: sorted by row, col
    rows = bi * 8 + r
    cols = bcols[bi, e] * 128 + q
    vals = rng.uniform(-1, 1, len(rows)).astype(np.float32)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=mb * 8))])
    return CSR.from_arrays(vals, rowptr, cols, (mb * 8, nbc * 128),
                           nnz=len(rows), device=DEVICE)


def random_bsr(mb, nbc, per_row, block, empty_every, seed):
    """A BSR on the card with ``per_row`` seeded blocks of standard normal
    values in every block row but each ``empty_every``-th, which stays
    empty."""
    rng = np.random.default_rng(seed)
    bh, bw = block
    counts = np.where(np.arange(mb) % empty_every == 0, 0, per_row)
    cols = np.concatenate([np.sort(rng.choice(nbc, c, replace=False))
                           for c in counts])
    nnzb = len(cols)
    cap = 1 << (nnzb - 1).bit_length()
    vals = np.zeros((cap, bh, bw), np.float32)
    vals[:nnzb] = rng.standard_normal((nnzb, bh, bw))
    colind = np.zeros(cap, np.int32)
    colind[:nnzb] = cols
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BSR(values=torch.from_numpy(vals).to(DEVICE),
               block_rowptr=torch.from_numpy(rowptr).to(DEVICE),
               block_colind=torch.from_numpy(colind).to(DEVICE),
               nnz_blocks=nnzb, shape=(mb * bh, nbc * bw),
               block_shape=(bh, bw))


def permuted_csr(a, seed):
    """``a`` (square) under a seeded symmetric random permutation, made
    on the card."""
    m = a.shape[0]
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(m)).to(
        a.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(m, device=a.device)
    rows = inv[a.row_ids()[: a.nnz].long()]
    cols = inv[a.colind[: a.nnz].long()]
    order = torch.argsort(rows * m + cols)
    rowptr = torch.zeros(m + 1, dtype=torch.int64, device=a.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return CSR.from_arrays(a.values[: a.nnz][order], rowptr, cols[order],
                           (m, m), nnz=a.nnz, device=a.device)


# ------------------------------------------------------------------ #
# phase 3: the main path at full width
# ------------------------------------------------------------------ #

def main_path(name, a, kind, seed, card):
    cx = a.dtype.is_complex
    x = gen.generate_vector(a.shape[1], seed=seed, complex_=cx)
    opt = sp.matrix_opt(a)
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    y = sp.multiply(sp.scaled(2.0, opt), x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    got, plan = opt._plans["matvec"]
    log(f"[main] {name}: kind {got}, launches {launches}")
    require(got == kind, f"{name}: chooser picked {got!r}, want {kind!r}")
    require(y.shape == (a.shape[0],) and y.dtype == a.dtype
            and bool(torch.isfinite(y).all()), f"{name}: bad result")
    # reference: the port's own base path in float64 on the card
    a64 = dataclasses.replace(a, values=_wide(a.values))
    y_ref = sp.multiply(sp.scaled(2.0, a64), _wide(x))
    absdot = sp.multiply(dataclasses.replace(a, values=a.values.abs()
                                             .double()), x.abs().double())
    err = row_check(y, y_ref, absdot, scale=2.0)
    xs = [gen.generate_vector(a.shape[1], seed=seed + 1 + i, complex_=cx)
          for i in range(4)]
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    sp.multiply(sp.scaled(2.0, opt), xs[0])
    torch.cuda.synchronize()
    reps = 20
    e0.record()                 # end to end: host overhead included
    for i in range(reps):
        sp.multiply(sp.scaled(2.0, opt), xs[i % 4])
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    rec = {"main_path": name, "kind": got, "m": a.shape[0],
           "n": a.shape[1], "nnz": a.nnz, "launches": launches,
           "max_abs_err_vs_f64": err, "first_call_s": first_s, "ms": ms,
           "nnz_s": a.nnz / (ms * 1e-3), "card": card}
    emit(rec)
    return rec, plan


def spmm_check(a, b, c, scale):
    """C against the port's float64 base path on the card, per entry,
    in column blocks small enough that each block's (capacity, columns)
    intermediates stay near 4 GB; returns max |C - C_ref|."""
    a64 = dataclasses.replace(a, values=_wide(a.values))
    a_abs = dataclasses.replace(a, values=a.values.abs().double())
    width = 32 if a.dtype.is_complex else 16
    cb = max(1, int(4e9 // (a.capacity * width)))
    err = 0.0
    for j in range(0, b.shape[1], cb):
        bj = b[:, j:j + cb]
        ref = sp.multiply(sp.scaled(scale, a64), _wide(bj))
        absd = sp.multiply(a_abs, bj.abs().double())
        err = max(err, row_check(c[:, j:j + cb], ref, absd, scale=scale))
        del ref, absd
    return err


def main_path_spmm(name, a, kind, k, seed, card, opt=None):
    """``multiply(scaled(2.0, matrix_opt(A)), B)``: the first call (plan
    build included, unless ``opt`` already holds one), the check against
    float64, and 20 timed calls over distinct B."""
    cx = a.dtype.is_complex
    n = a.shape[1]
    count = max(2, min(20, _SPMM_OPERAND_BYTES // (n * k * (8 if cx
                                                            else 4))))
    bs = dense_operands(n, k, seed, cx, count)
    opt = opt if opt is not None else sp.matrix_opt(a)
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    c = sp.multiply(sp.scaled(2.0, opt), bs[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {key: w.launches for key, w in WRAPPERS.items()}
    got = (opt._plans.get("matmul") or opt._plans["matvec"])[0]
    log(f"[main] {name}: kind {got}, launches {launches}")
    require(got == kind, f"{name}: chooser picked {got!r}, want {kind!r}")
    require(c.shape == (a.shape[0], k) and c.dtype == a.dtype
            and bool(torch.isfinite(c).all()), f"{name}: bad result")
    err = spmm_check(a, bs[0], c, 2.0)
    del c
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    reps = 20
    e0.record()                 # end to end: host overhead included
    for i in range(reps):
        sp.multiply(sp.scaled(2.0, opt), bs[i % count])
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    rec = {"main_path": name, "op": "spmm", "kind": got, "m": a.shape[0],
           "n": n, "k": k, "nnz": a.nnz, "launches": launches,
           "max_abs_err_vs_f64": err, "first_call_s": first_s, "ms": ms,
           "distinct_b": count,
           "flop_s": 2 * a.nnz * k / (ms * 1e-3), "card": card}
    if got == "band":
        # the wrapper's padded copy of B, made every call (device time)
        plan = (opt._plans.get("matmul") or opt._plans["matvec"])[1]
        rec["pad_b_ms"] = device_ms(lambda bb: banded.pad_b(plan, bb),
                                    [(bb,) for bb in bs[:2]])
    emit(rec)
    del bs
    torch.cuda.empty_cache()
    return rec, opt


def run():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    # torch.sparse_csr_tensor's "beta" and invariant-check notices
    warnings.filterwarnings("ignore", message="Sparse")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    rates = part_rates(name)
    log(f"[card] {name}: {rates[0] / 1e12} TB/s, python "
        f"{sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # phase 1: build every kernel from the sources, all at once, and the
    # native packer beside them
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        packer = pool.submit(native.get_lib)
        outs = _build.build_all()
        packer.result()
    log(f"[build] {sorted(outs)} and {native.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for k, out in outs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {k}] {line.strip()}")

    # phase 2: kernels against their plain versions (f32; bf16 panels)
    band_tall_check()
    hname, hm, hn, hbw = HEADLINE
    head = gen.generate_banded_csr(hm, hn, hbw, seed=0)
    band_recs = [band_case(*c, rates, card) for c in BAND_CASES]
    band_recs += [band_case(f"{hname}{sfx}", hm, hn, hbw, dt, 0, rates,
                            card, csr=head)
                  for sfx, dt in (("", None), ("_bf16", torch.bfloat16))]
    mats = {n: make() for n, make in DIA_MAIN}
    dia_recs = {n: dia_case(n, a, 21, rates, card) for n, a in mats.items()}
    for i, (n, make) in enumerate(DIA_KERNEL_ONLY):
        dia_recs[n] = dia_case(n, make(), 22 + i, rates, card)
    general = {n: make() for n, make in ROUTE_MAIN}
    u300 = general[ROUTE_MAIN[0][0]]
    hubbed = hub_rows_csr(u300, *ROUTE_HUB_ROWS, seed=61)
    route_recs = [route2_case(n, a, {}, 62, rates, card)
                  for n, a in general.items()]
    route_recs += [
        route2_case("uniform_300k_hub_rows_aux", hubbed, {}, 63, rates,
                    card),
        route2_case("uniform_300k_hub_rows_hub256", hubbed,
                    {"hub_deg": 256}, 64, rates, card),
        route2_case("uniform_300k_any_lane", u300, {"any_lane": True}, 65,
                    rates, card)]
    require(route_recs[2]["n_aux_chunks"] > 0
            and route_recs[3]["has_hub"] and route_recs[4]["any_lane"]
            and route_recs[1]["rotated"],
            "route2 kernel cases miss a plan feature")
    # ROUTE v1: the plain plan of the R-MAT graph (aux levels, hot
    # columns) and the 300k matrix's v1 plan beside its ROUTE2 one
    rmat = RMAT_MAIN[1]()
    v1_recs = [route_v1_case(f"{n}_v1", a, rpl.build_route_plan(
        a.rowptr, a.colind, a.values, a.shape, a.nnz, device=a.device),
        71 + i, rates, card)
        for i, (n, a) in enumerate(((RMAT_MAIN[0], rmat),
                                    (ROUTE_MAIN[0][0], u300)))]
    require(v1_recs[0]["levels"] > 1 and v1_recs[0]["hot_cols"] > 0,
            "route_spmv R-MAT plan has no aux level or hot column")
    # paned ROUTE2 at small panels and panes, hub rows for aux levels
    paned_recs = [paned_case(
        "uniform_300k_hub_rows_paned", hubbed, rpn.build_route_paned_plan(
            hubbed.rowptr, hubbed.colind, hubbed.values, hubbed.shape,
            hubbed.nnz, device=hubbed.device, **PANED_SMALL), 73, rates,
        card)]
    require(paned_recs[0]["panels"] > 1 and paned_recs[0]["panes"] > 1
            and paned_recs[0]["aux_levels"] > 0,
            "route_paned_spmv small plan misses panels, panes or aux")
    del hubbed

    # SpMM kernels: both band kernels on the headline at the spmm_banded
    # k, at an odd k and on bf16 panels; BSR kernels on (128, 128) and
    # (8, 8) blocks with empty block rows
    band_cases = {c[0]: c for c in BAND_CASES}
    spmm_name = f"spmm_{hname}_k{SPMM_BANDED_K}"
    hplan = banded.build_band_plan(head)
    spmm_band_recs = band_spmm_case(spmm_name, hplan, SPMM_BANDED_K, 85,
                                    rates, card, csr=head)
    del hplan
    for i, (cname, k) in enumerate(BAND_SPMM_ONLY):
        _, m, n, bw, dt, seed = band_cases[cname]
        a = gen.generate_banded_csr(m, n, bw, seed=seed)
        spmm_band_recs += band_spmm_case(
            f"{cname}_k{k}", banded.build_band_plan(a, dtype=dt), k,
            96 + i, rates, card, csr=a)
    bsr_recs = []
    for bname, mb, nbc, per_row, block, every, k, seed in BSR_ONLY:
        a = random_bsr(mb, nbc, per_row, block, every, seed)
        bsr_recs += bsr_cases(bname, a, bsr_to_csr(a), k, seed, rates, card)
    require(all(r["empty_block_rows"] > 0 for r in bsr_recs),
            "BSR kernel cases have no empty block row")
    del a

    # phase 3: the main path at full width, counts read around each run
    main = [main_path(hname, head, "band", 31, card)[0]]
    main += [main_path(n, a, "dia", 41, card)[0] for n, a in mats.items()]
    main += [main_path(n, a, "route", 51, card)[0]
             for n, a in general.items()]
    cx_a = CX_MAIN[1]()
    rec, plan = main_path(CX_MAIN[0], cx_a, "route_cx", 52, card)
    main.append(rec)
    route_recs.append(route_cx_case(CX_MAIN[0], cx_a, plan, 57, rates,
                                    card))
    del cx_a, plan
    rec, plan = main_path(RMAT_MAIN[0], rmat, "route1_sorted", 54, card)
    main.append(rec)
    # the main path's own v1 plan: the degree-sorted base, and its
    # ROUTE2 un-permute
    v1_recs.append(route_v1_case(RMAT_MAIN[0], rmat, plan.base, 74, rates,
                                 card))
    unperm = route2_case(RMAT_MAIN[0], unpermute_csr(rmat), {}, 77, rates,
                         card, plan=plan.unperm)
    co = chooser_order_csr(rmat)
    rec, plan = main_path(f"{RMAT_MAIN[0]}_chooser_order", co, "route1",
                          55, card)
    main.append(rec)
    v1_recs.append(route_v1_case(f"{RMAT_MAIN[0]}_chooser_order", co, plan,
                                 76, rates, card))
    del rmat, plan, co
    big = PANED_MAIN[1]()
    rec, plan = main_path(PANED_MAIN[0], big, "route_paned", 56, card)
    main.append(rec)
    paned_recs.append(paned_case(PANED_MAIN[0], big, plan, 75, rates, card))
    del big, plan
    torch.cuda.empty_cache()
    main.append(main_path(SELL_MAIN, dataclasses.replace(
        u300, values=u300.values.double()), "sell", 53, card)[0])
    del general, u300

    # the BSR and RCM-band rungs, SpMV then SpMM, and their kernels on
    # the main path's own plans
    bname, bargs, bsr_k = BSR_MAIN
    ba = block_csr(*bargs)
    rec, plan = main_path(bname, ba, "bsr", 87, card)
    main.append(rec)
    bsr_recs = bsr_cases(bname, plan[0], ba, bsr_k, 88, rates,
                         card) + bsr_recs
    main.append(main_path_spmm(f"{bname}_k{bsr_k}", ba, "bsr", bsr_k, 89,
                               card)[0])
    del ba, plan
    pname, pseed, pk = PERM_MAIN
    pa = permuted_csr(head, pseed)
    rec, plan = main_path(pname, pa, "band_perm", 90, card)
    main.append(rec)
    spmm_band_recs += band_spmm_case(f"{pname}_k{pk}", plan.band, pk, 91,
                                     rates, card, csr=pa)
    main.append(main_path_spmm(f"{pname}_k{pk}", pa, "band_perm", pk, 92,
                               card)[0])
    del pa, plan
    torch.cuda.empty_cache()
    # SpMM over the band (B streamed), SELL, DIA and the complex band
    main.append(main_path_spmm(spmm_name, head, "band", SPMM_BANDED_K, 86,
                               card)[0])
    del head
    gname, gmake, gks = GENERAL_SPMM
    ga = gmake()
    main += [main_path_spmm(f"spmm_{gname}_k{k}", ga, "sell", k, 93 + i,
                            card)[0] for i, k in enumerate(gks)]
    del ga
    sname = DIA_MAIN[0][0]
    main.append(main_path_spmm(f"{sname}_k{DIA_SPMM_K}", mats[sname], "dia",
                               DIA_SPMM_K, 95, card)[0])
    cname, m, n, bw, seed, ck = CX_BAND_MAIN
    ca = gen.generate_banded_csr(m, n, bw, seed=seed, dtype=np.complex64)
    rec, opt = main_path_spmm(cname, ca, "band_cx", ck, 98, card)
    main.append(rec)
    require(rec["launches"]["band_spmm"] == 4,
            f"{cname}: {rec['launches']['band_spmm']} band_spmm launches")
    spmm_band_recs += band_spmm_case(
        cname, opt._plans["matmul"][1][0], ck, 99, rates, card,
        csr=dataclasses.replace(ca, values=ca.values.real.contiguous()))
    del ca, opt
    for r in main:
        table = SPMM_KIND_KERNELS if r.get("op") == "spmm" else KIND_KERNELS
        for k in table.get(r["kind"], ()):
            require(r["launches"][k] > 0,
                    f"{r['main_path']} ({r['kind']}) did not launch {k}")
    launches = {k: sum(r["launches"][k] for r in main) for k in WRAPPERS}
    require(all(launches.values()),
            f"main path missed a kernel: {launches}")

    # phase 4: one line per kernel and shape, with the launches of the
    # main-path call on that matrix (0: a kernel-only shape)
    by_name = {r["main_path"]: r["launches"] for r in main}
    for r in (band_recs + list(dia_recs.values()) + route_recs + [unperm]
              + v1_recs + paned_recs + spmm_band_recs + bsr_recs):
        r["launches"] = by_name.get(r["case"], {}).get(r["kernel"], 0)
        emit(r)

    def line(kname, source, replaces, head_rec, recs):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": head_rec["kernel_ms"], "plain_ms": head_rec["plain_ms"],
                "bound_ms": head_rec["bound_ms"],
                "bound_by": head_rec["bound_by"],
                "library_ms": head_rec["library_ms"]}

    def of(recs, kname, case=None):
        return [r for r in recs if r["kernel"] == kname
                and (case is None or r["case"] == case)]

    log(card)
    emit({"kernels": [
        line("band_spmv", BAND_SOURCE, BAND_REPLACES,
             band_recs[len(BAND_CASES)], band_recs),
        line("dia_spmv", DIA_SOURCE, DIA_REPLACES, dia_recs[DIA_MAIN[0][0]],
             list(dia_recs.values())),
        line("route2_spmv", ROUTE_SOURCE, ROUTE_REPLACES, route_recs[0],
             route_recs + [unperm]),
        line("route_spmv", V1_SOURCE, V1_REPLACES,
             of(v1_recs, "route_spmv", RMAT_MAIN[0])[0], v1_recs),
        line("route_paned_spmv", PANED_SOURCE, PANED_REPLACES,
             paned_recs[-1], paned_recs),
        line("band_spmm", BAND_SPMM_SOURCE, BAND_SPMM_REPLACES,
             of(spmm_band_recs, "band_spmm", spmm_name)[0],
             of(spmm_band_recs, "band_spmm")),
        line("band_spmm_stream", BAND_SPMM_SOURCE, BAND_STREAM_REPLACES,
             of(spmm_band_recs, "band_spmm_stream", spmm_name)[0],
             of(spmm_band_recs, "band_spmm_stream")),
        line("bsr_spmv", BSR_SPMV_SOURCE, BSR_SPMV_REPLACES,
             of(bsr_recs, "bsr_spmv", bname)[0], of(bsr_recs, "bsr_spmv")),
        line("bsr_spmm", BSR_SPMM_SOURCE, BSR_SPMM_REPLACES,
             of(bsr_recs, "bsr_spmm", f"{bname}_k{bsr_k}")[0],
             of(bsr_recs, "bsr_spmm")),
    ]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(run())

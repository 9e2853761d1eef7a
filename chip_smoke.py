#!/usr/bin/env python3
"""Chip smoke test of spblas_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``spblas_tpu_torch/csrc``
and its native ROUTE packers from ``spblas_tpu_torch/native/src``, holds
each kernel against its plain PyTorch version on the card, drives the
main path ``multiply(scaled(2.0, matrix_opt(A)), x)`` at full width (the
409,600-row banded headline matrix, the 1000x1000 stencil, the 800x800
FEM mesh, the 64^3 stencil, uniform 300k and 1M degree-10 matrices, a
complex64 uniform 100k matrix, the 131k R-MAT graph as it comes and with
its rows in the chooser's degree order, a uniform 4M degree-10 matrix
and the 300k matrix held in float64) against the port's float64 base
path, and times every kernel beside its bound, its plain version and the
cuSPARSE call (``torch.mv`` on a ``torch.sparse_csr_tensor``, timed here
as a yardstick only; the port never calls it).

Tolerance everywhere: |y - y_ref|_i <= 64 * eps_f32 * scale * (|A|.|x|)_i,
the dot-product form of the test suite's 64*eps model, since the two
sides sum each row in different orders.

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
from spblas_tpu_torch.kernels import banded, dia, route2
from spblas_tpu_torch.kernels import route2_kernel as r2k
from spblas_tpu_torch.kernels import route_paned as rpn
from spblas_tpu_torch.kernels import route_plan as rpl
from spblas_tpu_torch.kernels import route_spmv as rsp
from spblas_tpu_torch.utils import generate as gen

EPS32 = torch.finfo(torch.float32).eps
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
# wrapper -> kernel name, for the launch counts
WRAPPERS = {"band_spmv": banded.band_spmv_padded,
            "dia_spmv": dia.dia_spmv_padded,
            "route2_spmv": r2k.route2_spmv_padded,
            "route_spmv": rsp.route_spmv_padded,
            "route_paned_spmv": rpn.route_paned_spmv_padded}
# kind -> the kernels its main-path call must launch
KIND_KERNELS = {"route": ("route2_spmv",), "route_cx": ("route2_spmv",),
                "route1": ("route_spmv",),
                "route1_sorted": ("route_spmv", "route2_spmv"),
                "route_paned": ("route_paned_spmv",)}


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


def route2_case(name, a, kw, seed, rates, card):
    plan = route2.build_route2_plan(a.rowptr, a.colind, a.values, a.shape,
                                    a.nnz, device=a.device, **kw)
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


def chooser_order_csr(a):
    """``a`` with its rows in the ROUTE chooser's own order (degree
    descending, then the rows' column centre of mass), as
    ``plans._try_route_sorted`` computes it, so that its sort is the
    identity."""
    m, n = a.shape
    rp = a.rowptr.cpu().numpy().astype(np.int64)
    ci = a.colind[: a.nnz].cpu().numpy()
    vv = a.values[: a.nnz].cpu().numpy()
    deg = np.diff(rp)
    com = np.zeros(m)
    np.add.at(com, np.repeat(np.arange(m), deg), ci)
    perm = np.lexsort((com / np.maximum(deg, 1), -deg))
    new_deg = deg[perm]
    entry = (np.repeat(rp[perm] - np.concatenate(
        [[0], np.cumsum(new_deg)[:-1]]), new_deg)
        + np.arange(int(new_deg.sum())))
    return CSR.from_arrays(vv[entry], np.concatenate([[0], np.cumsum(
        new_deg)]), ci[entry], (m, n), nnz=a.nnz, device=a.device)


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

    # phase 3: the main path at full width, counts read around each run
    main = [main_path(hname, head, "band", 31, card)[0]]
    main += [main_path(n, a, "dia", 41, card)[0] for n, a in mats.items()]
    main += [main_path(n, a, "route", 51, card)[0]
             for n, a in general.items()]
    main.append(main_path(CX_MAIN[0], CX_MAIN[1](), "route_cx", 52,
                          card)[0])
    rec, plan = main_path(RMAT_MAIN[0], rmat, "route1_sorted", 54, card)
    main.append(rec)
    # the main path's own v1 plan: the degree-sorted base
    v1_recs.append(route_v1_case(RMAT_MAIN[0], rmat, plan.base, 74, rates,
                                 card))
    main.append(main_path(f"{RMAT_MAIN[0]}_chooser_order",
                          chooser_order_csr(rmat), "route1", 55, card)[0])
    del rmat, plan
    big = PANED_MAIN[1]()
    rec, plan = main_path(PANED_MAIN[0], big, "route_paned", 56, card)
    main.append(rec)
    paned_recs.append(paned_case(PANED_MAIN[0], big, plan, 75, rates, card))
    del big, plan
    torch.cuda.empty_cache()
    main.append(main_path(SELL_MAIN, dataclasses.replace(
        u300, values=u300.values.double()), "sell", 53, card)[0])
    for r in main:
        for k in KIND_KERNELS.get(r["kind"], ()):
            require(r["launches"][k] > 0,
                    f"{r['main_path']} ({r['kind']}) did not launch {k}")
    launches = {k: sum(r["launches"][k] for r in main) for k in WRAPPERS}
    require(all(launches.values()),
            f"main path missed a kernel: {launches}")

    # phase 4: one line per kernel and shape, with the launches of the
    # main-path call on that matrix (0: a kernel-only shape)
    by_name = {r["main_path"]: r["launches"] for r in main}
    for r in (band_recs + list(dia_recs.values()) + route_recs + v1_recs
              + paned_recs):
        r["launches"] = by_name.get(r["case"], {}).get(r["kernel"], 0)
        emit(r)

    hb, hd = band_recs[len(BAND_CASES)], dia_recs[DIA_MAIN[0][0]]
    hr, hv, hp = route_recs[0], v1_recs[-1], paned_recs[-1]
    log(card)
    emit({"kernels": [
        {"name": "band_spmv", "route": "cuda", "source": BAND_SOURCE,
         "replaces": BAND_REPLACES, "launches": launches["band_spmv"],
         "max_abs_err": max(r["max_abs_err"] for r in band_recs),
         "ms": hb["kernel_ms"], "plain_ms": hb["plain_ms"],
         "bound_ms": hb["bound_ms"], "bound_by": hb["bound_by"],
         "library_ms": hb["library_ms"]},
        {"name": "dia_spmv", "route": "cuda", "source": DIA_SOURCE,
         "replaces": DIA_REPLACES, "launches": launches["dia_spmv"],
         "max_abs_err": max(r["max_abs_err"] for r in dia_recs.values()),
         "ms": hd["kernel_ms"], "plain_ms": hd["plain_ms"],
         "bound_ms": hd["bound_ms"], "bound_by": hd["bound_by"],
         "library_ms": hd["library_ms"]},
        {"name": "route2_spmv", "route": "cuda", "source": ROUTE_SOURCE,
         "replaces": ROUTE_REPLACES, "launches": launches["route2_spmv"],
         "max_abs_err": max(r["max_abs_err"] for r in route_recs),
         "ms": hr["kernel_ms"], "plain_ms": hr["plain_ms"],
         "bound_ms": hr["bound_ms"], "bound_by": hr["bound_by"],
         "library_ms": hr["library_ms"]},
        {"name": "route_spmv", "route": "cuda", "source": V1_SOURCE,
         "replaces": V1_REPLACES, "launches": launches["route_spmv"],
         "max_abs_err": max(r["max_abs_err"] for r in v1_recs),
         "ms": hv["kernel_ms"], "plain_ms": hv["plain_ms"],
         "bound_ms": hv["bound_ms"], "bound_by": hv["bound_by"],
         "library_ms": hv["library_ms"]},
        {"name": "route_paned_spmv", "route": "cuda", "source": PANED_SOURCE,
         "replaces": PANED_REPLACES, "launches": launches["route_paned_spmv"],
         "max_abs_err": max(r["max_abs_err"] for r in paned_recs),
         "ms": hp["kernel_ms"], "plain_ms": hp["plain_ms"],
         "bound_ms": hp["bound_ms"], "bound_by": hp["bound_by"],
         "library_ms": hp["library_ms"]},
    ]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(run())

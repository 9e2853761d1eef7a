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
k = 32.  SpGEMM cells: bench.py's 2k and 100k A.A products (the ROUTE2-mul
engines), the 2k one again on the ROUTE v1 engine, and a BSR.BSR
product.  The headline band laid out on the card from random diagonals
runs 10 power iterations.  SpTRSV cells: bench.py's 20k triangular factor
and its 1M-row 15,625-level chain, and a 1.2M-row chain that takes the
blocked solve.

The ROUTE v1 kernel runs every level of a plan in one launch, ordered
by device counters, and the paned kernel one launch per aux level: each
runs 50 times back to back on a plan with aux levels, every result
checked (a wait that lets a chunk read too early gives a wrong row).

Tolerance everywhere: |y - y_ref| <= 64 * eps_f32 * scale * (|A|.|x|)
per row (per entry of C against (|A|.|B|) for SpMM), the dot-product
form of the test suite's 64*eps model, since the two sides sum in
different orders.  A solve is held to the componentwise backward error
|2 A x - b| <= 64 * eps_f32 * (2 |A| |x| + |b|) per row and to the
forward error it implies against the float64 sweep.

Output: progress lines, one JSON line per kernel shape and per main-path
matrix, the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line; without a CUDA device it exits 2 and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import importlib
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
from spblas_tpu_torch.kernels import bsr_spgemm as bsg
from spblas_tpu_torch.kernels import route2_kernel as r2k
from spblas_tpu_torch.kernels import route_mul as rml
from spblas_tpu_torch.kernels import route_mul_kernel as rmk
from spblas_tpu_torch.kernels import route_mul_paned as rmp
from spblas_tpu_torch.kernels import route_paned as rpn
from spblas_tpu_torch.kernels import route_plan as rpl
from spblas_tpu_torch.kernels import route_spmv as rsp
from spblas_tpu_torch.kernels.route2 import Route2MulPlan
from spblas_tpu_torch.kernels.route_mul_paned import Route2MulPanedPlan
from spblas_tpu_torch.utils import generate as gen

# the module (the package exports a function of the same name)
spgemm_ops = importlib.import_module("spblas_tpu_torch.ops.spgemm")

EPS32 = torch.finfo(torch.float32).eps
DEVICE = "cuda"   # where the script makes its own operands
# data-sheet memory bandwidth (bytes/s) and non-tensor-core f32 and f64
# peaks (flop/s) by part; the first name fragment found in the card's
# name wins
_PARTS = (("H100 PCIe", 2.0e12, 51e12, 26e12),
          ("H100 NVL", 3.9e12, 60e12, 30e12),
          ("H100", 3.35e12, 67e12, 34e12), ("H200", 4.8e12, 67e12, 34e12))
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
# back-to-back runs of the race checks (the R-MAT v1 plan, the hub-row
# paned plan), each result checked
RACE_RUNS = 50

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

# SpGEMM: bench.py's section_spgemm (bench.py:190, C = A.A on a uniform
# 2,000^2 matrix of 40,000 entries, seed 0: the resident mul engine) and
# section_spgemm_large (bench.py:254, 100,000^2, 1,000,000 entries, seed
# 0: the paned engine), with the structure numbers of the JAX records
# (BENCH_r03.json, BENCH_r05.json) the port's plans must reproduce
SPGEMM_MAIN = [
    ("spgemm_2k", lambda: gen.generate_csr(2000, 2000, 40_000, seed=0),
     "resident", dict(result_nnz=725_545, chunks=2150)),
    ("spgemm_large_100k", lambda: gen.generate_csr(
        100_000, 100_000, 1_000_000, seed=0),
     "paned", dict(result_nnz=9_997_508, chunks=294_520, panels=10))]
SPGEMM_FILLS = 20              # timed numeric fills on distinct values
# hub-slot expansion streams that reach the aux levels (neither bench
# plan has an aux chunk): (entries, capacity, (slot, entries) hubs,
# a_len, b_len, seed) and, paned, the panel slots and pane rows
MUL_HUB = (400_000, 65_536, ((0, 20_000), (777, 50_000), (4096, 5_000)),
           1501, 1800, 101)
MUL_PANED_HUB = (600_000, 262_144, ((0, 20_000), (70_000, 30_000),
                                    (140_000, 8_000)), 20_001, 400_000,
                 102, dict(panel_slots=65_536, pane_rows=512))
# block SpGEMM: A = B = 32,768^2 of 128x128 f32 blocks, 8 seeded block
# columns in each of the 256 block rows (16,384 pairs, 68.7 GFLOP);
# kernel only, an (8, 128).(128, 128) product with empty block rows:
# (name, block rows, block columns, blocks a row, block shape, every how
#  many block rows is empty (0: none), seed) for A, then B's
BSR_SPGEMM_MAIN = ("bsr_spgemm_32768_128x128",
                   (256, 256, 8, (128, 128), 0, 111),
                   (256, 256, 8, (128, 128), 0, 112))
BSR_SPGEMM_ONLY = ("bsr_spgemm_8x128_128x128_empty_rows",
                   (512, 64, 4, (8, 128), 3, 113),
                   (64, 64, 4, (128, 128), 0, 114))

# SpGEMM on the ROUTE v1 engine (SPBLAS_ROUTE_SPGEMM=1): bench.py's 2k
# A.A product again; kernel only, a heavily duplicated stream whose out
# windows overlap (~330 chunks a window, past 10,000 chunks; the dup = 40
# stream of tests/test_route_mul.py at 32,768 slots):
# (slots, mean duplicates, a_len, b_len, seed)
V1_MAIN = ("spgemm_2k_v1", lambda: gen.generate_csr(2000, 2000, 40_000,
                                                    seed=0),
           dict(result_nnz=725_545))
V1_OVERLAP = ("dup40_overlap", (32_768, 40, 50, 60, 103))

# SpTRSV: bench.py's section_sptrsv (bench.py:410-417: 20,000 rows,
# generate_triangular_csr, density 0.0005, lower, seed 0) and
# section_sptrsv_deep (bench.py:467-482: 1,000,000 rows,
# generate_block_chain_lower, block 64, deg 4, seed 0: 15,625 levels), and
# the same generator at 1,200,000 rows, the smallest size the one-pane cap
# (m / 128 > 9,000) sends to the blocked solve (two blocks of 2^20 rows):
# (name, make, executor, levels)
TRSV_MAIN = [
    ("sptrsv_20k", lambda: gen.generate_triangular_csr(
        20_000, seed=0, lower=True, density=0.0005), "route", None),
    ("sptrsv_deep_1m", lambda: gen.generate_block_chain_lower(
        1_000_000, block=64, deg=4, seed=0), "route", 15_625),
    ("sptrsv_blocked_1_2m", lambda: gen.generate_block_chain_lower(
        1_200_000, block=64, deg=4, seed=0), "blocked", 18_750)]
TRSV_SOLVES = 20               # timed solves on distinct right-hand sides

# band power iterations on the headline band built on the card from
# random diagonals (bench.py:66-86, _device_band_plan): (name, rows, half
# bandwidth, iterations)
POWER_MAIN = ("band_power_409600_h50", 409_600, 50, 10)

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
MUL_SOURCE = "spblas_tpu_torch/csrc/route2_mul.cu"
MUL_PANED_SOURCE = "spblas_tpu_torch/csrc/route_mul_paned.cu"
BSR_SPGEMM_SOURCE = "spblas_tpu_torch/csrc/bsr_spgemm.cu"
MUL_REPLACES = "spblas_tpu/kernels/route2_kernel.py:414"
MUL_PANED_REPLACES = "spblas_tpu/kernels/route_mul_paned.py:274"
BSR_SPGEMM_REPLACES = "spblas_tpu/kernels/bsr_spgemm.py:114"
V1_MUL_SOURCE = "spblas_tpu_torch/csrc/route_mul.cu"
V1_MUL_REPLACES = "spblas_tpu/kernels/route_mul_kernel.py:69"
POWER_SOURCE = "spblas_tpu_torch/csrc/band_power.cu"
POWER_REPLACES = "spblas_tpu/kernels/banded.py:474"
SOLVE_SOURCE = "spblas_tpu_torch/csrc/route2_spmv.cu"
SOLVE_REPLACES = "spblas_tpu/kernels/route2_kernel.py:119"
# wrapper -> kernel name, for the launch counts
WRAPPERS = {"band_spmv": banded.band_spmv_padded,
            "dia_spmv": dia.dia_spmv_padded,
            "route2_spmv": r2k.route2_spmv_padded,
            "route_spmv": rsp.route_spmv_padded,
            "route_paned_spmv": rpn.route_paned_spmv_padded,
            "band_spmm": banded.band_spmm_padded,
            "band_spmm_stream": banded.band_spmm_stream_padded,
            "bsr_spmv": bk.bsr_spmv_blocks,
            "bsr_spmm": bk.bsr_spmm_blocks,
            "route2_mul": r2k.route2_mul_padded,
            "route2_mul_paned": rmp.route2_mul_paned_padded,
            "bsr_spgemm": bsg.bsr_spgemm_blocks,
            "route_mul": rmk.route_mul_padded,
            "band_power": banded.band_power_padded,
            "route2_solve": r2k.route2_solve_padded}
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
# engine -> the kernels a main-path SpGEMM (compute, then one fill; for
# BSR the one-shot multiply) must launch
SPGEMM_KIND_KERNELS = {"resident": ("route2_mul",),
                       "paned": ("route2_mul_paned",),
                       "bsr": ("bsr_spgemm",), "v1": ("route_mul",)}
# executor -> the kernels a main-path solve must launch; the power chain
TRSV_KIND_KERNELS = {"route": ("route2_solve",),
                     "blocked": ("route2_solve",)}
POWER_KIND_KERNELS = {"band": ("band_power",)}


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
    """(memory rate, f32 peak, f64 peak) of the card."""
    for frag, bw, f32, f64 in _PARTS:
        if frag in name:
            return bw, f32, f64
    raise SmokeFailure(f"no data-sheet rates for {name!r}")


def bound(nbytes, flops, rates, f64=False):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 (or, with ``f64``, the f64) peak."""
    bw, peak = rates[0], rates[2 if f64 else 1]
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
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

def band_case(name, m, n, bandwidth, dtype, seed, rates, card, csr=None,
              plan=None):
    a = csr if csr is not None else gen.generate_banded_csr(
        m, n, bandwidth, seed=seed)
    if plan is None:
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


def v1_copy(plan):
    """A copy of a v1 plan whose kernel arrays are distinct tensors (the
    chain rebuilt from its last level up, layout kept)."""
    out = None
    for p in reversed(rpl.plan_levels(plan)):
        out = dataclasses.replace(p, aux_plan=out, **{
            f: getattr(p, f).clone() for f in (
                "tile1", "tile3", "val", "slab_base", "y_base", "fused_sb",
                "fused_yb")})
    return out


def route_v1_case(name, a, plan, seed, rates, card):
    """``route_spmv`` on a v1 plan, every level in its one launch,
    against the plain version level by level, per row of the whole
    apply."""
    levels = rpl.plan_levels(plan)
    xin = gen.generate_vector(a.shape[1], seed=seed)
    x2 = rsp.pack_x(plan, xin)
    before = rsp.route_spmv_padded.launches
    y_k = rsp.route_spmv_padded(plan, x2)
    torch.cuda.synchronize()
    per_call = rsp.route_spmv_padded.launches - before
    require(per_call == 1, f"route_spmv {name}: {per_call} launches for "
                           f"{len(levels)} levels")
    err = row_check(y_k, rsp.route_spmv_chain_reference(plan, x2),
                    rsp.route_spmv_chain_reference(dataclasses.replace(
                        plan, val=plan.val.abs()), x2.abs()))
    log(f"[check] route_spmv {name}: in bound, max |err| {err:.3e}")
    # each input read once (tile1, tile3 and values, the per-chunk
    # scalars, the x pane), each output pane written twice (zeroed, then
    # accumulated), over every level
    nbytes = sum(p.nchunks * (12 * 1024 + 8) + p.x_rows * 512
                 + 2 * p.pane_rows * 512 for p in levels)
    nslots = sum(p.nchunks for p in levels) * 1024
    b_ms, b_by = bound(nbytes, 2 * nslots, rates)
    ins = replicas(lambda: (v1_copy(plan), x2.clone()), nbytes)
    k_ms = device_ms(rsp.route_spmv_padded, ins)
    p_ms = device_ms(rsp.route_spmv_chain_reference, ins)
    l_ms = library_ms(a, xin)
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


def race_check(name, run, ref, absdot, times=RACE_RUNS):
    """``run()`` ``times`` times back to back on the card, every result
    held per row against the plain version: a level or launch-range wait
    that lets a chunk read too early shows up as a wrong row."""
    results = [run() for _ in range(times)]
    torch.cuda.synchronize()
    err = max(row_check(y, ref, absdot) for y in results)
    log(f"[race] {name}: {times} runs in bound, max |err| {err:.3e}")
    return err


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
    values in every block row but each ``empty_every``-th (none for 0),
    which stays empty."""
    rng = np.random.default_rng(seed)
    bh, bw = block
    empty = (np.arange(mb) % empty_every == 0 if empty_every
             else np.zeros(mb, bool))
    counts = np.where(empty, 0, per_row)
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


# ------------------------------------------------------------------ #
# SpGEMM: the mul engines and the block SpGEMM
# ------------------------------------------------------------------ #

def mul_hub_stream(n_ent, cap, hubs, a_len, b_len, seed):
    """A slot-sorted expansion stream whose hub slots hold many entries
    (so the packer spills them into aux levels), and seeded A and B
    values on the card (A's last slot is the constant 1)."""
    rng = np.random.default_rng(seed)
    hub = np.concatenate([np.full(c, sl, np.int64) for sl, c in hubs])
    slots = np.sort(np.concatenate([hub, rng.integers(
        0, cap, n_ent - len(hub))]))
    sa = rng.integers(0, a_len - 1, n_ent)
    sb = rng.integers(0, b_len, n_ent)
    a = rng.standard_normal(a_len).astype(np.float32)
    a[-1] = 1.0
    b = rng.standard_normal(b_len).astype(np.float32)
    return (slots, sa, sb, torch.from_numpy(a).to(DEVICE),
            torch.from_numpy(b).to(DEVICE))


def library_spgemm_ms(a, b):
    """cuSPARSE SpGEMM (``@`` on two torch.sparse_csr_tensors): one call
    runs its own symbolic pass (and reads C's size to the host) before
    the numeric one."""
    nbytes = (a.nnz + b.nnz) * 8 + (a.shape[0] + b.shape[0] + 2) * 4

    def copy(t):
        return cusparse(dataclasses.replace(t, values=t.values.clone(),
                                            colind=t.colind.clone()))

    ins = replicas(lambda: (copy(a), copy(b)), nbytes)
    return device_ms(torch.matmul, ins, reps=len(ins))


def mul_case(name, plan, a_arr, b_arr, rates, card, lib_ms=None):
    """``route2_mul`` on a resident mul plan against its plain version."""
    a2, b2 = r2k.pack_mul_panes(plan, a_arr, b_arr)
    before = r2k.route2_mul_padded.launches
    y_k = r2k.route2_mul_padded(plan, a2, b2)
    torch.cuda.synchronize()
    per_call = r2k.route2_mul_padded.launches - before
    require(per_call == sum(hi > lo for lo, hi in plan.launch_ranges()),
            f"route2_mul {name}: {per_call} launches")
    y_p = r2k.route2_mul_reference(plan, a2, b2)
    err = row_check(y_k, y_p, r2k.route2_mul_reference(plan, a2.abs(),
                                                        b2.abs()))
    log(f"[check] route2_mul {name}: in bound, max |err| {err:.3e}")
    del y_k, y_p
    # each input read once (both tiles, the per-chunk scalars ab, bb, yb,
    # the A and B panes), the out pane written twice (zeroed, then
    # accumulated)
    nch = plan.nchunks
    nbytes = (nch * (8 * 1024 + 12) + (plan.a_rows + plan.b_rows) * 512
              + 2 * r2k.mul_out_rows(plan) * 512)
    b_ms, b_by = bound(nbytes, 2 * nch * 1024, rates)

    def copy():
        return dataclasses.replace(
            plan, tile1=plan.tile1.clone(), tile2=plan.tile2.clone(),
            a_base=plan.a_base.clone(), b_base=plan.b_base.clone(),
            y_base=plan.y_base.clone()), a2.clone(), b2.clone()

    ins = replicas(copy, nbytes)
    k_ms = device_ms(r2k.route2_mul_padded, ins)
    p_ms = device_ms(r2k.route2_mul_reference, ins)
    del ins
    torch.cuda.empty_cache()
    return {"kernel": "route2_mul", "case": name, "nchunks": nch,
            "n_aux_chunks": plan.n_aux_chunks,
            "aux_levels": len(plan.launch_starts) - 1, "fill": plan.fill,
            "g_a": plan.g_a, "g_b": plan.g_b, "dist_max": plan.dist_max,
            "capacity": plan.capacity, "launches_per_call": per_call,
            "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
            "bound_by": b_by, "plain_ms": p_ms, "library_ms": lib_ms,
            "card": card}


def mul_paned_case(name, plan, a_arr, b_arr, rates, card, lib_ms=None):
    """``route2_mul_paned`` on every panel of a paned mul plan against
    its plain version, panel by panel."""
    a2, b2 = rmp.pack_mul_panes(plan, a_arr, b_arr)
    before = rmp.route2_mul_paned_padded.launches
    err = 0.0
    for p in plan.panels:
        y_k = rmp.route2_mul_paned_padded(plan, p, a2, b2)
        torch.cuda.synchronize()
        y_p = rmp.route2_mul_paned_reference(plan, p, a2, b2)
        err = max(err, row_check(y_k, y_p, rmp.route2_mul_paned_reference(
            plan, p, a2.abs(), b2.abs())))
        del y_k, y_p
    per_call = rmp.route2_mul_paned_padded.launches - before
    want = sum(hi > lo for p in plan.panels for lo, hi in p.launch_ranges())
    require(per_call == want, f"route2_mul_paned {name}: {per_call} "
                              f"launches, want {want}")
    log(f"[check] route2_mul_paned {name}: in bound, max |err| {err:.3e}")
    # each input read once (both tiles, the per-chunk scalars ab, bb, yb,
    # fl, pane, A and B), each panel pane written twice
    nbytes = (plan.a_rows + plan.b_rows_pad) * 512 + sum(
        p.nchunks * (8 * 1024 + 20) + 2 * p.out_rows * 512
        for p in plan.panels)
    b_ms, b_by = bound(nbytes, 2 * plan.nchunks * 1024, rates)

    def copy():
        return dataclasses.replace(plan, panels=tuple(
            dataclasses.replace(
                p, t1=p.t1.clone(), t2=p.t2.clone(), ab=p.ab.clone(),
                bb=p.bb.clone(), yb=p.yb.clone(), fl=p.fl.clone(),
                pane=p.pane.clone()) for p in plan.panels)), a2.clone(), \
            b2.clone()

    def run_panels(pl, aa, bb, fn=rmp.route2_mul_paned_padded):
        for p in pl.panels:
            fn(pl, p, aa, bb)

    ins = replicas(copy, nbytes)
    k_ms = device_ms(run_panels, ins)
    p_ms = device_ms(lambda pl, aa, bb: run_panels(
        pl, aa, bb, rmp.route2_mul_paned_reference), ins)
    del ins
    torch.cuda.empty_cache()
    return {"kernel": "route2_mul_paned", "case": name,
            "panels": len(plan.panels),
            "panes": plan.b_rows_pad // plan.pane_rows,
            "nchunks": plan.nchunks, "fill": plan.fill, "g_a": plan.g_a,
            "g_b": plan.g_b,
            "aux_levels": max(len(p.launch_starts) - 1 for p in plan.panels),
            "panels_with_aux": sum(p.has_aux for p in plan.panels),
            "launches_per_call": per_call, "max_abs_err": err,
            "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": p_ms, "library_ms": lib_ms, "card": card}


def fill_ms(info, vals, a):
    """Mean time of ``multiply_fill(info, scaled(2.0, A_i), A)`` over the
    distinct values ``vals``, host included (CUDA events around the
    loop)."""
    ops = [sp.scaled(2.0, dataclasses.replace(a, values=v)) for v in vals]
    sp.multiply_fill(info, ops[0], a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for op in ops:
        sp.multiply_fill(info, op, a)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / len(ops)


def engine_kind(route):
    """The SpGEMM engine a compute-time plan carries, by name."""
    return ("resident" if isinstance(route, Route2MulPlan) else
            "paned" if isinstance(route, Route2MulPanedPlan) else
            "v1" if isinstance(route, rml.RouteMulPlan) else None)


def spgemm_main(name, a, kind, expect, rates, card, deferred):
    """``info = multiply_compute(A, A)`` then ``multiply_fill(info,
    scaled(2.0, A_i), A)`` on distinct values: counts read around the
    compute and the first fill, C held per entry against the port's
    float64 torch numeric, result_nnz against cuSPARSE's, then the fills
    timed.  The symbolic and engine-build seconds are reported apart.
    Differences from the JAX records' structure numbers go to
    ``deferred`` (reported at the end)."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(len(name))
    vals = [torch.rand(a.capacity, generator=g, device=DEVICE) * 2 - 1
            for _ in range(SPGEMM_FILLS)]
    build = {}
    orig = spgemm_ops._try_build_route

    def timed_build(*args, **kw):
        t = time.perf_counter()
        try:
            return orig(*args, **kw)
        finally:
            build["s"] = time.perf_counter() - t

    for w in WRAPPERS.values():
        w.launches = 0
    a0 = dataclasses.replace(a, values=vals[0])
    spgemm_ops._try_build_route = timed_build
    try:
        t0 = time.perf_counter()
        info = sp.multiply_compute(a, a)
        torch.cuda.synchronize()
        compute_s = time.perf_counter() - t0
    finally:
        spgemm_ops._try_build_route = orig
    t0 = time.perf_counter()
    c = sp.multiply_fill(info, sp.scaled(2.0, a0), a)
    torch.cuda.synchronize()
    first_fill_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    route = info.plan.route
    got = engine_kind(route)
    nnz = info.result_nnz
    log(f"[main] {name}: engine {got}, result_nnz {nnz}, launches "
        f"{launches}")
    require(got == kind, f"{name}: engine {got!r}, want {kind!r}")
    require(c.nnz == nnz and c.values.dtype == a.dtype
            and bool(torch.isfinite(c.values[:nnz]).all()),
            f"{name}: bad result")
    # reference: the port's torch numeric in float64 (f64 values take it)
    a64 = dataclasses.replace(a, values=a.values.double())
    ref = sp.multiply_fill(info, sp.scaled(2.0, dataclasses.replace(
        a0, values=a0.values.double())), a64)
    absd = sp.multiply_fill(info, dataclasses.replace(
        a0, values=a0.values.abs().double()), dataclasses.replace(
        a64, values=a64.values.abs()))
    err = row_check(c.values[:nnz], ref.values[:nnz], absd.values[:nnz],
                    scale=2.0)
    del ref, absd, c
    lib_nnz = int((cusparse(a) @ cusparse(a))._nnz())
    require(lib_nnz == nnz, f"{name}: result_nnz {nnz}, cuSPARSE {lib_nnz}")
    ms = fill_ms(info, vals, a)
    plain = info.update(plan=dataclasses.replace(info.plan, route=None))
    numeric_ms = fill_ms(plain, vals, a)
    lib_ms = library_spgemm_ms(a, a)
    build_s = build.get("s", 0.0)
    panels = len(route.panels) if got == "paned" else None
    rec = {"main_path": name, "op": "spgemm", "kind": got,
           "m": a.shape[0], "n": a.shape[1], "nnz": a.nnz,
           "result_nnz": nnz, "cusparse_nnz": lib_nnz,
           "chunks": route.nchunks, "panels": panels, "fill": route.fill,
           "launches": launches,
           "launches_per_fill": launches["route2_mul"]
           + launches["route2_mul_paned"] + launches["route_mul"],
           "max_abs_err_vs_f64": err, "compute_s": compute_s,
           "symbolic_s": compute_s - build_s, "engine_build_s": build_s,
           "first_fill_s": first_fill_s, "fill_ms": ms,
           "torch_numeric_ms": numeric_ms,
           "cusparse_spgemm_ms_with_symbolic": lib_ms,
           "fills_timed": SPGEMM_FILLS, "card": card}
    emit(rec)
    for key, want in expect.items():
        have = {"result_nnz": nnz, "chunks": route.nchunks,
                "panels": panels}[key]
        if have != want:
            deferred.append(f"{name}: {key} {have}, JAX record {want}")
    return rec, info, vals[0]


def bsr_spgemm_case(name, a, b, rates, card, dtype=torch.float32):
    """``bsr_spgemm`` on one block product against its plain version."""
    plan = bsg.bsr_spgemm_compute(a, b)
    av = a.values.to(dtype).contiguous()
    bv = b.values.to(dtype).contiguous()
    args = (plan.pair_ptr, plan.pair_a, plan.pair_b)
    c_k = bsg.bsr_spgemm_blocks(*args, av, bv)
    torch.cuda.synchronize()
    c_p = bsg.bsr_spgemm_reference(*args, av, bv)
    err = row_check(c_k, c_p, bsg.bsr_spgemm_reference(*args, av.abs(),
                                                        bv.abs()))
    tname = str(dtype).split(".")[-1]
    log(f"[check] bsr_spgemm {name} {tname}: in bound, max |err| "
        f"{err:.3e}")
    del c_k, c_p
    bh, bk_ = a.block_shape
    bw = b.block_shape[1]
    esz = av.element_size()
    npairs = plan.npairs
    # the stored A and B blocks, the pair lists and C, each once
    nbytes = ((a.nnz_blocks * bh * bk_ + b.nnz_blocks * bk_ * bw
               + plan.nnzb_c * bh * bw) * esz + npairs * 8
              + (plan.nnzb_c + 1) * 4)
    flops = 2 * npairs * bh * bk_ * bw
    # the f32 peak bounds the f32 case, the f64 peak the f64 one
    b_ms, b_by = bound(nbytes, flops, rates, f64=dtype == torch.float64)
    ins = replicas(lambda: args + (av.clone(), bv.clone()), nbytes)
    k_ms = device_ms(bsg.bsr_spgemm_blocks, ins, reps=10)
    p_ms = device_ms(bsg.bsr_spgemm_reference, ins[:1], reps=2)
    del ins
    torch.cuda.empty_cache()
    l_ms = None
    if dtype == torch.float32:
        # cuSPARSE SpGEMM on the two CSR forms, its symbolic pass included
        # (a yardstick only: where it needs more than the card holds, the
        # record says so)
        try:
            l_ms = library_spgemm_ms(bsr_to_csr(a), bsr_to_csr(b))
        except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
            log(f"[library] bsr_spgemm {name}: cuSPARSE SpGEMM failed "
                f"({str(e).splitlines()[0][:160]})")
        torch.cuda.empty_cache()
    # the f32 case carries the main path's name (and its launch count)
    return {"kernel": "bsr_spgemm",
            "case": name if dtype == torch.float32 else f"{name}_{tname}",
            "m": a.shape[0], "k": a.shape[1], "n": b.shape[1],
            "blocks": [bh, bk_, bw], "nnzb_a": a.nnz_blocks,
            "nnzb_b": b.nnz_blocks, "nnzb_c": plan.nnzb_c,
            "pairs": npairs,
            "empty_block_rows": int((a.block_rowptr[1:]
                                     == a.block_rowptr[:-1]).sum()),
            "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
            "bound_by": b_by, "plain_ms": p_ms, "library_ms": l_ms,
            "flop_s": flops / (k_ms * 1e-3), "card": card}


def bsr_spgemm_main(name, a, b, card):
    """``multiply(scaled(2.0, A), B)`` on two BSR operands: counts read
    around the first call, C held per entry against the float64 plain
    sums, then 20 calls over distinct A values timed, host (the block
    symbolic phase) included."""
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    c = sp.multiply(sp.scaled(2.0, a), b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    log(f"[main] {name}: launches {launches}")
    require(isinstance(c, BSR) and c.shape == (a.shape[0], b.shape[1])
            and c.dtype == a.dtype
            and bool(torch.isfinite(c.values).all()), f"{name}: bad result")
    plan = bsg.bsr_spgemm_compute(a, b)
    args = (plan.pair_ptr, plan.pair_a, plan.pair_b)
    nc = plan.nnzb_c
    require(c.nnz_blocks == nc, f"{name}: {c.nnz_blocks} C blocks")
    ref = bsg.bsr_spgemm_reference(*args, a.values.double(),
                                   b.values.double())
    absd = bsg.bsr_spgemm_reference(*args, a.values.abs().double(),
                                    b.values.abs().double())
    np.testing.assert_array_equal(c.block_colind[:nc].cpu().numpy(),
                                  plan.c_colind.cpu().numpy())
    err = row_check(c.values[:nc], 2.0 * ref, absd, scale=2.0)
    del ref, absd, c
    torch.cuda.empty_cache()
    ops = [sp.scaled(2.0, dataclasses.replace(a, values=a.values * s))
           for s in (1.0, -0.5, 0.25, 2.0)]
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    reps = 20
    e0.record()
    for i in range(reps):
        sp.multiply(ops[i % len(ops)], b)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    bh, bk_ = a.block_shape
    rec = {"main_path": name, "op": "spgemm", "kind": "bsr",
           "m": a.shape[0], "k": a.shape[1], "n": b.shape[1],
           "blocks": [bh, bk_, b.block_shape[1]], "nnzb_c": nc,
           "pairs": plan.npairs, "launches": launches,
           "max_abs_err_vs_f64": err, "first_call_s": first_s, "ms": ms,
           "flop_s": 2 * plan.npairs * bh * bk_ * b.block_shape[1]
           / (ms * 1e-3), "card": card}
    emit(rec)
    return rec


def spgemm_phase(rates, card):
    """The SpGEMM main paths and their kernels; returns (main-path
    records, kernel records, deferred structure differences)."""
    main, recs, deferred = [], [], []
    for name, make, kind, expect in SPGEMM_MAIN:
        a = make()
        rec, info, a0_vals = spgemm_main(name, a, kind, expect, rates,
                                         card, deferred)
        main.append(rec)
        a_arr = torch.cat([2.0 * a0_vals, a0_vals.new_ones(1)])
        case = mul_case if kind == "resident" else mul_paned_case
        recs.append(case(name, info.plan.route, a_arr, a.values, rates,
                         card, rec["cusparse_spgemm_ms_with_symbolic"]))
        del info, a
        torch.cuda.empty_cache()
    n_ent, cap, hubs, a_len, b_len, seed = MUL_HUB
    slots, sa, sb, av, bv = mul_hub_stream(n_ent, cap, hubs, a_len, b_len,
                                           seed)
    plan = route2.build_route2_mul_plan(slots, sa, sb, a_len, b_len, cap,
                                        device=DEVICE)
    recs.append(mul_case("hub_slots_aux", plan, av, bv, rates, card))
    require(recs[-1]["aux_levels"] > 1,
            "route2_mul hub fixture has fewer than two aux levels")
    n_ent, cap, hubs, a_len, b_len, seed, kw = MUL_PANED_HUB
    slots, sa, sb, av, bv = mul_hub_stream(n_ent, cap, hubs, a_len, b_len,
                                           seed)
    plan = rmp.build_route2_mul_paned_plan(slots, sa, sb, a_len, b_len,
                                           cap, device=DEVICE, **kw)
    recs.append(mul_paned_case("hub_slots_paned", plan, av, bv, rates,
                               card))
    require(recs[-1]["panels"] > 1 and recs[-1]["panes"] > 1
            and recs[-1]["panels_with_aux"] > 1,
            "route2_mul_paned hub fixture misses panels, panes or aux")
    del plan, slots, sa, sb, av, bv
    name, sa_args, sb_args = BSR_SPGEMM_MAIN
    a, b = random_bsr(*sa_args), random_bsr(*sb_args)
    main.append(bsr_spgemm_main(name, a, b, card))
    recs.append(bsr_spgemm_case(name, a, b, rates, card))
    recs.append(bsr_spgemm_case(name, a, b, rates, card, torch.float64))
    del a, b
    name, sa_args, sb_args = BSR_SPGEMM_ONLY
    a, b = random_bsr(*sa_args), random_bsr(*sb_args)
    recs.append(bsr_spgemm_case(name, a, b, rates, card))
    require(recs[-1]["empty_block_rows"] > 0,
            "bsr_spgemm kernel case has no empty block row")
    del a, b
    torch.cuda.empty_cache()
    return main, recs, deferred


def route_mul_case(name, plan, a_arr, b_arr, rates, card, lib_ms=None):
    """``route_mul`` (the ROUTE v1 SpGEMM numeric) on a plan against its
    plain version."""
    a2 = rmk.pad_pane(a_arr, plan.a_rows)
    b2 = rmk.pad_pane(b_arr, plan.b_rows)
    y_k = rmk.route_mul_padded(plan, a2, b2)
    torch.cuda.synchronize()
    y_p = rmk.route_mul_reference(plan, a2, b2)
    err = row_check(y_k, y_p, rmk.route_mul_reference(plan, a2.abs(),
                                                      b2.abs()))
    log(f"[check] route_mul {name}: in bound, max |err| {err:.3e}")
    del y_k, y_p
    ob = plan.o_base.long()
    per_window = int(torch.bincount(ob).max())
    # each input read once (three tiles, the per-chunk scalars ab, bb,
    # ob, the A and B panes), the out pane written twice (zeroed, then
    # accumulated)
    nch = plan.nchunks
    nbytes = (nch * (12 * 1024 + 12) + (plan.a_rows + plan.b_rows) * 512
              + 2 * plan.out_rows * 512)
    b_ms, b_by = bound(nbytes, 2 * nch * 1024, rates)

    def copy():
        return dataclasses.replace(
            plan, tile1=plan.tile1.clone(), tile2=plan.tile2.clone(),
            tile3=plan.tile3.clone(), a_base=plan.a_base.clone(),
            b_base=plan.b_base.clone(), o_base=plan.o_base.clone()), \
            a2.clone(), b2.clone()

    ins = replicas(copy, nbytes)
    k_ms = device_ms(rmk.route_mul_padded, ins)
    p_ms = device_ms(rmk.route_mul_reference, ins)
    del ins
    torch.cuda.empty_cache()
    return {"kernel": "route_mul", "case": name, "nchunks": nch,
            "fill": plan.fill, "g_a": plan.g_a, "g_b": plan.g_b,
            "capacity": plan.capacity, "max_chunks_per_window": per_window,
            "launches_per_call": 1, "max_abs_err": err, "kernel_ms": k_ms,
            "bound_ms": b_ms, "bound_by": b_by, "plain_ms": p_ms,
            "library_ms": lib_ms, "card": card}


def v1_phase(rates, card):
    """The SpGEMM main path on the ROUTE v1 engine (bench.py's 2k A.A
    under SPBLAS_ROUTE_SPGEMM=1) and its kernel, then the kernel on a
    heavily overlapping stream; returns (main record, kernel records,
    deferred structure differences)."""
    import os
    deferred = []
    name, make, expect = V1_MAIN
    a = make()
    os.environ["SPBLAS_ROUTE_SPGEMM"] = "1"
    try:
        rec, info, a0_vals = spgemm_main(name, a, "v1", expect, rates,
                                         card, deferred)
    finally:
        del os.environ["SPBLAS_ROUTE_SPGEMM"]
    a_arr = torch.cat([2.0 * a0_vals, a0_vals.new_ones(1)])
    recs = [route_mul_case(name, info.plan.route, a_arr, a.values, rates,
                           card, rec["cusparse_spgemm_ms_with_symbolic"])]
    del info, a
    oname, (n_slots, dup, a_len, b_len, seed) = V1_OVERLAP
    rng = np.random.default_rng(seed)
    slots = np.repeat(np.arange(n_slots), rng.poisson(dup, n_slots) + 1)
    sa = rng.integers(0, a_len, len(slots))
    sb = rng.integers(0, b_len, len(slots))
    t0 = time.perf_counter()
    plan = rml.build_route_mul_plan(slots, sa, sb, a_len, b_len, n_slots,
                                    device=DEVICE)
    log(f"[build] route_mul {oname}: {plan.nchunks} chunks in "
        f"{time.perf_counter() - t0:.1f} s")
    av = torch.from_numpy(rng.standard_normal(a_len).astype(np.float32))
    bv = torch.from_numpy(rng.standard_normal(b_len).astype(np.float32))
    recs.append(route_mul_case(oname, plan, av.to(DEVICE), bv.to(DEVICE),
                               rates, card))
    require(recs[-1]["nchunks"] > 10_000
            and recs[-1]["max_chunks_per_window"] > 100,
            "route_mul overlap case has too few chunks or overlaps")
    return rec, recs, deferred


def abs_csr(a, dtype=torch.float64, diag_sign=1.0):
    """``a`` with |values| in ``dtype``; ``diag_sign`` -1 negates the
    off-diagonal ones (the comparison matrix of a triangular factor)."""
    v = a.values.abs().to(dtype)
    if diag_sign != 1.0:
        on = a.colind.long() == a.row_ids().long()
        v = torch.where(on, v, -v)
    return dataclasses.replace(a, values=v)


def trsv_checks(a, info, x, b, alpha):
    """The solve ``x`` of (alpha A) x = b held, per row and in float64,
    to the componentwise backward error |alpha A x - b| <= 64 eps_f32
    (|alpha| |A| |x| + |b|), and to the forward error that bound implies
    against the float64 ragged sweep: |x - x64| <= M^{-1} lim, M the
    comparison matrix (|diagonal|, -|off-diagonal|), whose inverse bounds
    |A^{-1}| for a triangular A.  Returns (backward ratio, max |x -
    x64|)."""
    a64 = dataclasses.replace(a, values=a.values.double())
    x64h, b64 = x.double(), b.double()
    r = (alpha * sp.multiply(a64, x64h) - b64).abs()
    lim = 64 * EPS32 * (abs(alpha) * sp.multiply(abs_csr(a), x64h.abs())
                        + b64.abs())
    bad = int((r > lim).sum())
    require(bad == 0, f"{bad} rows past the backward bound 64 eps (|a||A|"
                      f"|x| + |b|) (max ratio {float((r / lim).max()):.3f})")
    x64 = sp.triangular_solve(sp.scaled(alpha, a64), b64, info=info)
    fwd = sp.triangular_solve(sp.scaled(abs(alpha), abs_csr(
        a, diag_sign=-1.0)), lim, info=info)
    err = (x64h - x64).abs()
    bad = int((err > fwd).sum())
    require(bad == 0, f"{bad} rows past the forward bound against the "
                      f"float64 sweep (max err {float(err.max()):.3e})")
    return float((r / lim).max()), float(err.max())


def solve_pane(plan, y0):
    rows = r2k.solve_pane_rows(plan)
    return torch.nn.functional.pad(
        y0.float(), (0, rows * 128 - y0.shape[0])).contiguous()


def route2_solve_case(name, a, info, b, rates, card, lib_ms):
    """``route2_solve`` (the solve mode of route2_spmv.cu) on the main
    path's plan against its plain version, level by level: the two may
    differ per row by twice (I - |C|)^{-1} 64 eps (|y0| + |C| |x|), C
    the baked coefficients -a_ij/d_i, since both round each level's sums
    and feed them to the next."""
    plan = info.plan.route
    d = a.values[info.plan.route_diag.long()]
    pane = solve_pane(plan, b / d)
    before = r2k.route2_solve_padded.launches
    x_k = r2k.route2_solve_padded(plan, pane)
    torch.cuda.synchronize()
    per_call = r2k.route2_solve_padded.launches - before
    require(per_call == len(r2k.solve_ranges(plan)),
            f"route2_solve {name}: {per_call} launches")
    # the plain version is host-bound (one Python step per level): one
    # call, timed with events, is its time
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    x_p = r2k.route2_solve_reference(plan, pane)
    e1.record()
    torch.cuda.synchronize()
    p_ms = e0.elapsed_time(e1)
    m = a.shape[0]
    xp = x_p.view(-1)[:m]
    off = abs_csr(a, torch.float32)
    off = dataclasses.replace(off, values=torch.where(
        a.colind.long() == a.row_ids().long(), 0.0, off.values))
    cx = sp.multiply(off, xp.abs()) / d.abs()
    z = r2k.route2_solve_reference(dataclasses.replace(
        plan, val=plan.val.abs()), solve_pane(
        plan, 64 * EPS32 * (pane[:m].abs() + cx)))
    err_v = (x_k - x_p).abs().view(-1)[:m].double()
    lim = 2 * z.view(-1)[:m].double()
    bad = int((err_v > lim).sum())
    require(bad == 0, f"route2_solve {name}: {bad} rows past the bound")
    err = float(err_v.max())
    log(f"[check] route2_solve {name}: in bound, max |err| {err:.3e}")
    del x_k, x_p, z
    # each input read once (tile and values, the per-chunk scalars, y0),
    # x written once
    nch = plan.nchunks
    rows = r2k.solve_pane_rows(plan)
    nbytes = nch * (8 * 1024 + 12) + 2 * rows * 512
    b_ms, b_by = bound(nbytes, 2 * nch * 1024, rates)
    panes = [solve_pane(plan, gen.generate_vector(m, seed=300 + i) / d)
             for i in range(4)]
    ins = [(plan, p) for p in panes]
    k_ms = device_ms(r2k.route2_solve_padded, ins, reps=8)
    return {"kernel": "route2_solve", "case": name, "m": m,
            "nchunks": nch, "levels": info.plan.num_levels,
            "launch_ranges": len(plan.launch_starts),
            "n_aux_chunks": plan.n_aux_chunks, "fill": plan.fill,
            "g": plan.g, "launches_per_call": per_call,
            "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
            "bound_by": b_by, "plain_ms": p_ms, "library_ms": lib_ms,
            "card": card}


def library_trsv_ms(a, b):
    """torch.triangular_solve on a sparse-CSR A (cuSPARSE's SpSV, its
    analysis inside every call), timed as a yardstick; None with the
    reason when the installed torch refuses it."""
    def copy():
        return (b[:, None].clone(), cusparse(dataclasses.replace(
            a, values=a.values.clone())))

    try:
        ins = replicas(copy, a.nnz * 8 + a.shape[0] * 8)
        ms = device_ms(lambda bb, aa: torch.triangular_solve(
            bb, aa, upper=False), ins, reps=len(ins))
        return ms, None
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e)[:200]}"


def trsv_main(name, a, kind, levels, rates, card):
    """``info = triangular_solve_inspect(A)`` then ``triangular_solve(
    scaled(2.0, A), b, info=info)``: counts read around the first solve,
    the solve held to the backward and forward bounds, 20 solves on
    distinct b timed end to end; then the kernel on the main path's own
    plan."""
    m = a.shape[0]
    t0 = time.perf_counter()
    info = sp.triangular_solve_inspect(a)
    torch.cuda.synchronize()
    inspect_s = time.perf_counter() - t0
    plan = info.plan
    if kind == "route":
        require(plan.route is not None, f"{name}: no route solve plan")
    else:
        require(plan.route is None and plan.blocked is not None
                and all(s.route is not None for s in plan.blocked.subs),
                f"{name}: not the blocked solve over route plans")
    if levels is not None:
        require(plan.num_levels == levels,
                f"{name}: {plan.num_levels} levels, want {levels}")
    bs = [gen.generate_vector(m, seed=200 + i) for i in range(4)]
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    x = sp.triangular_solve(sp.scaled(2.0, a), bs[0], info=info)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    log(f"[main] {name}: {kind}, {plan.num_levels} levels, launches "
        f"{launches}")
    require(x.shape == (m,) and x.dtype == torch.float32
            and bool(torch.isfinite(x).all()), f"{name}: bad result")
    ratio, fwd_err = trsv_checks(a, info, x, bs[0], 2.0)
    del x
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()                 # end to end: host overhead included
    for i in range(TRSV_SOLVES):
        sp.triangular_solve(sp.scaled(2.0, a), bs[i % 4], info=info)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / TRSV_SOLVES
    lib_ms, lib_why = library_trsv_ms(a, bs[0])
    subs = [plan.route] if kind == "route" else [
        s.route for s in plan.blocked.subs]
    rec = {"main_path": name, "op": "trsv", "kind": kind, "m": m,
           "nnz": a.nnz, "levels": plan.num_levels,
           "chunks": sum(r.nchunks for r in subs),
           "launch_ranges": sum(len(r.launch_starts) for r in subs),
           "launches": launches,
           "launches_per_solve": launches["route2_solve"],
           "backward_ratio": ratio, "max_abs_err_vs_f64": fwd_err,
           "inspect_s": inspect_s, "first_solve_s": first_s, "ms": ms,
           "rows_s": m / (ms * 1e-3),
           "ms_per_1k_levels": ms / (plan.num_levels / 1e3),
           "cusparse_trsv_ms_with_analysis": lib_ms,
           "cusparse_note": lib_why, "solves_timed": TRSV_SOLVES,
           "card": card}
    emit(rec)
    kern = None
    if kind == "route":
        kern = route2_solve_case(name, a, info, bs[0], rates, card, lib_ms)
    return rec, kern


def trsv_phase(rates, card):
    """The SpTRSV main paths and the solve kernel; returns (main-path
    records, kernel records)."""
    main, recs = [], []
    for name, make, kind, levels in TRSV_MAIN:
        a = make()
        rec, kern = trsv_main(name, a, kind, levels, rates, card)
        main.append(rec)
        if kern is not None:
            recs.append(kern)
        del a
        torch.cuda.empty_cache()
    return main, recs


def diag_band(m, half, seed):
    """The bench's device band: 2*half + 1 diagonals of U[0.1, 1) /
    (0.55 * ndiag), zero out of range, made on the card; returns the
    diagonals, the offsets and the same matrix as a CSR on the card."""
    offsets = tuple(range(-half, half + 1))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    d = (torch.rand(len(offsets), m, generator=g, device=DEVICE) * 0.9
         + 0.1) / (0.55 * len(offsets))
    i = torch.arange(m, device=DEVICE)[None, :]
    o = torch.tensor(offsets, device=DEVICE)[:, None]
    inside = (i + o >= 0) & (i + o < m)
    d = torch.where(inside, d, 0.0)
    rows = i.expand(len(offsets), m)[inside]
    cols = (i + o)[inside]
    vals = d[inside]
    order = torch.argsort(rows * m + cols)
    rowptr = torch.zeros(m + 1, dtype=torch.int64, device=DEVICE)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    csr = CSR.from_arrays(vals[order], rowptr, cols[order], (m, m),
                          nnz=int(vals.numel()), device=DEVICE)
    return d, offsets, csr


def power_phase(rates, card):
    """``band_power_iterations`` on the headline band laid out on the
    card by ``band_plan_from_diags``: its panels against
    ``build_band_plan``'s on the same matrix, ``band_spmv`` on the plan
    against its plain version, then the power chain (counts read around
    it) against 10 chained plain steps, per row within iters * 64 eps
    (|A|^iters |x|); returns (main record, kernel records)."""
    name, m, half, iters = POWER_MAIN
    d, offsets, csr = diag_band(m, half, 121)
    t0 = time.perf_counter()
    plan = banded.band_plan_from_diags(d, offsets, (m, m))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hp = banded.build_band_plan(csr)
    require(hp.pad_l == plan.pad_l and torch.equal(hp.panels, plan.panels),
            f"{name}: from-diags panels differ from build_band_plan's")
    del hp, d
    spmv_rec = band_case(f"{name}_from_diags", m, m, 2 * half, None, 122,
                         rates, card, csr=csr, plan=plan)
    x = gen.generate_vector(m, seed=123)
    xp = banded.pad_x(plan, x)
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    y = banded.band_power_iterations(plan, x, iters)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    log(f"[main] {name}: launches {launches}")
    require(y.shape == (m,) and y.dtype == torch.float32
            and bool(torch.isfinite(y).all()), f"{name}: bad result")
    h = plan.pad_l
    y_p = banded.band_power_reference(plan.panels, xp, iters, h)[h:h + m]
    absd = banded.band_power_reference(plan.panels.abs(), xp.abs(), iters,
                                       h)[h:h + m]
    err = row_check(y, y_p, iters * absd)
    log(f"[check] band_power {name}: in bound, max |err| {err:.3e}")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    xs = [gen.generate_vector(m, seed=124 + i) for i in range(4)]
    e0.record()                 # end to end: host overhead included
    for i in range(20):
        banded.band_power_iterations(plan, xs[i % 4], iters)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 20
    nnz = csr.nnz
    main = {"main_path": name, "op": "power", "kind": "band", "m": m,
            "nnz": nnz, "iters": iters, "width": plan.width,
            "launches": launches, "max_abs_err_vs_plain": err,
            "plan_build_s": build_s, "first_call_s": first_s, "ms": ms,
            "nnz_s": iters * nnz / (ms * 1e-3), "card": card}
    emit(main)
    # the kernel: iters band SpMVs' bytes and flops
    nbytes = iters * (plan.panels.numel() * 4 + xp.numel() * 4 + m * 4)
    b_ms, b_by = bound(nbytes, iters * 2 * plan.panels.numel(), rates)
    ins = replicas(lambda: (plan.panels.clone(), xp.clone(), iters, h),
                   plan.panels.numel() * 4)
    k_ms = device_ms(banded.band_power_padded, ins)
    p_ms = device_ms(banded.band_power_reference, ins[:2], reps=4)
    lib_ms = iters * spmv_rec["library_ms"]
    del ins
    torch.cuda.empty_cache()
    rec = {"kernel": "band_power", "case": name, "m": m, "iters": iters,
           "width": plan.width, "nnz": nnz, "max_abs_err": err,
           "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
           "plain_ms": p_ms, "library_ms": lib_ms,
           "nnz_s": iters * nnz / (k_ms * 1e-3), "card": card}
    return main, [spmv_rec, rec]


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
    rmat_v1 = rpl.build_route_plan(rmat.rowptr, rmat.colind, rmat.values,
                                   rmat.shape, rmat.nnz, device=rmat.device)
    v1_recs = [route_v1_case(f"{n}_v1", a, p, 71 + i, rates, card)
               for i, (n, a, p) in enumerate((
                   (RMAT_MAIN[0], rmat, rmat_v1),
                   (ROUTE_MAIN[0][0], u300, rpl.build_route_plan(
                       u300.rowptr, u300.colind, u300.values, u300.shape,
                       u300.nnz, device=u300.device))))]
    require(v1_recs[0]["levels"] > 1 and v1_recs[0]["hot_cols"] > 0,
            "route_spmv R-MAT plan has no aux level or hot column")
    # paned ROUTE2 at small panels and panes, hub rows for aux levels
    hub_paned = rpn.build_route_paned_plan(
        hubbed.rowptr, hubbed.colind, hubbed.values, hubbed.shape,
        hubbed.nnz, device=hubbed.device, **PANED_SMALL)
    paned_recs = [paned_case("uniform_300k_hub_rows_paned", hubbed,
                             hub_paned, 73, rates, card)]
    require(paned_recs[0]["panels"] > 1 and paned_recs[0]["panes"] > 1
            and paned_recs[0]["aux_levels"] > 0,
            "route_paned_spmv small plan misses panels, panes or aux")
    # race checks: the v1 levels' done-counter waits, the paned aux
    # levels' launch order, each run back to back and every result held
    x2 = rsp.pack_x(rmat_v1, gen.generate_vector(rmat.shape[1], seed=78))
    race_check(f"route_spmv {RMAT_MAIN[0]}_v1",
               lambda: rsp.route_spmv_padded(rmat_v1, x2),
               rsp.route_spmv_chain_reference(rmat_v1, x2),
               rsp.route_spmv_chain_reference(dataclasses.replace(
                   rmat_v1, val=rmat_v1.val.abs()), x2.abs()))
    xh = gen.generate_vector(hubbed.shape[1], seed=79)
    x2 = rpn.pack_x2(hub_paned, xh)

    def paned_plain(plan, xx):
        return torch.cat([rpn.route_paned_spmv_reference(plan, p, xx)
                          .view(-1)[:p.rows] for p in plan.panels])

    race_check("route_paned_spmv uniform_300k_hub_rows_paned",
               lambda: rpn.route_paned_spmv(hub_paned, xh),
               paned_plain(hub_paned, x2),
               paned_plain(dataclasses.replace(hub_paned, panels=tuple(
                   dataclasses.replace(p, val=p.val.abs())
                   for p in hub_paned.panels)), x2.abs()))
    del hubbed, hub_paned, rmat_v1, x2

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
    torch.cuda.empty_cache()
    # SpGEMM: the two-phase main paths on the mul engines, the block
    # SpGEMM through multiply, and their kernels
    spgemm_main_recs, spgemm_recs, deferred = spgemm_phase(rates, card)
    main += spgemm_main_recs
    # the ROUTE v1 SpGEMM engine, the band power chain, and SpTRSV
    rec, v1_recs_mul, v1_deferred = v1_phase(rates, card)
    main.append(rec)
    deferred += v1_deferred
    rec, power_recs = power_phase(rates, card)
    main.append(rec)
    trsv_main_recs, solve_recs = trsv_phase(rates, card)
    main += trsv_main_recs
    tables = {"spmm": SPMM_KIND_KERNELS, "spgemm": SPGEMM_KIND_KERNELS,
              "trsv": TRSV_KIND_KERNELS, "power": POWER_KIND_KERNELS}
    for r in main:
        table = tables.get(r.get("op"), KIND_KERNELS)
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
              + v1_recs + paned_recs + spmm_band_recs + bsr_recs
              + spgemm_recs + v1_recs_mul + power_recs + solve_recs):
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
             band_recs[len(BAND_CASES)], band_recs + power_recs[:1]),
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
        line("route2_mul", MUL_SOURCE, MUL_REPLACES,
             of(spgemm_recs, "route2_mul", SPGEMM_MAIN[0][0])[0],
             of(spgemm_recs, "route2_mul")),
        line("route2_mul_paned", MUL_PANED_SOURCE, MUL_PANED_REPLACES,
             of(spgemm_recs, "route2_mul_paned", SPGEMM_MAIN[1][0])[0],
             of(spgemm_recs, "route2_mul_paned")),
        line("bsr_spgemm", BSR_SPGEMM_SOURCE, BSR_SPGEMM_REPLACES,
             of(spgemm_recs, "bsr_spgemm", BSR_SPGEMM_MAIN[0])[0],
             of(spgemm_recs, "bsr_spgemm")),
        line("route_mul", V1_MUL_SOURCE, V1_MUL_REPLACES,
             of(v1_recs_mul, "route_mul", V1_MAIN[0])[0],
             of(v1_recs_mul, "route_mul")),
        line("band_power", POWER_SOURCE, POWER_REPLACES,
             of(power_recs, "band_power")[0], of(power_recs, "band_power")),
        line("route2_solve", SOLVE_SOURCE, SOLVE_REPLACES,
             of(solve_recs, "route2_solve", TRSV_MAIN[1][0])[0],
             of(solve_recs, "route2_solve")),
    ]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    require(not deferred, "; ".join(deferred))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(run())

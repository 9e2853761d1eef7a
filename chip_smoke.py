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
uniform 4M degree-10 matrix, the 300k matrix held in float64, a
131,072^2 matrix of half-full 8x128 blocks and the headline band under a
random symmetric permutation.  SpMM cells: the headline band at k = 256,
uniform 100k degree 10 at k = 256 and 64, the block matrix at k = 256,
the permuted band at k = 64, the stencil at k = 64, a complex64 band at
k = 32 and a band at k = 8 (its B within the resident switch).  SpGEMM
cells: bench.py's 2k and 100k A.A products (the ROUTE2-mul engines), the
2k one again on the ROUTE v1 engine, and a BSR.BSR product.  The
headline band laid out on the card from random diagonals runs 10 power
iterations.  SpTRSV cells: bench.py's 20k triangular factor and its
1M-row 15,625-level chain, and a 1.2M-row chain that takes the blocked
solve.  The sparse algebra ops (torch ops) feed the kernels through
``matrix_opt``: ``transpose`` of the uniform 1M matrix (the lazy flip's
bits, a host lexsort's structure) on the ROUTE2 kernel; the headline band
minus 0.5 I by ``add`` (A's structure, fl(a_ii - 0.5) on the diagonal) on
the band kernel; a two-phase union add of two uniform 1M matrices (the
host union's structure, each entry within 64*eps*(|alpha a| + |beta b|)
of the float64 sum, 10 fills bit-equal, and so on an operand whose COO
entries come three to a slot); a hypersparse DCSR (2^21 rows, 2^20
entries) on its base path and on the kind the chooser gives it; an ELL
plan of the uniform 300k matrix (SpMV, SpMM at k = 64, refreshed values
bit-equal to a fresh plan).  Phase F, after them: ``solvers.cg`` on the
symmetrised headline band (S = (A + A^T) / 2 + sigma I, built by
``transpose``, ``scale`` and ``add``, sigma from the power method's
estimate of the spectrum, for a condition number near 10) and on the
symmetrised 1000^2 stencil (so also strictly diagonally dominant), ``jacobi`` on the stencil's operator and ``power_method`` on
the band's, each SpMV on the plan's kernel (launches counted), each held
to float64; ``band_spmv_ad`` on the headline band (the forward on the
band kernel, the gradients against a float64 backward); the five
``data/*.mtx.gz`` files through ``load_matrix_market`` and the SpMV main
path; one SpGEMM and one SpTRSV plan through ``save_plan``/``load_plan``.
Phase D, last, drives the distribution layer (``spblas_tpu_torch.parallel``):
an NCCL world of one rank in this process runs bench.py's distributed
cell (the 100k A.A product: ``dist_spgemm_compute``, then 20
``dist_spgemm_numeric`` reuses on distinct values, one slot fill each,
each C held per entry to one card's ``multiply_fill``, 10 for the same
bits) and ``dist_plan_spmv`` on the headline band and uniform 1M; a gloo
world of four ranks sharing the card (``parallel/launch.py``), every
collective staged through the host, runs the headline band's halo SpMV
and SpMM at k = 64, uniform 1M through per-rank ROUTE2 plans, the 100k
engine, the 20k triangular solve and a union add of two uniform 300k
matrices; every rank must launch its kernels, rank 0 holds the gathered
result to one card's path, and ``[dist]`` lines give each rank's kernel
ms, the slowest rank's call ms and the bytes staged.

The ROUTE v1 kernel runs every level of a plan in one launch, ordered by
device counters, and the paned and resident ROUTE2 kernels one launch
per aux level: each runs 50 times back to back on a plan with aux
levels, every result checked (a wait that lets a chunk read too early
gives a wrong row).  So does the SpTRSV solve, one persistent launch a
solve ordered by device counters, on the 20k factor and on a factor with
hub rows (aux levels).  The paned SpGEMM fill (one writer a slot, no
atomics on values) must give the same bits twice, the resident one (the
same slot fill over the resident plan's stream) ten times, and on both
hub fixtures the fill's hub tier (a long run's segments summed by blocks
of their own, the last to arrive adding the partials) runs 50 times back
to back, each result in bound and bit-equal; the two tensor-core SpMM
kernels (``band_spmm_stream`` on the headline band at k = 256, the f32
``bsr_spmm`` on the block cell) ten times; both also run on all-positive
operands (|A| and |B|) there, where the tensor cores' truncated sums
would drift most.  Both band SpMM kernels (the resident FMA kernel and
the tensor-core one) give the same bits ten times on every band shape (k
= 256, 64, 33 and 32, f32 and bf16 panels) and read B in place with the
padded form's bits; the permuted band's one launch (B gathered and C
scattered through perm) gives the unfused path's bits, and the complex
band's one pass (complex and real B) is held to its plain version and to
the four real products it replaced.  The block SpGEMM kernel (f32 on the
tensor cores by the 3xTF32 split, f64 on the FP64 tensor cores) must
give the same bits ten times in both dtypes.  The complex ROUTE2 pass
(one launch per launch range over both value planes) runs 50 times back
to back on the 100k cell's aux level, and is held to its plain version
and to the four real applies it replaced, there and on the 300k
complex64 plan.  The band kernel is also held to its plain version on
panels and x views that are not 16-byte aligned.  The three 3xTF32
kernels run at the edges of the f32 range (+-FLT_MAX, infinities, and
2^-120 against 2^120 through the entry points' ``tf32_exact`` gate; the
dense B at 2^-120 and infinite, and finite products past FLT_MAX,
through the kernels' own test of B, whose flag must rise and send the
call to the exact kernel; and on the headline band at k = 256 and the
block cell at k = 256, a B with one value at 2^-120, whose gated exact
kernel must give its own bits over every tile, timed), and
the f32 BSR SpMM past a lowered slot-scratch budget, whose cut calls
must give the uncut call's bits.  The BSR SpMV kernel (a mapping by
block shape) is held to its plain version on 8x128 (the main path's),
8x8, 128x128, 12x125 and 3x3 blocks (the last on the 27-point
connectivity of a 64^3 node grid, f32 and f64), each also with x one
entry short (read in place) and x off 16-byte alignment, and gives the
same bits ten times on each.  The ROUTE v1 SpGEMM numeric (the slot fill
over the v1 plan's stream) gives the same bits ten times on the 2k plan
and on the dup-40 stream.  The DIA kernel that reads x in place (the
main path's) gives the padded kernel's bits on every DIA shape, x in f32
and in bf16.

Tolerance everywhere: |y - y_ref| <= 64 * eps_f32 * scale * (|A|.|x|)
per row (per entry of C against (|A|.|B|) for SpMM), the dot-product
form of the test suite's 64*eps model, since the two sides sum in
different orders; every SpMM check logs its largest err / limit.  A
solve is held to the componentwise backward error
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
import functools
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import spblas_tpu_torch as sp
from spblas_tpu_torch import _build, native
from spblas_tpu_torch import parallel as par
from spblas_tpu_torch import solvers
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR, host_arrays
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.convert import bsr_to_csr
from spblas_tpu_torch.kernels import banded, dia, ell, plans, route2
from spblas_tpu_torch.kernels import bsr_kernels as bk
from spblas_tpu_torch.kernels import bsr_spgemm as bsg
from spblas_tpu_torch.kernels import mul_fill as mf
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
from spblas_tpu_torch.utils import io as sio
from spblas_tpu_torch.utils import serialize

# the module (the package exports a function of the same name)
spgemm_ops = importlib.import_module("spblas_tpu_torch.ops.spgemm")

EPS32 = torch.finfo(torch.float32).eps
DEVICE = "cuda"   # where the script makes its own operands
# data-sheet memory bandwidth (bytes/s), non-tensor-core f32 and f64
# peaks, the dense TF32 tensor-core peak and the FP64 tensor-core peak
# (flop/s) by part; the first name fragment found in the card's name wins
_PARTS = (("H100 PCIe", 2.0e12, 51e12, 26e12, 378e12, 51e12),
          ("H100 NVL", 3.9e12, 60e12, 30e12, 417.5e12, 60e12),
          ("H100", 3.35e12, 67e12, 34e12, 494.7e12, 67e12),
          ("H200", 4.8e12, 67e12, 34e12, 494.7e12, 67e12))
_SLEEP_CYCLES = 50_000_000   # ~25 ms of device sleep ahead of a chain
_REPLICA_BYTES = 256 << 20   # distinct inputs per chain exceed the 50 MB L2

# the workload: (case, m, n, bandwidth, panel dtype, seed) for the band
# kernel beside the headline (409,600 rows, half-bandwidth 50, the bench
# headline matrix); the main-path matrices with the plan kind the chooser
# must pick; one wide rectangle more for the DIA kernel
HEADLINE = ("banded_409600_h50", 409_600, 409_600, 100)
BAND_CASES = [("odd_h_wide", 100_037, 120_000, 15, None, 11),
              ("odd_h_tall_bf16", 60_001, 50_000, 66, torch.bfloat16, 13)]
# band windows wider than the row kernel's 8,192-float shared-memory tile
# (band_row.cuh's kTile), which then pass through it in tiles: (panel
# rows, widths W: one of whole 16-byte loads, one of one-element loads)
BAND_WIDE = (3_072, (8_528, 8_530))
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
# kernel only: the 300k matrix in complex64, whose plan passes the slab
# kernel's SLAB_MIN_CHUNKS, and the 1M one, whose plan is rotated
CX_ONLY = ("uniform_300k_deg10_c64", lambda: gen.generate_csr(
    300_000, 300_000, 3_000_000, seed=3, complex_=True))
CX_ROTATED = ("uniform_1m_deg10_c64", lambda: gen.generate_csr(
    1_000_000, 1_000_000, 10_000_000, seed=3, complex_=True))
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
# paned and resident ROUTE2 plans), each result checked
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
# a band whose B fits the resident switch: odd_h_wide at k 8 (B's
# 120,000 rows past the window length, so the in-place read trims them)
SMALL_BAND_K = 8
# kernel-only SpMM shapes: odd k on odd_h_wide, bf16 panels; BSR blocks
# of (128, 128) and (8, 8) with empty block rows:
# (name, block rows, block columns, blocks a row, block shape,
#  every how many block rows is empty, k, seed)
BAND_SPMM_ONLY = [("odd_h_wide", 33), ("odd_h_tall_bf16", 64)]
BSR_ONLY = [("bsr_16384_128x128_empty_rows", 128, 128, 3, (128, 128), 4,
             256, 83),
            ("bsr_65536_8x8_empty_rows", 8_192, 8_192, 8, (8, 8), 5, 256,
             84)]
# kernel-only SpMV shapes beside them (the same fields, no SpMM): odd
# 12x125 blocks (the cols mapping with one-element loads); and 3x3
# blocks on the 27-point connectivity of a 64^3 node grid, the block SpMV
# of a 3-D linear-elasticity code on a structured hex mesh (three
# displacement unknowns a node, 27 neighbouring nodes: 262,144 block
# rows, 190^3 = 6,859,000 blocks), seeded values in f32 and f64:
# (name, grid side, seed)
BSR_SPMV_ONLY = [("bsr_49152_12x125_empty_rows", 4_096, 512, 4, (12, 125),
                  3, None, 119)]
FEM_BSR = ("bsr_fem_3x3_64^3", 64, 131)
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
# kernel only, f32 and f64 with empty block rows: the chooser's (8, 128)
# A blocks against (128, 128) ones, C blocks of 16 rows, and blocks whose
# depth and width are odd (one element a copy, no 16-byte vectors):
# (name, block rows, block columns, blocks a row, block shape, every how
#  many block rows is empty (0: none), seed) for A, then B's
BSR_SPGEMM_MAIN = ("bsr_spgemm_32768_128x128",
                   (256, 256, 8, (128, 128), 0, 111),
                   (256, 256, 8, (128, 128), 0, 112))
BSR_SPGEMM_ONLY = [("bsr_spgemm_8x128_128x128_empty_rows",
                    (512, 64, 4, (8, 128), 3, 113),
                    (64, 64, 4, (128, 128), 0, 114)),
                   ("bsr_spgemm_16x128_128x128_empty_rows",
                    (256, 64, 4, (16, 128), 3, 115),
                    (64, 64, 4, (128, 128), 0, 116)),
                   ("bsr_spgemm_12x125_125x131_empty_rows",
                    (256, 64, 4, (12, 125), 3, 117),
                    (64, 64, 4, (125, 131), 0, 118))]

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
# kernel only, for the race check: the 20k factor with hub rows, each
# given extra random columns below the diagonal (aux levels): (name,
# rows, columns a row, seed)
TRSV_HUB = ("sptrsv_20k_hub_rows", 4, 3_000, 121)

# band power iterations on the headline band built on the card from
# random diagonals (bench.py:66-86, _device_band_plan): (name, rows, half
# bandwidth, iterations)
POWER_MAIN = ("band_power_409600_h50", 409_600, 50, 10)

# the sparse algebra ops, DCSR and ELL, their results fed to the kernels
# through matrix_opt: the uniform 1M matrix (ROUTE_MAIN[1], bench.py:795)
# transposed; the headline band minus SHIFT * I (the shifted operator of
# eigen and Chebyshev codes); a union add of that 1M matrix and one of
# another seed, two-phase; a 1M-row COO operand with COPIES entries a
# slot; the hypersparse DCSR of spblas_tpu/formats/dcsr.py:4-8 (2^21
# rows, 2^20 entries drawn into 12.5 % of the rows: (name, m, n, nnz,
# seed)); an ELL plan of the uniform 300k cell (ROUTE_MAIN[0]) at
# k = ELL_K
SHIFT = 0.5
UNION_SEED = 7
REPEAT_COO = ("coo_1m_3_copies", 3, 9)    # (name, copies, seed)
DCSR_MAIN = ("dcsr_2m_hypersparse", 2_097_152, 2_097_152, 1_048_576, 11)
ELL_K = 64
SAME_BITS_RUNS = 10

BAND_SOURCE = "spblas_tpu_torch/csrc/band_spmv.cu"
DIA_SOURCE = "spblas_tpu_torch/csrc/dia_spmv.cu"
ROUTE_SOURCE = "spblas_tpu_torch/csrc/route2_spmv.cu"
V1_SOURCE = "spblas_tpu_torch/csrc/route_spmv.cu"
PANED_SOURCE = "spblas_tpu_torch/csrc/route_paned_spmv.cu"
BAND_REPLACES = "spblas_tpu/kernels/banded.py:104"
DIA_REPLACES = "spblas_tpu/kernels/dia.py:146"
ROUTE_REPLACES = "spblas_tpu/kernels/route2_kernel.py:119"
# the complex pass replaces the same TPU kernel, which JAX's route_cx_spmv
# (spblas_tpu/kernels/plans.py:124-135) dispatches four times
CX_REPLACES = ROUTE_REPLACES
V1_REPLACES = "spblas_tpu/kernels/route_spmv.py:82"
PANED_REPLACES = "spblas_tpu/kernels/route_paned.py:404"
BAND_SPMM_SOURCE = "spblas_tpu_torch/csrc/band_spmm.cu"
BSR_SPMV_SOURCE = "spblas_tpu_torch/csrc/bsr_spmv.cu"
BSR_SPMM_SOURCE = "spblas_tpu_torch/csrc/bsr_spmm.cu"
BAND_SPMM_REPLACES = "spblas_tpu/kernels/banded.py:164"
# the complex pass replaces the JAX band_cx SpMM's four _spmm_kernel
# products (spblas_tpu/kernels/plans.py:95-101)
BAND_CX_REPLACES = BAND_SPMM_REPLACES
BAND_STREAM_REPLACES = "spblas_tpu/kernels/banded.py:403"
BSR_SPMV_REPLACES = "spblas_tpu/kernels/bsr_pallas.py:128"
BSR_SPMM_REPLACES = "spblas_tpu/kernels/bsr_pallas.py:33"
# the resident ROUTE2-mul numeric is the slot fill over its plan's stream
MUL_SOURCE = "spblas_tpu_torch/csrc/mul_fill.cu"
MUL_PANED_SOURCE = "spblas_tpu_torch/csrc/mul_fill.cu"
BSR_SPGEMM_SOURCE = "spblas_tpu_torch/csrc/bsr_spgemm.cu"
MUL_REPLACES = "spblas_tpu/kernels/route2_kernel.py:414"
MUL_PANED_REPLACES = "spblas_tpu/kernels/route_mul_paned.py:274"
BSR_SPGEMM_REPLACES = "spblas_tpu/kernels/bsr_spgemm.py:114"
# the ROUTE v1 SpGEMM numeric is the slot fill over the v1 plan's stream
V1_MUL_SOURCE = "spblas_tpu_torch/csrc/mul_fill.cu"
V1_MUL_REPLACES = "spblas_tpu/kernels/route_mul_kernel.py:69"
POWER_SOURCE = "spblas_tpu_torch/csrc/band_power.cu"
POWER_REPLACES = "spblas_tpu/kernels/banded.py:474"
SOLVE_SOURCE = "spblas_tpu_torch/csrc/route2_spmv.cu"
SOLVE_REPLACES = "spblas_tpu/kernels/route2_kernel.py:119"
# the kernels of phase D's distributed paths: (source, TPU kernel)
DIST_SOURCES = {"band_spmv": (BAND_SOURCE, BAND_REPLACES),
                "band_spmm": (BAND_SPMM_SOURCE, BAND_SPMM_REPLACES),
                "route2_spmv": (ROUTE_SOURCE, ROUTE_REPLACES),
                "route2_mul_paned": (MUL_PANED_SOURCE, MUL_PANED_REPLACES)}
# wrapper -> kernel name, for the launch counts
WRAPPERS = {"band_spmv": banded.band_spmv_padded,
            "dia_spmv": dia.dia_spmv_padded,
            "route2_spmv": r2k.route2_spmv_padded,
            "route2_cx_spmv": r2k.route2_cx_spmv_padded,
            "route_spmv": rsp.route_spmv_padded,
            "route_paned_spmv": rpn.route_paned_spmv_padded,
            "band_spmm": banded.band_spmm_padded,
            "band_spmm_cx": banded.band_spmm_cx,
            "band_spmm_stream": banded.band_spmm_stream_padded,
            "bsr_spmv": bk.bsr_spmv_blocks,
            "bsr_spmm": bk.bsr_spmm_blocks,
            "route2_mul": mf.mul_fill,
            "route2_mul_paned": mf.mul_fill,
            "bsr_spgemm": bsg.bsr_spgemm_blocks,
            "route_mul": mf.mul_fill,
            "band_power": banded.band_power_padded,
            "route2_solve": r2k.route2_solve_padded}
# the exact kernels gated behind a tensor-core call by its flag (they
# exit at once when it is down), counted on the wrapper's ``gated``
GATED = {"band_spmm_gated": banded.band_spmm_stream_padded,
         "bsr_spmm_gated": bk.bsr_spmm_blocks}
# kernels that share one wrapper's count (the slot fill runs the numeric
# of the resident and paned ROUTE2-mul and the ROUTE v1 SpGEMM engines):
# the engine whose main path credits it
SHARED = {"route2_mul": "resident", "route2_mul_paned": "paned",
          "route_mul": "v1"}
# kind -> the kernels its main-path SpMV call must launch
KIND_KERNELS = {"band": ("band_spmv",), "bsr": ("bsr_spmv",),
                "band_perm": ("band_spmv",),
                "route": ("route2_spmv",),
                "route_cx": ("route2_cx_spmv",),
                "route1": ("route_spmv",),
                "route1_sorted": ("route_spmv", "route2_spmv"),
                "route_paned": ("route_paned_spmv",)}
# kind -> the kernels its main-path SpMM call must launch (the band kind
# at the spmm_banded shape streams B: its resident B passes 6 MB; the
# small band cell names its own, the resident kernel)
SPMM_KIND_KERNELS = {"band": ("band_spmm_stream",), "bsr": ("bsr_spmm",),
                     "band_perm": ("band_spmm",),
                     "band_cx": ("band_spmm_cx",)}
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


def reset_launches():
    """Every kernel's launch count set to 0, the gated ones' too."""
    for w in WRAPPERS.values():
        w.launches = 0
    for w in GATED.values():
        w.gated = 0


def read_launches(kind):
    """Each kernel's launch count since the counts were set to 0, a
    shared count credited only to the kernel of ``kind`` (``SHARED``),
    and the gated exact launches (``GATED``)."""
    out = {k: w.launches for k, w in WRAPPERS.items()}
    out.update({k: w.gated for k, w in GATED.items()})
    for k, engine in SHARED.items():
        if kind != engine:
            out[k] = 0
    return out


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
    """(memory rate, f32 peak, f64 peak, TF32 peak, FP64 tensor-core
    peak) of the card."""
    for frag, *rates in _PARTS:
        if frag in name:
            return tuple(rates)
    raise SmokeFailure(f"no data-sheet rates for {name!r}")


def bound(nbytes, flops, rates, f64=False):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 (or, with ``f64``, the f64) peak."""
    bw, peak = rates[0], rates[2 if f64 else 1]
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound(nbytes, flops, rates):
    """(tc_bound_ms, bound_by) of an f32 matrix product on the tensor
    cores: the larger of bytes over the memory rate and three times the
    operations over the TF32 peak (a full-f32 product takes three TF32
    products: csrc/tf32_mma.cuh).  It reads the same work whatever
    implements it."""
    t_bytes, t_ops = nbytes / rates[0] * 1e3, 3 * flops / rates[3] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dmma_bound(nbytes, flops, rates):
    """(bound_ms, bound_by) of an f64 matrix product on the FP64 tensor
    cores: the larger of bytes over the memory rate and the operations
    over the FP64 tensor-core peak."""
    t_bytes, t_ops = nbytes / rates[0] * 1e3, flops / rates[4] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _wide(t):
    return t.to(torch.complex128) if t.is_complex() else t.double()


def limit_check(y, y_ref, absdot, scale=1.0, eps=EPS32):
    """Per-row (per-entry) tolerance 64 * eps * |scale| * absdot, eps the
    unit roundoff of the dtype the kernel computes in (f32's unless
    given); returns (max |y - y_ref|, the largest err / limit, where the
    limit is not 0)."""
    err = (_wide(y) - _wide(y_ref)).abs()
    lim = 64 * eps * abs(scale) * absdot.double()
    bad = int((err > lim).sum())
    require(bad == 0, f"{bad} rows outside 64*eps*(|A||x|) at eps {eps:.3e} "
                      f"(max err {float(err.max()):.3e})")
    nz = lim > 0
    ratio = float((err[nz] / lim[nz]).max()) if bool(nz.any()) else 0.0
    return float(err.max()), ratio


def row_check(y, y_ref, absdot, scale=1.0, eps=EPS32):
    """Per-row tolerance; returns max |y - y_ref|."""
    return limit_check(y, y_ref, absdot, scale, eps)[0]


def same_bits(name, fn, args, runs=10):
    """``runs`` launches of ``fn(*args)`` give bit-equal results (one
    writer an element and a fixed order of sums)."""
    first = fn(*args)
    for _ in range(runs - 1):
        require(torch.equal(fn(*args), first), f"{name}: a run differs")
    log(f"[same-bits] {name}: {runs} runs bit-equal")


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


def band_misaligned_check():
    """The band kernel on panels and xp views one element past a 16-byte
    boundary (the kernel then takes one-element loads), f32 and bf16, a
    SpMV and two power iterations, against the plain versions."""
    _, m, n, bw, _, seed = BAND_CASES[0]
    a = gen.generate_banded_csr(m, n, bw, seed=seed)
    plan = banded.build_band_plan(a)
    xp = banded.pad_x(plan, gen.generate_vector(n, seed=seed + 2))

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        require(view.data_ptr() % 16 and view.is_contiguous(),
                "misaligned view is aligned")
        return view

    sq = banded.build_band_plan(gen.generate_banded_csr(m, m, bw,
                                                        seed=seed))
    xq = banded.pad_x(sq, gen.generate_vector(m, seed=seed + 3))
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        panels = plan.panels.to(dt)
        before = banded.band_spmv_padded.launches
        y = banded.band_spmv_padded(shifted(panels), shifted(xp))
        torch.cuda.synchronize()
        require(banded.band_spmv_padded.launches == before + 1,
                "misaligned band_spmv did not launch")
        err = max(err, row_check(
            y, banded.band_spmv_reference(panels, xp),
            banded.band_spmv_reference(panels.abs(), xp.abs())))
        qp = sq.panels.to(dt)
        h = sq.pad_l
        yq = banded.band_power_padded(shifted(qp), xq, 2, h)
        torch.cuda.synchronize()
        err = max(err, row_check(
            yq, banded.band_power_reference(qp, xq, 2, h),
            2 * banded.band_power_reference(qp.abs(), xq.abs(), 2, h)))
    log(f"[check] band_spmv, band_power on views off 16-byte alignment "
        f"(f32, bf16): in bound, max |err| {err:.3e}")


def band_wide_check():
    """The band kernel on windows wider than its shared-memory tile, f32
    and bf16 panels, a SpMV and two power iterations on seeded random
    panels and x (zero halo edges, as pad_x leaves them), against the
    plain versions on the same inputs."""
    rows, widths = BAND_WIDE
    g = torch.Generator(device=DEVICE).manual_seed(171)
    err = 0.0
    for w in widths:
        h = (w - 128) // 2
        panels32 = torch.rand(rows, w, device=DEVICE, generator=g) * 2 - 1
        xp = torch.zeros(rows - 128 + w, device=DEVICE)
        xp[h:h + rows] = torch.rand(rows, device=DEVICE, generator=g) * 2 - 1
        for dt in (torch.float32, torch.bfloat16):
            panels = panels32.to(dt)
            before = (banded.band_spmv_padded.launches,
                      banded.band_power_padded.launches)
            y = banded.band_spmv_padded(panels, xp)
            yq = banded.band_power_padded(panels, xp, 2, h)
            torch.cuda.synchronize()
            require((banded.band_spmv_padded.launches,
                     banded.band_power_padded.launches)
                    == (before[0] + 1, before[1] + 2),
                    f"wide band W {w}: kernels did not launch")
            err = max(err, row_check(
                y, banded.band_spmv_reference(panels, xp),
                banded.band_spmv_reference(panels.abs(), xp.abs())))
            err = max(err, row_check(
                yq, banded.band_power_reference(panels, xp, 2, h),
                2 * banded.band_power_reference(panels.abs(), xp.abs(), 2,
                                                h)))
    log(f"[check] band_spmv, band_power on windows W {widths} past the "
        f"shared-memory tile (f32, bf16): in bound, max |err| {err:.3e}")


def dia_case(name, a, seed, rates, card):
    """``dia_spmv`` on one matrix: the padded kernel (x in the TPU
    kernel's padded pane) against its plain version, and the in-place
    kernel (the main path's: x read in place, m rows) against the padded
    kernel's bits, x in f32 and in bf16; both timed."""
    plan = dia.build_dia_plan(a)
    m = a.shape[0]
    x = gen.generate_vector(a.shape[1], seed=seed)
    x2, pad_lo = dia.pad_x(plan, x)
    y_k = dia.dia_spmv_padded(plan, x2, pad_lo)
    torch.cuda.synchronize()
    y_p = dia.dia_spmv_reference(plan.diags, plan.offsets, x2, pad_lo)
    err = row_check(y_k, y_p, dia.dia_spmv_reference(
        plan.diags.abs(), plan.offsets, x2.abs(), pad_lo))
    for xx in (x, x.bfloat16()):
        y_i = dia.dia_spmv_inplace(plan, xx)
        y_pad = dia.dia_spmv_padded(plan, *dia.pad_x(plan, xx))
        require(y_i.shape == (m,) and torch.equal(y_i, y_pad[:m]),
                f"dia_spmv {name} {xx.dtype}: the in-place kernel differs "
                "from the padded kernel's bits")
        require(torch.equal(dia.dia_spmv_inplace_reference(plan, xx),
                            dia.dia_spmv_reference(
                                plan.diags, plan.offsets,
                                *dia.pad_x(plan, xx))[:m]),
                f"dia_spmv {name} {xx.dtype}: plain versions differ")
    log(f"[check] dia_spmv {name}: in bound, max |err| {err:.3e}; in place "
        "= padded bits (f32 and bf16 x)")
    total = plan.diags.numel()
    rows = plan.diags.shape[1] * 128
    # x: the span the shifted reads cover (a wide rectangle reads little
    # of its padded x); the in-place kernel needs the m rows' diagonal
    # values and writes m rows, the padded one every padded row
    span = max(plan.offsets) - min(plan.offsets)
    nbytes = plan.ndiag * m * 4 + min(m + span, a.shape[1]) * 4 + m * 4
    b_ms, b_by = bound(nbytes, 2 * plan.ndiag * m, rates)
    pad_bytes = total * 4 + (rows + span) * 4 + rows * 4
    pb_ms, _ = bound(pad_bytes, 2 * total, rates)

    def copy():
        p = dataclasses.replace(plan, diags=plan.diags.clone())
        p.offsets_tensor        # made now, not inside the timed chain
        p.offsets_host
        return p, x2.clone(), pad_lo, x.clone()

    ins = replicas(copy, pad_bytes)
    k_ms = device_ms(lambda p, xx, lo, xi: dia.dia_spmv_inplace(p, xi), ins)
    pad_ms = device_ms(lambda p, xx, lo, xi: dia.dia_spmv_padded(p, xx, lo),
                       ins)
    padx_ms = device_ms(lambda p, xx, lo, xi: dia.pad_x(p, xi), ins)
    p_ms = device_ms(lambda p, xx, lo, xi: dia.dia_spmv_reference(
        p.diags, p.offsets, xx, lo), ins)
    l_ms = library_ms(a, x)
    rec = {"kernel": "dia_spmv", "case": name, "m": m,
           "n": a.shape[1], "ndiag": plan.ndiag,
           "offsets": [min(plan.offsets), max(plan.offsets)],
           "nnz": a.nnz, "max_abs_err": err, "kernel_ms": k_ms,
           "bound_ms": b_ms, "bound_by": b_by, "padded_kernel_ms": pad_ms,
           "padded_bound_ms": pb_ms, "pad_x_ms": padx_ms, "plain_ms": p_ms,
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


def route_cx_case(name, a, p, seed, rates, card, race=False):
    """``route2_cx_spmv`` (one complex pass over a ``route_cx`` plan: the
    main range, then each aux level) against its plain version and
    against the four real ``route2_spmv`` applies it replaced, each timed
    as a chain; ``race``: 50 runs back to back held to the plain
    version."""
    kind, pr, pi, vi = p
    require(kind == "route", f"{name}: route_cx over {kind!r}")
    x = gen.generate_vector(a.shape[1], seed=seed, complex_=True)
    x2 = r2k.pack_x2(pr, x)
    before = r2k.route2_cx_spmv_padded.launches
    y_k = r2k.route2_cx_spmv_padded(pr, vi, x2)
    torch.cuda.synchronize()
    per_call = r2k.route2_cx_spmv_padded.launches - before
    require(per_call == len(pr.launch_ranges()),
            f"route2_cx_spmv {name}: {per_call} launches")
    y_p = r2k.route2_cx_spmv_reference(pr, vi, x2)
    # |A| . |x| per row: the plan with |a_ij| (carriers keep 1, padding 0)
    absd = r2k.route2_spmv_reference(dataclasses.replace(
        pr, val=torch.sqrt(pr.val ** 2 + vi ** 2)), x2.abs())
    absd = absd.view(-1)[: pr.shape[0]]
    err = row_check(y_k.view(-1)[: pr.shape[0]],
                    y_p.view(-1)[: pr.shape[0]], absd)
    # the four real applies: (ar xr - ai xi) + i (ar xi + ai xr)
    xs = [r2k.pack_x2(pr, x.real.float()), r2k.pack_x2(pr, x.imag.float())]

    def four(planes, x2s, fn=r2k.route2_spmv_padded):
        (qr, qi), (xr, xi) = planes, x2s
        return torch.complex(fn(qr, xr) - fn(qi, xi),
                             fn(qr, xi) + fn(qi, xr))

    y_4 = four((pr, pi), xs)
    torch.cuda.synchronize()
    err4 = row_check(y_k.view(-1)[: pr.shape[0]],
                     y_4.view(-1)[: pr.shape[0]], absd, scale=2.0)
    # a real x: the same pass, which reads no imaginary part of x
    x2r = r2k.pack_x2(pr, x.real.float())
    before = r2k.route2_cx_spmv_padded.launches
    y_r = r2k.route2_cx_spmv_padded(pr, vi, x2r)
    torch.cuda.synchronize()
    require(r2k.route2_cx_spmv_padded.launches - before == per_call,
            f"route2_cx_spmv {name}, real x: "
            f"{r2k.route2_cx_spmv_padded.launches - before} launches")
    rows_of = [t.view(-1)[: pr.shape[0]] for t in (
        y_r, r2k.route2_cx_spmv_reference(pr, vi, x2r),
        r2k.route2_spmv_reference(dataclasses.replace(
            pr, val=torch.sqrt(pr.val ** 2 + vi ** 2)), x2r.abs()))]
    err_r = row_check(*rows_of)
    log(f"[check] route2_cx_spmv {name} ({per_call} launches): in bound of "
        f"the plain version (max |err| {err:.3e}; a real x {err_r:.3e}) "
        f"and of the four applies (max |err| {err4:.3e})")
    del y_k, y_4, y_r, x2r, rows_of
    if race:
        race_check(f"route2_cx_spmv {name}",
                   lambda: r2k.route2_cx_spmv_padded(pr, vi, x2)
                   .view(-1)[: pr.shape[0]], y_p.view(-1)[: pr.shape[0]],
                   absd)
    nch = pr.nchunks
    rows = r2k.out_rows(pr)
    # one pass: the tile, both value planes and the per-chunk scalars
    # once, the complex x pane once, the complex output pane twice (zeroed,
    # then accumulated); a complex multiply-add (8 flops) a slot
    nbytes = (nch * (12 * 1024 + 12 + 4 * pr.rotated) + pr.x_rows * 1024
              + 2 * rows * 1024)
    b_ms, b_by = bound(nbytes, 8 * nch * 1024, rates)
    one = (nch * (8 * 1024 + 12 + 4 * pr.rotated) + pr.x_rows * 512
           + 2 * rows * 512)
    b4_ms, _ = bound(4 * one, 4 * 2 * nch * 1024, rates)

    def copy():
        q = dataclasses.replace(pr, val=pr.val.clone())
        return q, vi.clone(), x2.clone()

    def copy4():
        return ([dataclasses.replace(q, val=q.val.clone()) for q in (pr, pi)],
                [xx.clone() for xx in xs])

    ins = replicas(copy, nbytes)
    k_ms = device_ms(r2k.route2_cx_spmv_padded, ins)
    p_ms = device_ms(r2k.route2_cx_spmv_reference, ins[:2], reps=4)
    del ins
    ins = replicas(copy4, 4 * one)
    f_ms = device_ms(four, ins)
    del ins
    l_ms = library_ms(a, x)
    torch.cuda.empty_cache()
    return {"kernel": "route2_cx_spmv", "case": name, "m": a.shape[0],
            "n": a.shape[1], "nnz": a.nnz, "nchunks": nch,
            "slab_sized": nch >= route2.SLAB_MIN_CHUNKS, "fill": pr.fill,
            "g": pr.g, "rotated": pr.rotated,
            "n_aux_chunks": pr.n_aux_chunks, "launches_per_call": per_call,
            "max_abs_err": err, "max_abs_err_real_x": err_r,
            "max_abs_err_vs_four": err4,
            "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": p_ms, "library_ms": l_ms, "four_apply_ms": f_ms,
            "four_apply_launches": 4 * per_call,
            "four_apply_bound_ms": b4_ms, "nnz_s": a.nnz / (k_ms * 1e-3),
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


def flag_b(b, row):
    """B with its value at (row, 0) set to 2^-120, below the 3xTF32
    split's 2^-112: the tensor-core kernels' test of B raises the call's
    flag on it (``csrc/tf32_mma.cuh``, Limits)."""
    bf = b.clone()
    bf[row, 0] = 2.0 ** -120
    return bf


def flagged_check(kname, name, wrapper, call, exact, ref, absd, fn, ins):
    """A call at a main-path shape whose B fails the tensor-core kernel's
    test (one value at 2^-120, :func:`flag_b`): the flag rises, one gated
    exact launch follows, and C is the exact kernel's own bits (every
    tile rewritten), held to the plain version within 64 eps (|A| |B|);
    then ``fn`` timed over the distinct flagged operands ``ins``.
    Returns (err / limit, ms)."""
    gated = wrapper.gated
    y = call()
    torch.cuda.synchronize()
    require(flag_path(wrapper) == "exact" and wrapper.gated == gated + 1,
            f"{kname} {name} flagged B: the flag did not rise")
    require(torch.equal(y, exact()),
            f"{kname} {name} flagged B: C is not the exact kernel's bits")
    _, ratio = limit_check(y, ref, absd)
    del y
    ms = device_ms(fn, ins)
    log(f"[check] {kname} {name} flagged B (one value 2^-120): flag up, "
        f"the exact kernel's bits, err / limit {ratio:.4f}; {ms:.4f} ms")
    return ratio, ms


def band_spmm_case(name, plan, k, seed, rates, card, csr=None,
                   full=False):
    """Both band SpMM kernels on one plan and one B against their plain
    version, each 10 times on one input for the same bits, and each in
    its in-place form (B unpadded at pad_l: the plan entry points' read)
    for the padded form's bits, timed beside the padded form and the
    ``pad_b`` copy it dropped; returns one record per kernel.  ``full``:
    the streamed (tensor-core) kernel also on all-positive operands, |A|
    and |B|, and through the entry point on a flagged B, its gated exact
    kernel walking every tile (:func:`flagged_check`), timed."""
    b = dense_operands(plan.shape[1], k, seed)[0]
    bp = banded.pad_b(plan, b)
    c_p = banded.band_spmm_reference(plan.panels, bp)
    absd = banded.band_spmm_reference(plan.panels.abs(), bp.abs())
    rows, w = plan.panels.shape
    m = plan.shape[0]
    # panels, the padded B and C, each once; the padded product's flops
    nbytes = (plan.panels.numel() * plan.panels.element_size()
              + bp.numel() * 4 + rows * k * 4)
    b_ms, b_by = bound(nbytes, 2 * rows * w * k, rates)
    tc_ms, tc_by = tc_bound(nbytes, 2 * rows * w * k, rates)
    # the tensor-core kernel tests B against the panels' largest
    # magnitude, cached on the plan as the entry point has it
    stream = functools.partial(banded.band_spmm_stream_padded,
                               amax=plan.tf32_amax)
    if full:
        pos = (plan.panels.abs(), bp.abs())
        _, pos_ratio = limit_check(stream(*pos), absd, absd)
        log(f"[check] band_spmm_stream {name} all-positive: in bound, "
            f"err / limit {pos_ratio:.4f}")
        del pos
    ins = replicas(lambda: (plan.panels.clone(), bp.clone()), nbytes)
    ins_b = replicas(lambda: (plan.panels.clone(), b.clone()), nbytes)
    p_ms = device_ms(banded.band_spmm_reference, ins)
    pad_ms = device_ms(lambda _, bb: banded.pad_b(plan, bb), ins_b)
    l_ms = library_mm_ms(csr, b) if csr is not None else None
    recs = []
    for kname, fn, fused in (
            ("band_spmm", banded.band_spmm_padded,
             banded.band_spmm_inplace),
            ("band_spmm_stream", stream,
             functools.partial(banded.band_spmm_stream_inplace,
                               amax=plan.tf32_amax))):
        c_k = fn(plan.panels, bp)
        torch.cuda.synchronize()
        err, ratio = limit_check(c_k, c_p, absd)
        log(f"[check] {kname} {name}: in bound, max |err| {err:.3e}, "
            f"err / limit {ratio:.4f}")
        same_bits(f"{kname} {name}", fn, (plan.panels, bp))

        def inplace(p, bb, fused=fused):
            return fused(p, bb, plan.pad_l, m)

        require(torch.equal(inplace(plan.panels, b), c_k[:m]),
                f"{kname} {name}: B in place differs from the padded B")
        del c_k
        k_ms = device_ms(fn, ins)
        i_ms = device_ms(inplace, ins_b)
        log(f"[time] {kname} {name}: padded B {k_ms:.4f} ms + pad_b "
            f"{pad_ms:.4f} ms; B in place {i_ms:.4f} ms (same bits)")
        recs.append({"kernel": kname, "case": name, "m": m,
                     "n": plan.shape[1], "k": k, "width": w,
                     "pad_l": plan.pad_l,
                     "panels": str(plan.panels.dtype).split(".")[-1],
                     "max_abs_err": err, "max_err_over_limit": ratio,
                     "same_bits_runs": 10, "kernel_ms": k_ms,
                     "inplace_ms": i_ms, "pad_b_ms": pad_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "tc_bound_ms": tc_ms, "tc_bound_by": tc_by,
                     "plain_ms": p_ms, "library_ms": l_ms,
                     "flop_s": 2 * rows * w * k / (k_ms * 1e-3),
                     "card": card})
        if full and kname == "band_spmm_stream":
            recs[-1]["all_positive_err_over_limit"] = pos_ratio
            row = plan.shape[1] // 2
            bf = flag_b(b, row)
            bfp = banded.pad_b(plan, bf)
            ratio_f, ms_f = flagged_check(
                kname, name, banded.band_spmm_stream_padded,
                lambda: banded.band_spmm_stream(plan, bf),
                lambda: banded.band_spmm_inplace(plan.panels, bf,
                                                 plan.pad_l, m),
                banded.band_spmm_reference(plan.panels, bfp)[:m],
                banded.band_spmm_reference(plan.panels.abs(),
                                           bfp.abs())[:m],
                inplace, replicas(lambda: (plan.panels.clone(),
                                           flag_b(b, row)), nbytes))
            recs[-1].update(flagged_err_over_limit=ratio_f,
                            flagged_inplace_ms=ms_f,
                            exact_inplace_ms=recs[0]["inplace_ms"])
            del bf, bfp
    del ins, ins_b, c_p, absd, bp
    torch.cuda.empty_cache()
    return recs


def band_perm_spmm_case(name, pp, k, seed, rates, card, csr):
    """The permuted band's SpMM in one resident launch (B's rows gathered
    by perm as the kernel reads them, C's rows written through perm)
    against its plain version, 10 times for the same bits, bit-equal to
    the unfused path it replaced (B padded and gathered by
    ``index_select``, the padded kernel, C gathered back by rank), and
    timed beside that path's three parts."""
    band = pp.band
    m = pp.shape[0]
    rows, w = band.panels.shape
    mp = pp.perm.shape[0]
    b = dense_operands(m, k, seed)[0]

    def fused(p, bb):
        return banded.band_spmm_inplace(p, bb, band.pad_l, m, perm=pp.perm)

    def gather(bb):
        return banded.pad_b(band, banded._pad_rows(bb, mp).index_select(
            0, pp.perm)[:m])

    def scatter(cc):
        return banded._pad_rows(cc, mp).index_select(0, pp.rank)[:m]

    c_k = fused(band.panels, b)
    torch.cuda.synchronize()
    c_p = banded.band_spmm_inplace_reference(band.panels, b, band.pad_l, m,
                                             pp.perm)
    absd = banded.band_spmm_inplace_reference(band.panels.abs(), b.abs(),
                                              band.pad_l, m, pp.perm)
    err, ratio = limit_check(c_k, c_p, absd)
    log(f"[check] band_spmm {name} (fused gather and scatter): in bound, "
        f"max |err| {err:.3e}, err / limit {ratio:.4f}")
    same_bits(f"band_spmm {name} (fused)", fused, (band.panels, b))
    c_u = banded.band_spmm_padded(band.panels, gather(b))
    require(torch.equal(scatter(c_u), c_k),
            f"band_spmm {name}: the fused launch differs from the unfused "
            f"path's bits")
    del c_p, absd, c_k
    # panels, B, C and perm, each once
    nbytes = (band.panels.numel() * band.panels.element_size()
              + 2 * m * k * 4 + mp * 4)
    b_ms, b_by = bound(nbytes, 2 * rows * w * k, rates)
    tc_ms, tc_by = tc_bound(nbytes, 2 * rows * w * k, rates)
    ins = replicas(lambda: (band.panels.clone(), b.clone()), nbytes)
    k_ms = device_ms(fused, ins)
    g_ms = device_ms(gather, [(bb,) for _, bb in ins])
    bps = [(p, gather(bb)) for p, bb in ins[:2]]
    u_ms = device_ms(banded.band_spmm_padded, bps)
    s_ms = device_ms(scatter, [(c_u,), (c_u.clone(),)])
    p_ms = device_ms(lambda p, bb: banded.band_spmm_inplace_reference(
        p, bb, band.pad_l, m, pp.perm), ins[:2], reps=4)
    l_ms = library_mm_ms(csr, b)
    log(f"[time] band_spmm {name}: fused {k_ms:.4f} ms; unfused: gather "
        f"{g_ms:.4f} + kernel {u_ms:.4f} + scatter {s_ms:.4f} ms")
    del ins, bps, c_u
    torch.cuda.empty_cache()
    return {"kernel": "band_spmm", "case": name, "m": m, "n": m, "k": k,
            "width": w, "pad_l": band.pad_l, "panels": "float32",
            "form": "fused perm", "max_abs_err": err,
            "max_err_over_limit": ratio, "same_bits_runs": 10,
            "kernel_ms": k_ms, "unfused_gather_ms": g_ms,
            "unfused_kernel_ms": u_ms, "unfused_scatter_ms": s_ms,
            "bound_ms": b_ms, "bound_by": b_by, "tc_bound_ms": tc_ms,
            "tc_bound_by": tc_by, "plain_ms": p_ms, "library_ms": l_ms,
            "flop_s": 2 * rows * w * k / (k_ms * 1e-3), "card": card}


def band_cx_spmm_case(name, planes, csr, k, seed, rates, card):
    """The complex pass (one launch over both panel planes) with a
    complex64 and a real B against its plain version, 10 times for the
    same bits and within twice the limit of the four real resident
    products it replaced, timed beside them (their B splits and the
    complex assembly included); returns one record per B."""
    pr, pi = planes
    m, n = pr.shape
    rows, w = pr.panels.shape
    mod = torch.sqrt(pr.panels ** 2 + pi.panels ** 2)
    bc = dense_operands(n, k, seed, cx=True)[0]

    def one(p0, p1, bb):
        return banded.band_spmm_cx(p0, p1, bb, pr.pad_l, m)

    def plain(p0, p1, bb):
        return banded.band_spmm_cx_reference(p0, p1, bb, pr.pad_l, m)

    def four(p0, p1, bb):
        return plans._cx_apply(banded.band_spmm, (
            dataclasses.replace(pr, panels=p0),
            dataclasses.replace(pi, panels=p1)), bb)

    recs = []
    for label, b in (("", bc), ("_real_b", bc.real.contiguous())):
        case = f"{name}{label}"
        c_k = one(pr.panels, pi.panels, b)
        torch.cuda.synchronize()
        absd = banded.band_spmm_inplace_reference(mod, b.abs(), pr.pad_l, m)
        err, ratio = limit_check(c_k, plain(pr.panels, pi.panels, b), absd)
        err4, _ = limit_check(c_k, four(pr.panels, pi.panels, b), absd,
                              scale=2.0)
        log(f"[check] band_spmm_cx {case}: in bound, max |err| {err:.3e}, "
            f"err / limit {ratio:.4f}; against the four real products "
            f"{err4:.3e}")
        same_bits(f"band_spmm_cx {case}", one, (pr.panels, pi.panels, b))
        del c_k, absd
        # both planes, B and the complex C, each once; 8 flops a complex
        # multiply-add (4 with a real B)
        nbytes = (2 * rows * w * 4 + b.numel() * b.element_size()
                  + m * k * 8)
        flops = (8 if b.is_complex() else 4) * rows * w * k
        b_ms, b_by = bound(nbytes, flops, rates)
        tc_ms, tc_by = tc_bound(nbytes, flops, rates)
        ins = replicas(lambda: (pr.panels.clone(), pi.panels.clone(),
                                b.clone()), nbytes)
        k_ms = device_ms(one, ins)
        f_ms = device_ms(four, ins)
        p_ms = device_ms(plain, ins[:2], reps=4)
        l_ms = library_mm_ms(csr, b.to(torch.complex64))
        log(f"[time] band_spmm_cx {case}: {k_ms:.4f} ms; four real "
            f"products {f_ms:.4f} ms")
        recs.append({"kernel": "band_spmm_cx", "case": case, "m": m,
                     "n": n, "k": k, "width": w, "pad_l": pr.pad_l,
                     "b": str(b.dtype).split(".")[-1], "max_abs_err": err,
                     "max_err_over_limit": ratio,
                     "max_abs_err_vs_four": err4, "same_bits_runs": 10,
                     "kernel_ms": k_ms, "four_apply_ms": f_ms,
                     "four_apply_launches": 4, "bound_ms": b_ms,
                     "bound_by": b_by, "tc_bound_ms": tc_ms,
                     "tc_bound_by": tc_by, "plain_ms": p_ms,
                     "library_ms": l_ms,
                     "flop_s": flops / (k_ms * 1e-3), "card": card})
        del ins
    torch.cuda.empty_cache()
    return recs


def bsr_cases(name, a, csr, k, seed, rates, card, spmv=True, spmm=True,
              full=False):
    """``bsr_spmv`` (when ``spmv``) and ``bsr_spmm`` (when ``spmm``) on
    one BSR against their plain versions; returns their records.  The
    SpMV also runs 10 times on one input for the same bits, and on x cut
    one entry short (read in place, as a zero past its end) and on an x
    one element off 16-byte alignment (one-element loads).  ``full``:
    ``bsr_spmm`` also on all-positive operands, |values| and |B|, 10
    times on one input for the same bits, its FMA kernel timed alone, and
    on a flagged B, its gated FMA kernel behind it
    (:func:`flagged_check`), timed."""
    v, rp, ci = a.values, a.block_rowptr, a.block_colind
    nnzb = a.nnz_blocks
    bh, bw = a.block_shape
    mb = rp.numel() - 1
    isz = v.element_size()
    f64 = v.dtype == torch.float64
    # each check's limit follows the dtype the kernel computes in
    eps = torch.finfo(v.dtype).eps
    # the stored blocks (not the capacity padding), rowptr, colind, the
    # dense operand and the output, each once
    meta = (mb + 1) * 4 + nnzb * 4 + nnzb * bh * bw * isz
    recs = []
    if spmv:
        n = a.shape[1]
        x = gen.generate_vector(n, seed=seed).to(v.dtype)
        y_k = bk.bsr_spmv_blocks(v, rp, ci, x)
        torch.cuda.synchronize()
        err, ratio = limit_check(
            y_k, bk.bsr_spmv_reference(v, rp, ci, x),
            bk.bsr_spmv_reference(v.abs(), rp, ci, x.abs()), eps=eps)
        del y_k
        short = x[:n - 1]
        _, short_ratio = limit_check(
            bk.bsr_spmv_blocks(v, rp, ci, short),
            bk.bsr_spmv_reference(v, rp, ci, short),
            bk.bsr_spmv_reference(v.abs(), rp, ci, short.abs()), eps=eps)
        off = torch.empty(n + 1, dtype=v.dtype, device=v.device)[1:]
        off.copy_(x)
        off_map = bk.spmv_mapping(bh, bw, isz, bk._aligned(v, off))
        _, off_ratio = limit_check(
            bk.bsr_spmv_blocks(v, rp, ci, off),
            bk.bsr_spmv_reference(v, rp, ci, x),
            bk.bsr_spmv_reference(v.abs(), rp, ci, x.abs()), eps=eps)
        mapping = bk.spmv_mapping(bh, bw, isz, bk._aligned(v, x))
        log(f"[check] bsr_spmv {name} {str(v.dtype)[6:]} (mapping "
            f"{mapping}, off alignment {off_map}): in bound at 64 eps "
            f"{eps:.3e}, err / limit {ratio:.4f}, x short {short_ratio:.4f}, "
            f"x off alignment {off_ratio:.4f}, max |err| {err:.3e}")
        same_bits(f"bsr_spmv {name} {str(v.dtype)[6:]}",
                  bk.bsr_spmv_blocks, (v, rp, ci, x))
        del short, off
        nbytes = meta + (x.numel() + mb * bh) * isz
        b_ms, b_by = bound(nbytes, 2 * nnzb * bh * bw, rates, f64=f64)
        ins = replicas(lambda: (v.clone(), rp.clone(), ci.clone(),
                                x.clone()), nbytes)
        k_ms = device_ms(bk.bsr_spmv_blocks, ins)
        p_ms = device_ms(bk.bsr_spmv_reference, ins)
        del ins
        torch.cuda.empty_cache()
        recs.append({"kernel": "bsr_spmv", "case": name,
                     "dtype": str(v.dtype)[6:], "m": a.shape[0],
                     "n": a.shape[1], "block": [bh, bw], "nnz_blocks": nnzb,
                     "empty_block_rows": int((rp[1:] == rp[:-1]).sum()),
                     "mapping": list(mapping), "same_bits_runs": 10,
                     "max_abs_err": err, "max_err_over_limit": ratio,
                     "limit_eps": eps, "kernel_ms": k_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_share": b_ms / k_ms, "plain_ms": p_ms,
                     "library_ms": library_ms(csr, x),
                     "nnz_s": a.nnz / (k_ms * 1e-3), "card": card})
        torch.cuda.empty_cache()
    if not spmm:
        return recs
    b = dense_operands(a.shape[1], k, seed + 1)[0]
    # the f32 kernel's column list, as the main path keeps it on the BSR
    spmm = functools.partial(bk.bsr_spmm_blocks,
                             column_order=a.column_order, amax=a.tf32_amax)
    c_k = spmm(v, rp, ci, b)
    torch.cuda.synchronize()
    absd = bk.bsr_spmm_reference(v.abs(), rp, ci, b.abs())
    err, ratio = limit_check(c_k, bk.bsr_spmm_reference(v, rp, ci, b), absd,
                             eps=eps)
    log(f"[check] bsr_spmm {name} k={k}: in bound, max |err| {err:.3e}, "
        f"err / limit {ratio:.4f}")
    del c_k
    extra = {}
    if full:
        _, pos_ratio = limit_check(spmm(v.abs(), rp, ci, b.abs()), absd,
                                   absd, eps=eps)
        log(f"[check] bsr_spmm {name} k={k} all-positive: in bound, "
            f"err / limit {pos_ratio:.4f}")
        same_bits(f"bsr_spmm {name} k={k}", spmm, (v, rp, ci, b))
        extra["all_positive_err_over_limit"] = pos_ratio
        extra["scratch_budget_cuts"] = budget_check(name, a, b)
    del absd
    nbytes = meta + b.numel() * 4 + mb * bh * k * 4
    flops = 2 * nnzb * bh * bw * k
    b_ms, b_by = bound(nbytes, flops, rates)
    tc_ms, tc_by = tc_bound(nbytes, flops, rates)
    ins = replicas(lambda: (v.clone(), rp.clone(), ci.clone(), b.clone()),
                   nbytes)
    k_ms = device_ms(spmm, ins)
    p_ms = device_ms(bk.bsr_spmm_reference, ins)
    if full:
        fma = functools.partial(bk.bsr_spmm_blocks, tc=False)
        extra["fma_ms"] = device_ms(fma, ins)
        row = int(ci[0]) * bw
        bf = flag_b(b, row)
        del ins
        extra["flagged_err_over_limit"], extra["flagged_ms"] = \
            flagged_check("bsr_spmm", f"{name} k={k}", bk.bsr_spmm_blocks,
                          lambda: spmm(v, rp, ci, bf),
                          lambda: fma(v, rp, ci, bf),
                          bk.bsr_spmm_reference(v, rp, ci, bf),
                          bk.bsr_spmm_reference(v.abs(), rp, ci, bf.abs()),
                          spmm, replicas(lambda: (
                              v.clone(), rp.clone(), ci.clone(),
                              flag_b(b, row)), nbytes))
        del bf
    else:
        del ins
    recs.append({"kernel": "bsr_spmm", "case": f"{name}_k{k}",
                 "m": a.shape[0], "n": a.shape[1], "k": k, "block": [bh, bw],
                 "nnz_blocks": nnzb,
                 "empty_block_rows": int((rp[1:] == rp[:-1]).sum()),
                 "max_abs_err": err, "max_err_over_limit": ratio,
                 "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "tc_bound_ms": tc_ms, "tc_bound_by": tc_by,
                 "plain_ms": p_ms, "library_ms": library_mm_ms(csr, b),
                 "flop_s": flops / (k_ms * 1e-3), "card": card, **extra})
    torch.cuda.empty_cache()
    return recs


def budget_check(name, a, b):
    """The f32 ``bsr_spmm`` past a slot-scratch budget lowered for the run:
    column phases of 64 columns, then ranges of block rows as well, each
    bit-equal to the unsplit call, two launches a cut and one gated
    exact launch for the call.  Returns the cut counts."""
    v, rp, ci = a.values, a.block_rowptr, a.block_colind
    cap, bh, _ = v.shape
    k = int(b.shape[1])
    ncb = -(-int(b.shape[0]) // a.block_shape[1])
    spmm = functools.partial(bk.bsr_spmm_blocks,
                             column_order=a.column_order, amax=a.tf32_amax)
    whole = spmm(v, rp, ci, b)
    per_phase = cap * bh * 4 * 64          # every slot at 64 columns
    saved = bk.SPMM_SCRATCH_BYTES
    counts = {}
    try:
        for label, budget in (("column_phases", per_phase),
                              ("block_row_ranges", per_phase // 3)):
            bk.SPMM_SCRATCH_BYTES = budget
            cuts = bk.spmm_phases(rp, ci, *a.column_order, cap, bh, k, ncb)
            require(len(cuts) > 1, f"bsr_spmm {name}: {label} made one cut")
            before = bk.bsr_spmm_blocks.launches
            gated = bk.bsr_spmm_blocks.gated
            got = spmm(v, rp, ci, b)
            torch.cuda.synchronize()
            # two a cut, and one gated exact launch for the call
            require(bk.bsr_spmm_blocks.launches - before == 2 * len(cuts)
                    and bk.bsr_spmm_blocks.gated == gated + 1,
                    f"bsr_spmm {name} {label}: launches")
            require(torch.equal(got, whole),
                    f"bsr_spmm {name} {label}: differs from the unsplit call")
            log(f"[same-bits] bsr_spmm {name} past a {budget}-byte budget: "
                f"{len(cuts)} cuts ({label}), bit-equal to the unsplit call")
            counts[label] = len(cuts)
            del got
    finally:
        bk.SPMM_SCRATCH_BYTES = saved
    return counts


def edge_check(kname, mode, fn, ref, args, abs_args):
    """One 3xTF32 kernel at an edge of the f32 range against its plain
    version: with an operand at +-FLT_MAX or scaled to 2^-120 against
    2^120 the result is finite and within 64 eps (|A| |B|); with infinite
    operands its infinities (and their signs) and NaNs are the plain
    version's.  Returns err / limit (None for the infinities)."""
    y = fn(*args)
    torch.cuda.synchronize()
    yp = ref(*args)
    if mode == "inf":
        inf = torch.isinf(yp)
        require(bool(inf.any()) and bool(torch.isnan(yp).any())
                and torch.equal(torch.isnan(y), torch.isnan(yp))
                and torch.equal(torch.isinf(y), inf)
                and torch.equal(torch.sign(y[inf]), torch.sign(yp[inf])),
                f"{kname} {mode}: infinities or NaNs differ from the plain "
                f"version")
        log(f"[edge] {kname} {mode}: {int(inf.sum())} infinities and "
            f"{int(torch.isnan(yp).sum())} NaNs, as the plain version")
        return None
    require(bool(torch.isfinite(y).all()), f"{kname} {mode}: not finite")
    _, ratio = limit_check(y, yp, ref(*abs_args))
    log(f"[edge] {kname} {mode}: finite, err / limit {ratio:.4f}")
    return ratio


def low_end_check(kname, gated, gate_args, tc, tc_args, ref, ref_args):
    """A scaled by 2^-120 against B scaled by 2^120 (all positive): the
    3xTF32 split's lo parts fall on TF32's subnormal grid (2^-136), so the
    operand's gate (``tf32_exact`` False) sends the entry point to an
    exact kernel, held to 64 eps (|A| |B|); the tensor-core kernel on the
    same operands is measured beside it, unchecked.  Returns (gated err /
    limit, tensor-core err / limit)."""
    yp = ref(*ref_args)
    y = gated(*gate_args)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(y).all()), f"{kname} 2^-120: not finite")
    _, ratio = limit_check(y, yp, yp)
    y_tc = tc(*tc_args)[: yp.shape[0]]
    torch.cuda.synchronize()
    err = (_wide(y_tc) - _wide(yp)).abs()
    lim = 64 * EPS32 * yp.double()
    tc_ratio = float((err[lim > 0] / lim[lim > 0]).max())
    log(f"[edge] {kname} 2^-120x2^120: gated to an exact kernel, err / "
        f"limit {ratio:.4f} (the tensor-core kernel: {tc_ratio:.4f})")
    return ratio, tc_ratio


def flag_path(wrapper):
    """The path the last tensor-core call of ``wrapper`` took: its flag
    (``wrapper.flag``, read here, after the call) up means the gated
    exact kernel rewrote C."""
    return "exact" if int(wrapper.flag.item()) else "tensor cores"


def overflow_check(kname, fn, args, ref, ref_args, absd):
    """Finite operands whose products pass FLT_MAX (all-positive A, B's
    columns of alternating sign, so no sum cancels), through the entry
    point: the result's infinities, their signs and its NaNs are the
    plain version's, and its finite entries within 64 eps (|A| |B|).
    Returns the number of infinities."""
    y = fn(*args)
    torch.cuda.synchronize()
    yp = ref(*ref_args)
    inf = torch.isinf(yp)
    require(bool(inf.any()), f"{kname} overflow: no product passed FLT_MAX")
    require(torch.equal(torch.isnan(y), torch.isnan(yp))
            and torch.equal(torch.isinf(y), inf)
            and torch.equal(torch.sign(y[inf]), torch.sign(yp[inf])),
            f"{kname} overflow: infinities or NaNs differ from the plain "
            f"version")
    fin = torch.isfinite(yp)
    if bool(fin.any()):
        limit_check(y[fin], yp[fin], absd[fin])
    return int(inf.sum())


def b_side_limits(kname, entry, ref, a_hi, a_big, b, wrapper, per):
    """The dense B at the edges of the f32 range, through the entry
    point, held: the tensor-core kernel (``wrapper`` adds ``per`` a call
    to its ``launches``, and one to its ``gated``) tests B as it splits it and raises the call's flag, and the gated
    exact kernel behind it then rewrites C (``csrc/tf32_mma.cuh``,
    Limits).  A scaled by 2^120 (all positive) against B scaled by
    2^-120: finite, within 64 eps (|A| |B|); A scaled by 2^16 against
    pairs of B rows of +inf and -inf: the plain version's infinities
    (with its signs) and NaNs, no NaN where it has an infinity.  Each
    call must raise the flag.  Returns (err / limit, NaNs at the plain
    version's infinities)."""
    before, gated = wrapper.launches, wrapper.gated
    b_lo = b * 2.0 ** -120
    yp = ref(a_hi, b_lo)
    y = entry(a_hi, b_lo)
    torch.cuda.synchronize()
    require(flag_path(wrapper) == "exact",
            f"{kname} B 2^-120: the flag did not rise")
    require(bool(torch.isfinite(y).all()), f"{kname} B 2^-120: not finite")
    _, ratio = limit_check(y, yp, yp)
    b_inf = b.clone()
    b_inf[500::1000] = float("inf")
    b_inf[501::1000] = -float("inf")
    yp = ref(a_big, b_inf)
    y = entry(a_big, b_inf)
    torch.cuda.synchronize()
    require(flag_path(wrapper) == "exact",
            f"{kname} B inf: the flag did not rise")
    require(wrapper.launches == before + 2 * per
            and wrapper.gated == gated + 2,
            f"{kname} B edges: not run on the tensor-core kernel with the "
            f"gated exact kernel behind it")
    inf = torch.isinf(yp)
    nans = int((torch.isnan(y) & inf).sum())
    require(bool(inf.any()) and bool(torch.isnan(yp).any())
            and torch.equal(torch.isnan(y), torch.isnan(yp))
            and torch.equal(torch.isinf(y), inf)
            and torch.equal(torch.sign(y[inf]), torch.sign(yp[inf])),
            f"{kname} B inf: {nans} NaNs where the plain version has an "
            f"infinity, or other infinities or NaNs")
    log(f"[edge] {kname} B 2^-120 against A 2^120: flag up, exact kernel, "
        f"err / limit {ratio:.4f}; B infinities against A 2^16: flag up, "
        f"{int(inf.sum())} infinities and {int(torch.isnan(yp).sum())} "
        f"NaNs as the plain version, {nans} NaNs for an infinity")
    return ratio, nans


def edges_phase():
    """The three 3xTF32 kernels (``band_spmm_stream``, the f32
    ``bsr_spmm``, the f32 ``bsr_spgemm``) at the edges of the f32 range:
    A with +-FLT_MAX entries (one a row of C, against factors below 1/2)
    and infinite A entries against B rows with zeros, on the kernels, the
    dense B within the test's limit for A's finite values (the flag stays
    down); A scaled by 2^-120 against B scaled by 2^120 through the entry
    points, whose ``tf32_exact`` gate routes it to an exact kernel; the
    dense B at 2^-120 and infinite against large A (``b_side_limits``)
    and finite operands whose products pass FLT_MAX (``overflow_check``)
    through the entry points, where the kernels' test of B (the block
    SpGEMM's host test of both maxima) sends them to the exact kernels.
    Returns {kernel: {mode: err / limit, or a count}}."""
    fmax = torch.finfo(torch.float32).max
    out = {}
    # the band: panel column W // 2 (inside the band) of every row
    a = gen.generate_banded_csr(16_384, 16_384, 50, seed=141)
    plan = banded.build_band_plan(a)
    w = plan.panels.shape[1]
    pan = plan.panels.abs()
    b = dense_operands(plan.shape[1], 64, 142)[0] / 200     # [0, 0.5)
    big = pan.clone()
    big[0::2, w // 2] = fmax
    big[1::2, w // 2] = -fmax
    inf = pan.clone()
    inf[0::3, w // 2] = float("inf")
    inf[1::3, w // 2] = -float("inf")
    bz = b.clone()
    bz[::5] = 0.0
    bp, bzp = banded.pad_b(plan, b), banded.pad_b(plan, bz)
    stream, ref = banded.band_spmm_stream_padded, banded.band_spmm_reference
    # A's infinities are the entry point's gate to route (tf32_exact); the
    # kernel is held on them with B tested against A's finite values
    fin = functools.partial(stream, amax=float(pan.max()))
    out["band_spmm_stream"] = {
        "flt_max": edge_check("band_spmm_stream", "flt_max",
                              functools.partial(stream, amax=fmax), ref,
                              (big, bp), (big.abs(), bp)),
        "inf": edge_check("band_spmm_stream", "inf", fin, ref, (inf, bzp),
                          None)}
    require(flag_path(stream) == "tensor cores",
            "band edges: the flag rose on a B inside the limit")
    lo_plan = dataclasses.replace(plan, panels=pan * 2.0 ** -120)
    require(not lo_plan.tf32_exact, "band 2^-120: the gate did not fire")
    b_hi = b * 2.0 ** 120
    bp_hi = banded.pad_b(lo_plan, b_hi)
    m = plan.shape[0]
    before, gated = banded.band_spmm_padded.launches, stream.gated
    out["band_spmm_stream"]["2^-120x2^120"], \
        out["band_spmm_stream"]["2^-120x2^120_tc"] = low_end_check(
            "band_spmm_stream", banded.band_spmm_stream, (lo_plan, b_hi),
            functools.partial(stream, amax=float(lo_plan.panels.max())),
            (lo_plan.panels, bp_hi),
            lambda p, bb: ref(p, bb)[:m],
            (lo_plan.panels, bp_hi))
    # the gate's FMA launch, and the tensor-core call's gated one
    require(banded.band_spmm_padded.launches == before + 1
            and stream.gated == gated + 1,
            "band 2^-120: not routed to the FMA kernel")
    hi_plan = dataclasses.replace(plan, panels=pan * 2.0 ** 120)
    big_plan = dataclasses.replace(plan, panels=plan.panels * 2.0 ** 16)
    require(hi_plan.tf32_exact and big_plan.tf32_exact,
            "band B edges: the panels' gate fired")
    full = lambda p, bb: ref(p.panels, banded.pad_b(p, bb))[:m]  # noqa: E731
    out["band_spmm_stream"].update(zip(
        ("B_2^-120", "B_inf_nans"), b_side_limits(
            "band_spmm_stream", banded.band_spmm_stream, full, hi_plan,
            big_plan, b, stream, 1)))
    # finite products past FLT_MAX: |A| 2^64 against B 2^70, B's columns
    # of alternating sign
    sign = 1.0 - 2.0 * (torch.arange(b.shape[1], device=DEVICE) % 2)
    ov_plan = dataclasses.replace(plan, panels=pan * 2.0 ** 64)
    b_ov = (b + 0.25) * sign * 2.0 ** 70
    out["band_spmm_stream"]["overflow_infs"] = overflow_check(
        "band_spmm_stream", banded.band_spmm_stream, (ov_plan, b_ov), full,
        (ov_plan, b_ov), full(dataclasses.replace(
            ov_plan, panels=ov_plan.panels.abs()), b_ov.abs()))
    require(flag_path(stream) == "exact",
            "band overflow: the flag did not rise")
    log(f"[edge] band_spmm_stream products past FLT_MAX: flag up, exact "
        f"kernel, {out['band_spmm_stream']['overflow_infs']} infinities "
        f"as the plain version")
    del a, plan, lo_plan, hi_plan, big_plan, ov_plan, pan, big, inf, bp, \
        bzp, bp_hi
    # BSR SpMM: column 64 of the first block of each block row
    a = random_bsr(512, 64, 4, (8, 128), 0, 143)
    v, rp, ci = a.values.abs(), a.block_rowptr, a.block_colind
    first = rp[:-1].long()
    b = dense_operands(a.shape[1], 64, 144)[0] / 200
    big = v.clone()
    big[first[0::2], :, 64] = fmax
    big[first[1::2], :, 64] = -fmax
    inf = v.clone()
    inf[first[0::3], :, 64] = float("inf")
    inf[first[1::3], :, 64] = -float("inf")
    bz = b.clone()
    bz[64::7] = 0.0
    blocks = bk.bsr_spmm_blocks
    fn = functools.partial(blocks, column_order=a.column_order)
    ref = bk.bsr_spmm_reference
    out["bsr_spmm"] = {
        "flt_max": edge_check("bsr_spmm", "flt_max",
                              functools.partial(fn, amax=fmax), ref,
                              (big, rp, ci, b), (big.abs(), rp, ci, b)),
        "inf": edge_check("bsr_spmm", "inf",
                          functools.partial(fn, amax=float(v.max())), ref,
                          (inf, rp, ci, bz), None)}
    require(flag_path(blocks) == "tensor cores",
            "bsr edges: the flag rose on a B inside the limit")
    a_lo = dataclasses.replace(a, values=v * 2.0 ** -120)
    require(not a_lo.tf32_exact, "bsr 2^-120: the gate did not fire")
    b_hi = b * 2.0 ** 120
    before, gated = blocks.launches, blocks.gated
    out["bsr_spmm"]["2^-120x2^120"], out["bsr_spmm"]["2^-120x2^120_tc"] = \
        low_end_check("bsr_spmm", bk.bsr_spmm, (a_lo, b_hi),
                      functools.partial(fn, amax=a_lo.tf32_amax),
                      (a_lo.values, rp, ci, b_hi), ref,
                      (a_lo.values, rp, ci, b_hi))
    # the gate's FMA launch; the tensor-core call's two and its gated one
    require(blocks.launches == before + 3 and blocks.gated == gated + 1,
            "bsr 2^-120: not routed to the FMA kernel (1 launch)")
    a_hi = dataclasses.replace(a, values=v * 2.0 ** 120)
    a_big = dataclasses.replace(a, values=a.values * 2.0 ** 16)
    require(a_hi.tf32_exact and a_big.tf32_exact,
            "bsr B edges: the blocks' gate fired")
    full = lambda o, bb: ref(o.values, rp, ci, bb)  # noqa: E731
    out["bsr_spmm"].update(zip(
        ("B_2^-120", "B_inf_nans"), b_side_limits(
            "bsr_spmm", bk.bsr_spmm, full, a_hi, a_big, b, blocks, 2)))
    sign = 1.0 - 2.0 * (torch.arange(b.shape[1], device=DEVICE) % 2)
    a_ov = dataclasses.replace(a, values=v * 2.0 ** 64)
    b_ov = (b + 0.25) * sign * 2.0 ** 70
    out["bsr_spmm"]["overflow_infs"] = overflow_check(
        "bsr_spmm", bk.bsr_spmm, (a_ov, b_ov), full, (a_ov, b_ov),
        ref(a_ov.values, rp, ci, b_ov.abs()))
    require(flag_path(blocks) == "exact",
            "bsr overflow: the flag did not rise")
    log(f"[edge] bsr_spmm products past FLT_MAX: flag up, exact kernel, "
        f"{out['bsr_spmm']['overflow_infs']} infinities as the plain "
        f"version")
    del a, a_hi, a_big, a_ov, v, big, inf, b, bz
    # block SpGEMM: column 64 of A's first block in each block row meets
    # each B block of that block column once
    a = random_bsr(16, 16, 4, (128, 128), 0, 145)
    bb = random_bsr(16, 16, 4, (128, 128), 0, 146)
    plan = bsg.bsr_spgemm_compute(a, bb)
    args = (plan.pair_ptr, plan.pair_a, plan.pair_b)
    av = a.values.abs()
    bv = bb.values.abs() / (2 * float(bb.values.abs().max()))
    first = a.block_rowptr[:-1].long()
    big = av.clone()
    big[first[0::2], :, 64] = fmax
    big[first[1::2], :, 64] = -fmax
    inf = av.clone()
    inf[first[0::3], :, 64] = float("inf")
    inf[first[1::3], :, 64] = -float("inf")
    bz = bv.clone()
    bz[:, 64, ::3] = 0.0
    fn, ref = bsg.bsr_spgemm_blocks, bsg.bsr_spgemm_reference
    out["bsr_spgemm"] = {
        "flt_max": edge_check("bsr_spgemm", "flt_max", fn, ref,
                              args + (big, bv), args + (big.abs(), bv)),
        "inf": edge_check("bsr_spgemm", "inf", fn, ref, args + (inf, bz),
                          None)}
    a_lo = dataclasses.replace(a, values=a.values.abs() * 2.0 ** -120)
    b_hi = dataclasses.replace(bb, values=bv * 2.0 ** 120)
    require(not a_lo.tf32_exact, "bsr_spgemm 2^-120: the gate did not fire")
    nc = plan.nnzb_c
    out["bsr_spgemm"]["2^-120x2^120"], \
        out["bsr_spgemm"]["2^-120x2^120_tc"] = low_end_check(
            "bsr_spgemm", lambda *p: bsg.bsr_spgemm_numeric(*p).values[:nc],
            (plan, a_lo, b_hi), fn, args + (a_lo.values, b_hi.values), ref,
            args + (a_lo.values, b_hi.values))
    # finite products past FLT_MAX: both operands sparse, so the host's
    # test of the two cached maxima sends them to the f64 kernel
    a_ov = dataclasses.replace(a, values=av * 2.0 ** 64)
    sgn = 1.0 - 2.0 * (torch.arange(128, device=DEVICE) % 2)
    b_ov = dataclasses.replace(bb, values=(bv + 0.25) * sgn * 2.0 ** 70)
    require(a_ov.tf32_exact and b_ov.tf32_exact and not
            _t.tf32_products_safe(a_ov.tf32_amax, b_ov.tf32_amax),
            "bsr_spgemm overflow: the host test did not fire")
    out["bsr_spgemm"]["overflow_infs"] = overflow_check(
        "bsr_spgemm", lambda *p: bsg.bsr_spgemm_numeric(*p).values[:nc],
        (plan, a_ov, b_ov), ref, args + (a_ov.values, b_ov.values),
        ref(*args, a_ov.values, b_ov.values.abs()))
    log(f"[edge] bsr_spgemm products past FLT_MAX: the host test sends "
        f"them to the f64 kernel, {out['bsr_spgemm']['overflow_infs']} "
        f"infinities as the plain version")
    torch.cuda.empty_cache()
    emit({"edges": out})
    return out


def fem_bsr(side, dtype, seed):
    """3x3 blocks on the 27-point connectivity of a side^3 node grid (node
    x + side*y + side^2*z couples to every node within one step in each
    coordinate), a BSR on the card with seeded standard normal values:
    block row i holds its neighbours in column order."""
    nodes = side ** 3
    i = torch.arange(nodes, device=DEVICE)
    xyz = torch.stack([i % side, i // side % side, i // side ** 2], 1)
    d = torch.tensor([-1, 0, 1], device=DEVICE)
    dz, dy, dx = torch.meshgrid(d, d, d, indexing="ij")
    step = torch.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)], 1)
    nb = xyz[:, None, :] + step[None]                     # (nodes, 27, 3)
    ok = ((nb >= 0) & (nb < side)).all(2)
    cols = (nb[..., 0] + side * nb[..., 1] + side ** 2 * nb[..., 2])[ok]
    rowptr = torch.zeros(nodes + 1, dtype=torch.int64, device=DEVICE)
    rowptr[1:] = torch.cumsum(ok.sum(1), 0)
    nnzb = int(cols.numel())
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    vals = torch.randn(nnzb, 3, 3, generator=g, device=DEVICE, dtype=dtype)
    return BSR(values=vals, block_rowptr=rowptr.to(torch.int32),
               block_colind=cols.to(torch.int32), nnz_blocks=nnzb,
               shape=(3 * nodes, 3 * nodes), block_shape=(3, 3))


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


def random_bsr(mb, nbc, per_row, block, empty_every, seed,
               dtype=torch.float32):
    """A BSR on the card with ``per_row`` seeded blocks of standard normal
    values (drawn in f32, then held in ``dtype``) in every block row but
    each ``empty_every``-th (none for 0), which stays empty."""
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
    return BSR(values=torch.from_numpy(vals).to(DEVICE, dtype),
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

def main_path(name, a, kind, seed, card, ref=None, opt=None):
    """``multiply(scaled(2.0, matrix_opt(A)), x)``: the chooser must pick
    ``kind`` (None: any, recorded); the result is held against the
    float64 base path of ``ref`` (default ``a``: another container of
    the same matrix, e.g. a lazy flip of what ``a`` materializes).
    ``opt``: the ``matrix_opt`` handle to use (a later SpMM main path
    on the same handle reuses a structured plan, as users' code does)."""
    cx = a.dtype.is_complex
    x = gen.generate_vector(a.shape[1], seed=seed, complex_=cx)
    opt = sp.matrix_opt(a) if opt is None else opt
    reset_launches()
    t0 = time.perf_counter()
    y = sp.multiply(sp.scaled(2.0, opt), x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches(kind)
    got, plan = opt._plans["matvec"]
    log(f"[main] {name}: kind {got}, launches {launches}")
    require(kind is None or got == kind,
            f"{name}: chooser picked {got!r}, want {kind!r}")
    require(y.shape == (a.shape[0],) and y.dtype == a.dtype
            and bool(torch.isfinite(y).all()), f"{name}: bad result")
    # reference: the port's own base path in float64 on the card
    r = a if ref is None else ref
    a64 = dataclasses.replace(r, values=_wide(r.values))
    y_ref = sp.multiply(sp.scaled(2.0, a64), _wide(x))
    absdot = sp.multiply(dataclasses.replace(r, values=r.values.abs()
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
    intermediates stay near 4 GB; returns (max |C - C_ref|, the largest
    err / limit)."""
    a64 = dataclasses.replace(a, values=_wide(a.values))
    a_abs = dataclasses.replace(a, values=a.values.abs().double())
    width = 32 if a.dtype.is_complex else 16
    cb = max(1, int(4e9 // (a.capacity * width)))
    err = ratio = 0.0
    for j in range(0, b.shape[1], cb):
        bj = b[:, j:j + cb]
        ref = sp.multiply(sp.scaled(scale, a64), _wide(bj))
        absd = sp.multiply(a_abs, bj.abs().double())
        e, r = limit_check(c[:, j:j + cb], ref, absd, scale=scale)
        err, ratio = max(err, e), max(ratio, r)
        del ref, absd
    return err, ratio


def main_path_spmm(name, a, kind, k, seed, card, opt=None, expect=None):
    """``multiply(scaled(2.0, matrix_opt(A)), B)``: the first call (plan
    build included, unless ``opt`` already holds one), the check against
    float64, and 20 timed calls over distinct B.  ``expect``: the kernels
    the call must launch, where ``SPMM_KIND_KERNELS`` names others for
    the kind."""
    cx = a.dtype.is_complex
    n = a.shape[1]
    count = max(2, min(20, _SPMM_OPERAND_BYTES // (n * k * (8 if cx
                                                            else 4))))
    bs = dense_operands(n, k, seed, cx, count)
    opt = opt if opt is not None else sp.matrix_opt(a)
    reset_launches()
    t0 = time.perf_counter()
    c = sp.multiply(sp.scaled(2.0, opt), bs[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches(kind)
    got = (opt._plans.get("matmul") or opt._plans["matvec"])[0]
    log(f"[main] {name}: kind {got}, launches {launches}")
    require(got == kind, f"{name}: chooser picked {got!r}, want {kind!r}")
    require(c.shape == (a.shape[0], k) and c.dtype == a.dtype
            and bool(torch.isfinite(c).all()), f"{name}: bad result")
    err, ratio = spmm_check(a, bs[0], c, 2.0)
    log(f"[check] {name}: in bound, err / limit {ratio:.4f}")
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
           "max_abs_err_vs_f64": err, "max_err_over_limit": ratio,
           "first_call_s": first_s, "ms": ms,
           "distinct_b": count,
           "flop_s": 2 * a.nnz * k / (ms * 1e-3), "card": card}
    if expect is not None:
        rec["kernels"] = list(expect)
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


def hub_race(kname, name, run, ref, absdot, stream):
    """The slot fill's hub tier raced: ``run()`` ``RACE_RUNS`` times back
    to back on the card, every result held per slot against the plain
    version and bit-equal to the first (a segment counted in before its
    partial lands, or a counter left behind, gives a wrong or changing
    hub slot), and every arrival counter back at 0."""
    results = [run() for _ in range(RACE_RUNS)]
    torch.cuda.synchronize()
    err = max(row_check(y, ref, absdot) for y in results)
    require(all(torch.equal(y, results[0]) for y in results),
            f"{kname} {name}: hub tier runs differ")
    require(stream.nseg > 0 and not bool(stream.hub_count.any()),
            f"{kname} {name}: no hub segment, or a counter left behind")
    log(f"[race] {kname} {name}: {RACE_RUNS} runs of the hub tier "
        f"({stream.nseg} segments) in bound and bit-equal, max |err| "
        f"{err:.3e}")


def mul_case(name, plan, a_arr, b_arr, rates, card, lib_ms=None,
             race=False):
    """``route2_mul`` on a resident mul plan (one launch of the slot fill
    ``mul_fill`` over the plan's expansion stream) against the plain tile
    walker and the plain segmented sum, per slot; one writer a slot, so
    10 runs give the same bits; with ``race``, the hub tier raced.  Two
    bounds: the bytes the slot fill must move, and the tile stream the
    TPU design moves."""
    ex = plan.expansion
    cap = plan.capacity
    before = mf.mul_fill.launches
    c_k = r2k.route2_mul(plan, a_arr, b_arr)
    torch.cuda.synchronize()
    per_call = mf.mul_fill.launches - before
    require(per_call == 1, f"route2_mul {name}: {per_call} launches, want 1")
    same_bits(f"route2_mul {name}", r2k.route2_mul, (plan, a_arr, b_arr))
    a2, b2 = r2k.pack_mul_panes(plan, a_arr, b_arr)
    walker = r2k.route2_mul_reference(plan, a2, b2).view(-1)[:cap]
    walker_abs = r2k.route2_mul_reference(plan, a2.abs(), b2.abs()
                                          ).view(-1)[:cap]
    err = row_check(c_k, walker, walker_abs)
    row_check(c_k, mf.mul_fill_reference(ex, a_arr, b_arr, cap),
              mf.mul_fill_reference(ex, a_arr.abs(), b_arr.abs(), cap))
    log(f"[check] route2_mul {name}: in bound, 10 runs bit-equal, max "
        f"|err| {err:.3e}")
    if race:
        hub_race("route2_mul", name, lambda: r2k.route2_mul(
            plan, a_arr, b_arr), walker, walker_abs, ex)
    del c_k, walker, walker_abs
    # the slot fill reads the index stream (sa, sb, run_start), A and B
    # once and writes c once; the tile stream: both tiles, the per-chunk
    # scalars ab, bb, yb, the A and B panes, the out pane written twice
    # (zeroed, then accumulated)
    ent = int(ex.sa.numel())
    nbytes = (2 * ent + ex.nslots + 1 + cap) * 4 + (ex.a_len + ex.b_len) * 4
    b_ms, b_by = bound(nbytes, 2 * ent, rates)
    nch = plan.nchunks
    tile_bytes = (nch * (8 * 1024 + 12) + (plan.a_rows + plan.b_rows) * 512
                  + 2 * r2k.mul_out_rows(plan) * 512)
    tile_ms, _ = bound(tile_bytes, 2 * nch * 1024, rates)

    def copy():
        return (dataclasses.replace(ex, sa=ex.sa.clone(), sb=ex.sb.clone(),
                                    run_start=ex.run_start.clone()),
                a_arr.clone(), b_arr.clone())

    ins = replicas(copy, nbytes)
    k_ms = device_ms(lambda s_, a_, b_: mf.mul_fill(s_, a_, b_, cap), ins)
    p_ms = device_ms(lambda s_, a_, b_: mf.mul_fill_reference(
        s_, a_, b_, cap), ins)
    del ins
    walk_ms = device_ms(r2k.route2_mul_reference, [(plan, a2, b2)], reps=4)
    torch.cuda.empty_cache()
    return {"kernel": "route2_mul", "case": name, "nchunks": nch,
            "n_aux_chunks": plan.n_aux_chunks,
            "aux_levels": len(plan.launch_starts) - 1, "fill": plan.fill,
            "g_a": plan.g_a, "g_b": plan.g_b, "capacity": cap,
            "entries": ent, "slots": ex.nslots, "longest_run": ex.longest,
            "hub_segments": ex.nseg, "launches_per_call": per_call,
            "same_bits_runs": 10, "raced": RACE_RUNS if race else 0,
            "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tile_stream_bound_ms": tile_ms,
            "plain_ms": p_ms, "tile_walker_plain_ms": walk_ms,
            "library_ms": lib_ms, "card": card}


def paned_walker(plan, a2, b2, fn=rmp.route2_mul_paned_reference):
    """The plain tile walker of a paned plan, panel by panel: each panel's
    first ``slots`` slots, concatenated and zero-padded to the
    capacity."""
    parts = [fn(plan, p, a2, b2).view(-1)[:p.slots] for p in plan.panels]
    out = torch.cat(parts) if parts else a2.new_zeros(0)
    return torch.nn.functional.pad(out, (0, plan.capacity - out.shape[0]))


def mul_paned_case(name, plan, a_arr, b_arr, rates, card, lib_ms=None,
                   race=False):
    """The paned fill (``route2_mul_paned``: one launch of the slot fill
    ``mul_fill`` over the plan's expansion stream) against the plain
    tile walker, per entry; one writer a slot, so two runs give the same
    bits; with ``race``, the hub tier raced.  Two bounds: the bytes the
    slot fill must move, and the tile stream any design that reads the
    ROUTE tiles must move."""
    ex = plan.expansion
    cap = plan.capacity
    before = mf.mul_fill.launches
    c_k = rmp.route2_mul_paned(plan, a_arr, b_arr)
    torch.cuda.synchronize()
    per_call = mf.mul_fill.launches - before
    require(per_call == 1, f"route2_mul_paned {name}: {per_call} "
                           "launches, want 1")
    again = rmp.route2_mul_paned(plan, a_arr, b_arr)
    require(torch.equal(c_k, again),
            f"route2_mul_paned {name}: two runs differ")
    a2, b2 = rmp.pack_mul_panes(plan, a_arr, b_arr)
    walker = paned_walker(plan, a2, b2)
    walker_abs = paned_walker(plan, a2.abs(), b2.abs())
    err = row_check(c_k, walker, walker_abs)
    row_check(c_k, mf.mul_fill_reference(ex, a_arr, b_arr, cap),
              mf.mul_fill_reference(ex, a_arr.abs(), b_arr.abs(), cap))
    log(f"[check] route2_mul_paned {name}: in bound, the same bits twice, "
        f"max |err| {err:.3e}")
    if race:
        hub_race("route2_mul_paned", name, lambda: rmp.route2_mul_paned(
            plan, a_arr, b_arr), walker, walker_abs, ex)
    del c_k, again, walker, walker_abs
    # the slot fill reads the index stream (sa, sb, run_start), A and B
    # once and writes c once; the tile walker's bound reads both tiles,
    # the per-chunk scalars ab, bb, yb, fl, pane, A and B and writes each
    # panel pane twice
    ent = int(ex.sa.numel())
    nbytes = (2 * ent + ex.nslots + 1 + cap) * 4 + (ex.a_len + ex.b_len) * 4
    b_ms, b_by = bound(nbytes, 2 * ent, rates)
    tile_bytes = (plan.a_rows + plan.b_rows_pad) * 512 + sum(
        p.nchunks * (8 * 1024 + 20) + 2 * p.out_rows * 512
        for p in plan.panels)
    tile_ms, _ = bound(tile_bytes, 2 * plan.nchunks * 1024, rates)

    def copy():
        return (dataclasses.replace(ex, sa=ex.sa.clone(), sb=ex.sb.clone(),
                                    run_start=ex.run_start.clone()),
                a_arr.clone(), b_arr.clone())

    ins = replicas(copy, nbytes)
    k_ms = device_ms(lambda s_, a_, b_: mf.mul_fill(s_, a_, b_, cap), ins)
    seg_ms = device_ms(lambda s_, a_, b_: mf.mul_fill_reference(
        s_, a_, b_, cap), ins)
    del ins
    p_ms = device_ms(lambda x2, y2: paned_walker(plan, x2, y2), [(a2, b2)],
                     reps=4)
    torch.cuda.empty_cache()
    return {"kernel": "route2_mul_paned", "case": name,
            "panels": len(plan.panels),
            "panes": plan.b_rows_pad // plan.pane_rows,
            "nchunks": plan.nchunks, "fill": plan.fill, "g_a": plan.g_a,
            "g_b": plan.g_b,
            "aux_levels": max(len(p.launch_starts) - 1 for p in plan.panels),
            "panels_with_aux": sum(p.has_aux for p in plan.panels),
            "entries": ent, "slots": ex.nslots, "capacity": cap,
            "longest_run": ex.longest, "hub_segments": ex.nseg,
            "raced": RACE_RUNS if race else 0,
            "launches_per_call": per_call, "max_abs_err": err,
            "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
            "tile_stream_bound_ms": tile_ms, "plain_ms": p_ms,
            "segmented_sum_plain_ms": seg_ms, "library_ms": lib_ms,
            "card": card}


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

    reset_launches()
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
    launches = read_launches(kind)
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
    same_bits(f"bsr_spgemm {name} {tname}", bsg.bsr_spgemm_blocks,
              args + (av, bv))
    bh, bk_ = a.block_shape
    bw = b.block_shape[1]
    esz = av.element_size()
    npairs = plan.npairs
    # the stored A and B blocks, the pair lists and C, each once
    nbytes = ((a.nnz_blocks * bh * bk_ + b.nnz_blocks * bk_ * bw
               + plan.nnzb_c * bh * bw) * esz + npairs * 8
              + (plan.nnzb_c + 1) * 4)
    flops = 2 * npairs * bh * bk_ * bw
    # the f32 peak bounds the f32 case, the f64 peak the f64 one; each
    # also on the tensor cores (three TF32 products; the FP64 ones)
    b_ms, b_by = bound(nbytes, flops, rates, f64=dtype == torch.float64)
    tc_ms, tc_by = (tc_bound(nbytes, flops, rates)
                    if dtype == torch.float32
                    else dmma_bound(nbytes, flops, rates))
    ins = replicas(lambda: args + (av.clone(), bv.clone()), nbytes)
    k_ms = device_ms(bsg.bsr_spgemm_blocks, ins, reps=10)
    p_ms = device_ms(bsg.bsr_spgemm_reference, ins[:1], reps=2)
    del ins
    torch.cuda.empty_cache()
    # cuSPARSE SpGEMM on the two CSR forms in the case's dtype, its
    # symbolic pass included (a yardstick only: where it needs more than
    # the card holds, the record says so)
    l_ms, l_err = None, None
    try:
        ca, cb = (dataclasses.replace(c, values=c.values.to(dtype))
                  for c in (bsr_to_csr(a), bsr_to_csr(b)))
        l_ms = library_spgemm_ms(ca, cb)
    except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
        l_err = str(e).splitlines()[0][:160]
        log(f"[library] bsr_spgemm {name} {tname}: cuSPARSE SpGEMM failed "
            f"({l_err})")
    ca = cb = None
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
            "bound_by": b_by, "tc_bound_ms": tc_ms, "tc_bound_by": tc_by,
            "plain_ms": p_ms, "library_ms": l_ms, "library_error": l_err,
            "flop_s": flops / (k_ms * 1e-3), "card": card}


def bsr_spgemm_main(name, a, b, card):
    """``multiply(scaled(2.0, A), B)`` on two BSR operands: counts read
    around the first call, C held per entry against the float64 plain
    sums, then 20 calls over distinct A values timed, host (the block
    symbolic phase) included."""
    reset_launches()
    t0 = time.perf_counter()
    c = sp.multiply(sp.scaled(2.0, a), b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches("bsr")
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
    records, kernel records, deferred structure differences, and the
    100k cell's matrix, plan and cuSPARSE ms, which phase D holds its
    distributed product to)."""
    main, recs, deferred, cells = [], [], [], {}
    for name, make, kind, expect in SPGEMM_MAIN:
        a = make()
        rec, info, a0_vals = spgemm_main(name, a, kind, expect, rates,
                                         card, deferred)
        main.append(rec)
        a_arr = torch.cat([2.0 * a0_vals, a0_vals.new_ones(1)])
        case = mul_case if kind == "resident" else mul_paned_case
        recs.append(case(name, info.plan.route, a_arr, a.values, rates,
                         card, rec["cusparse_spgemm_ms_with_symbolic"]))
        if name == SPGEMM_MAIN[1][0]:
            cells[name] = (a, info, rec["cusparse_spgemm_ms_with_symbolic"])
        del info, a
        torch.cuda.empty_cache()
    n_ent, cap, hubs, a_len, b_len, seed = MUL_HUB
    slots, sa, sb, av, bv = mul_hub_stream(n_ent, cap, hubs, a_len, b_len,
                                           seed)
    plan = route2.build_route2_mul_plan(slots, sa, sb, a_len, b_len, cap,
                                        device=DEVICE)
    recs.append(mul_case("hub_slots_aux", plan, av, bv, rates, card,
                         race=True))
    require(recs[-1]["aux_levels"] > 1,
            "route2_mul hub fixture has fewer than two aux levels")
    n_ent, cap, hubs, a_len, b_len, seed, kw = MUL_PANED_HUB
    slots, sa, sb, av, bv = mul_hub_stream(n_ent, cap, hubs, a_len, b_len,
                                           seed)
    plan = rmp.build_route2_mul_paned_plan(slots, sa, sb, a_len, b_len,
                                           cap, device=DEVICE, **kw)
    recs.append(mul_paned_case("hub_slots_paned", plan, av, bv, rates,
                               card, race=True))
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
    for name, sa_args, sb_args in BSR_SPGEMM_ONLY:
        a, b = random_bsr(*sa_args), random_bsr(*sb_args)
        for dt in (torch.float32, torch.float64):
            recs.append(bsr_spgemm_case(name, a, b, rates, card, dt))
            require(recs[-1]["empty_block_rows"] > 0,
                    f"bsr_spgemm {name}: no empty block row")
        del a, b
    torch.cuda.empty_cache()
    return main, recs, deferred, cells


def route_mul_case(name, plan, a_arr, b_arr, rates, card, lib_ms=None):
    """``route_mul`` (the ROUTE v1 SpGEMM numeric: one launch of the slot
    fill ``mul_fill`` over the plan's expansion stream) against the plain
    tile walker and the plain segmented sum, per slot; one owner a slot,
    so 10 runs give the same bits.  Two bounds: the bytes the slot fill
    must move, and the tile stream the TPU design moves."""
    ex = plan.expansion
    cap = plan.capacity
    before = mf.mul_fill.launches
    c_k = rmk.route_mul(plan, a_arr, b_arr)
    torch.cuda.synchronize()
    per_call = mf.mul_fill.launches - before
    require(per_call == 1, f"route_mul {name}: {per_call} launches, want 1")
    same_bits(f"route_mul {name}", rmk.route_mul, (plan, a_arr, b_arr))
    a2 = rmk.pad_pane(a_arr, plan.a_rows)
    b2 = rmk.pad_pane(b_arr, plan.b_rows)
    err = row_check(c_k, rmk.route_mul_reference(plan, a2, b2).view(-1)[:cap],
                    rmk.route_mul_reference(plan, a2.abs(), b2.abs())
                    .view(-1)[:cap])
    row_check(c_k, mf.mul_fill_reference(ex, a_arr, b_arr, cap),
              mf.mul_fill_reference(ex, a_arr.abs(), b_arr.abs(), cap))
    log(f"[check] route_mul {name}: in bound, 10 runs bit-equal, max |err| "
        f"{err:.3e}")
    del c_k
    ob = plan.o_base.long()
    per_window = int(torch.bincount(ob).max())
    # the slot fill reads the index stream (sa, sb, run_start), A and B
    # once and writes c once; the tile stream: three tiles, the per-chunk
    # scalars ab, bb, ob, the A and B panes, the out pane written twice
    # (zeroed, then accumulated)
    ent = int(ex.sa.numel())
    nbytes = (2 * ent + ex.nslots + 1 + cap) * 4 + (ex.a_len + ex.b_len) * 4
    b_ms, b_by = bound(nbytes, 2 * ent, rates)
    nch = plan.nchunks
    tile_bytes = (nch * (12 * 1024 + 12) + (plan.a_rows + plan.b_rows) * 512
                  + 2 * plan.out_rows * 512)
    tile_ms, _ = bound(tile_bytes, 2 * nch * 1024, rates)

    def copy():
        return (dataclasses.replace(ex, sa=ex.sa.clone(), sb=ex.sb.clone(),
                                    run_start=ex.run_start.clone()),
                a_arr.clone(), b_arr.clone())

    ins = replicas(copy, nbytes)
    k_ms = device_ms(lambda s_, a_, b_: mf.mul_fill(s_, a_, b_, cap), ins)
    p_ms = device_ms(lambda s_, a_, b_: mf.mul_fill_reference(
        s_, a_, b_, cap), ins)
    del ins
    walk_ms = device_ms(rmk.route_mul_reference, [(plan, a2, b2)], reps=4)
    torch.cuda.empty_cache()
    return {"kernel": "route_mul", "case": name, "nchunks": nch,
            "fill": plan.fill, "g_a": plan.g_a, "g_b": plan.g_b,
            "capacity": cap, "max_chunks_per_window": per_window,
            "entries": ent, "slots": ex.nslots,
            "longest_run": int(ex.run_start.diff().max()) if ex.nslots
            else 0, "launches_per_call": per_call, "same_bits_runs": 10,
            "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tile_stream_bound_ms": tile_ms,
            "plain_ms": p_ms, "tile_walker_plain_ms": walk_ms,
            "library_ms": lib_ms, "card": card}


def v1_build_parts(plan, reps=3):
    """Host seconds (best of ``reps``) of ``build_route_mul_plan`` from
    the plan's own slot-sorted stream, and of the ``build_slot_stream``
    inside it: what keeping the CUDA fill's stream adds to the v1 plan
    build, beside the tiles."""
    ex = plan.expansion
    slots = np.repeat(np.arange(ex.nslots),
                      ex.run_start.diff().cpu().numpy())
    sa, sb = ex.sa.cpu().numpy(), ex.sb.cpu().numpy()
    out = {}
    for key, fn in (("slot_stream_build_s", lambda: mf.build_slot_stream(
            slots, sa, sb, ex.a_len, ex.b_len, DEVICE)),
                    ("plan_from_stream_s", lambda: rml.build_route_mul_plan(
            slots, sa, sb, ex.a_len, ex.b_len, plan.capacity,
            device=DEVICE))):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        out[key] = best
    return out


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
    recs[0].update(v1_build_parts(info.plan.route))
    log(f"[build] route_mul {name}: plan from its stream "
        f"{recs[0]['plan_from_stream_s']:.4f} s, of which the slot stream "
        f"{recs[0]['slot_stream_build_s']:.4f} s (engine build "
        f"{rec['engine_build_s']:.3f} s)")
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


def solve_bound(a, plan, d, pane, x_p):
    """Per row, how far the solve kernel may stand from its plain
    version ``x_p``: twice (I - |C|)^{-1} 64 eps (|y0| + |C| |x|), C the
    baked coefficients -a_ij/d_i, since both round each level's sums and
    feed them to the next."""
    m = a.shape[0]
    xp = x_p.view(-1)[:m]
    off = abs_csr(a, torch.float32)
    off = dataclasses.replace(off, values=torch.where(
        a.colind.long() == a.row_ids().long(), 0.0, off.values))
    cx = sp.multiply(off, xp.abs()) / d.abs()
    z = r2k.route2_solve_reference(dataclasses.replace(
        plan, val=plan.val.abs()), solve_pane(
        plan, 64 * EPS32 * (pane[:m].abs() + cx)))
    return 2 * z.view(-1)[:m].double()


def route2_solve_case(name, a, info, b, rates, card, lib_ms, race=False):
    """``route2_solve`` (the persistent solve kernel of route2_spmv.cu,
    one launch a solve) on the main path's plan against its plain
    version, level by level, within :func:`solve_bound`; with ``race``
    also 50 solves back to back, every one held to the same bound."""
    plan = info.plan.route
    d = a.values[info.plan.route_diag.long()]
    pane = solve_pane(plan, b / d)
    before = r2k.route2_solve_padded.launches
    x_k = r2k.route2_solve_padded(plan, pane)
    torch.cuda.synchronize()
    per_call = r2k.route2_solve_padded.launches - before
    require(per_call == 1, f"route2_solve {name}: {per_call} launches, "
                           "want 1")
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
    lim = solve_bound(a, plan, d, pane, x_p)
    err_v = (x_k - x_p).abs().view(-1)[:m].double()
    bad = int((err_v > lim).sum())
    require(bad == 0, f"route2_solve {name}: {bad} rows past the bound")
    err = float(err_v.max())
    log(f"[check] route2_solve {name}: in bound, max |err| {err:.3e}")
    if race:
        # race_check's bound is 64 eps times its last argument
        race_check(f"route2_solve {name}",
                   lambda: r2k.route2_solve_padded(plan, pane).view(-1)[:m],
                   x_p.view(-1)[:m], lim / (64 * EPS32))
    del x_k, x_p, lim
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
    work = plan.solve_work
    return {"kernel": "route2_solve", "case": name, "m": m,
            "nchunks": nch, "levels": info.plan.num_levels,
            "launch_ranges": len(plan.launch_starts),
            "steps": work.nsteps, "items": work.nitems,
            "stretch": work.stretch,
            "n_aux_chunks": plan.n_aux_chunks, "fill": plan.fill,
            "g": plan.g, "launches_per_call": per_call,
            "race_runs": RACE_RUNS if race else 0,
            "max_abs_err": err, "kernel_ms": k_ms, "bound_ms": b_ms,
            "bound_by": b_by, "plain_ms": p_ms, "library_ms": lib_ms,
            "card": card}


def hub_factor(a, count, degree, seed):
    """The lower factor ``a`` with ``count`` rows given ``degree`` more
    random columns below the diagonal each (values U[-1, 1), duplicates
    merged), as a CSR on the card: their (row, window) segments pass the
    packer's hub threshold, so the solve plan has aux levels."""
    m = a.shape[0]
    rng = np.random.default_rng(seed)
    nnz = a.nnz
    rows = np.repeat(np.arange(m), np.diff(np.minimum(
        a.rowptr.cpu().numpy().astype(np.int64), nnz)))
    hubs = rng.choice(np.arange(m // 2, m), count, replace=False)
    hr = np.repeat(hubs, degree)
    hc = (rng.random(len(hr)) * hr).astype(np.int64)
    cols = np.concatenate([a.colind[:nnz].cpu().numpy(), hc])
    vals = np.concatenate([a.values[:nnz].cpu().numpy(), rng.uniform(
        -1, 1, len(hr)).astype(np.float32)])
    rows = np.concatenate([rows, hr])
    _, idx = np.unique(rows * m + cols, return_index=True)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows[idx],
                                                        minlength=m))])
    return CSR.from_arrays(vals[idx], rowptr, cols[idx], (m, m),
                           nnz=len(idx), device=a.device)


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
    reset_launches()
    t0 = time.perf_counter()
    x = sp.triangular_solve(sp.scaled(2.0, a), bs[0], info=info)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches(kind)
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
        kern = route2_solve_case(name, a, info, bs[0], rates, card, lib_ms,
                                 race=name == TRSV_MAIN[0][0])
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
        if name == TRSV_MAIN[0][0]:
            # the same factor with hub rows: aux levels in the solve
            hname, count, degree, seed = TRSV_HUB
            ha = hub_factor(a, count, degree, seed)
            info = sp.triangular_solve_inspect(ha)
            require(info.plan.route is not None
                    and info.plan.route.n_aux_chunks > 0,
                    f"{hname}: no route solve plan with aux levels")
            hb = gen.generate_vector(ha.shape[0], seed=210)
            # cuSPARSE's SpSV on the same factor, as the 20k one is timed
            lib_ms, lib_why = library_trsv_ms(ha, hb)
            recs.append(route2_solve_case(hname, ha, info, hb, rates, card,
                                          lib_ms, race=True))
            recs[-1]["library_note"] = lib_why
            del ha, info, hb
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
    reset_launches()
    t0 = time.perf_counter()
    y = banded.band_power_iterations(plan, x, iters)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches("band")
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


# ------------------------------------------------------------------ #
# the sparse algebra ops (transpose, add), DCSR and ELL: torch ops whose
# results feed the card's kernels through matrix_opt
# ------------------------------------------------------------------ #

def wall_ms(fn, reps):
    """Mean end-to-end ms of ``reps`` calls of ``fn()`` between CUDA
    events, host included (for ops that read nothing to the host)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def sync_ms(fn, reps):
    """Mean host ms of ``reps`` calls of ``fn()`` each ended by a
    synchronize (for ops that read a count to the host)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def library_or_none(what, fn, reps):
    """A PyTorch call's ms as a yardstick (never called by the port), or
    None with the reason when the installed torch refuses it."""
    try:
        return wall_ms(fn, reps), None
    except (RuntimeError, NotImplementedError) as e:
        log(f"[library] {what}: {type(e).__name__}: {str(e)[:200]}")
        return None, f"{type(e).__name__}: {str(e)[:200]}"


def live_keys(a):
    """Packed (row * n + col) keys of a CSR's live entries, on its
    device, in entry order."""
    return (a.row_ids()[:a.nnz].long() * a.shape[1]
            + a.colind[:a.nnz].long())


def transpose_phase(name, a, rates, card):
    """E1: ``transpose(A)`` on the uniform 1M matrix, timed; the same bits
    as ``to_csr(transposed(A))`` (the lazy flip's materialization); the
    structure of a host lexsort by (col, row); then ``multiply(scaled(2.0,
    matrix_opt(transpose(A))), x)`` on the ROUTE2 kernel, held against
    the float64 base path of ``transposed(A)``, and the kernel on that
    plan against its plain version."""
    t0 = time.perf_counter()
    at = sp.transpose(a)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ms = wall_ms(lambda: sp.transpose(a), 20)
    flip = sp.to_csr(sp.transposed(a))
    nnz = a.nnz
    require(at.shape == flip.shape and at.nnz == flip.nnz == nnz
            and torch.equal(at.rowptr, flip.rowptr)
            and torch.equal(at.colind, flip.colind)
            and torch.equal(at.values, flip.values),
            f"{name}: transpose differs from to_csr(transposed(A))")
    rows, cols, vals = host_arrays(a)
    order = np.lexsort((rows, cols))
    want_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        cols, minlength=a.shape[1]))])
    require(np.array_equal(at.rowptr.cpu().numpy(), want_ptr)
            and np.array_equal(at.colind[:nnz].cpu().numpy(), rows[order])
            and np.array_equal(at.values[:nnz].cpu().numpy(), vals[order]),
            f"{name}: transpose differs from the host lexsort")
    del flip, rows, cols, vals, order
    sa = cusparse(a)
    l_ms, l_why = library_or_none(
        "transpose", lambda: sa.t().to_sparse_csr(), 20)
    rec = {"op": "transpose", "case": name, "m": a.shape[0],
           "n": a.shape[1], "nnz": nnz, "first_call_s": first_s, "ms": ms,
           "library_ms": l_ms, "library_note": l_why,
           "same_bits_as_lazy_flip": True, "host_lexsort_structure": True,
           "card": card}
    emit(rec)
    del sa
    main_rec, plan = main_path(f"{name}_transposed", at, "route", 57, card,
                               ref=sp.transposed(a))
    kernel_rec = route2_case(f"{name}_transposed", at, {}, 58, rates, card,
                             plan=plan)
    del at, plan
    torch.cuda.empty_cache()
    return rec, main_rec, kernel_rec


def identity_csr(m):
    """I (m x m) as a CSR on the card."""
    return CSR.from_arrays(torch.ones(m, device=DEVICE),
                           torch.arange(m + 1, device=DEVICE),
                           torch.arange(m, device=DEVICE), (m, m),
                           device=DEVICE)


def shift_phase(name, a, bandwidth, rates, card):
    """E2: the shifted operator C = A - SHIFT * I of the headline band as
    ``add(A, scaled(-SHIFT, I))``: A's structure (the diagonal lies in the
    band), A's values off the diagonal and fl(a_ii - SHIFT) on it, bit
    for bit; then ``multiply(scaled(2.0, matrix_opt(C)), x)`` on the band
    kernel against the float64 base path, and the kernel on that plan
    against its plain version."""
    m = a.shape[0]
    eye = identity_csr(m)
    t0 = time.perf_counter()
    c = sp.add(a, sp.scaled(-SHIFT, eye))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    require(c.nnz == a.nnz and torch.equal(c.rowptr, a.rowptr)
            and torch.equal(c.colind[:a.nnz], a.colind[:a.nnz]),
            f"{name}: the shifted band's structure is not A's")
    diag = (a.colind[:a.nnz] == a.row_ids()[:a.nnz]).nonzero().squeeze(1)
    want = a.values[:a.nnz].clone()
    want[diag] = want[diag] + torch.tensor(-SHIFT, device=DEVICE)
    require(int(diag.numel()) == m and torch.equal(c.values[:a.nnz], want),
            f"{name}: the shifted band's values are not A's minus SHIFT "
            f"on the diagonal")
    info = sp.add_inspect(a, eye)
    ms = sync_ms(lambda: sp.add(a, sp.scaled(-SHIFT, eye)), 5)
    c_ms = wall_ms(lambda: sp.add_compute(info, a, sp.scaled(-SHIFT, eye)),
                   20)
    # the band's rows and I's are column-sorted, as csrgeam2 wants
    sa, si = cusparse(a), cusparse(sp.scale(-SHIFT, eye))
    l_ms, l_why = library_or_none("add", lambda: torch.add(sa, si), 20)
    rec = {"op": "add_shift", "case": name, "m": m, "nnz": c.nnz,
           "shift": SHIFT, "first_call_s": first_s, "ms": ms,
           "compute_ms": c_ms, "library_ms": l_ms, "library_note": l_why,
           "card": card}
    emit(rec)
    del info, eye, want, diag, sa, si
    main_rec, plan = main_path(f"{name}_shifted", c, "band", 59, card)
    kernel_rec = band_case(f"{name}_shifted", m, m, bandwidth, None, 60,
                           rates, card, csr=c, plan=plan)
    del c, plan
    torch.cuda.empty_cache()
    return rec, main_rec, kernel_rec


def union_check(name, c, terms):
    """C against the float64 sum of ``terms`` ((CSR or COO, alpha)) slot
    by slot: every term's (row, col) is in C, and every slot within
    64 * eps * sum |alpha * v| of the float64 sum; returns (max err,
    largest err / limit)."""
    nnz = c.nnz
    keys = live_keys(c)
    require(bool((keys[1:] > keys[:-1]).all()),
            f"{name}: C's structure is not strictly row-major")
    ref = torch.zeros(nnz, dtype=torch.float64, device=DEVICE)
    absd = torch.zeros_like(ref)
    for t, alpha in terms:
        rows = (t.row_ids()[:t.nnz] if isinstance(t, CSR)
                else t.rowind[:t.nnz])
        k = rows.long() * t.shape[1] + t.colind[:t.nnz].long()
        slot = torch.searchsorted(keys, k).clamp(max=max(nnz - 1, 0))
        require(bool((keys[slot] == k).all()),
                f"{name}: an operand entry is missing from C")
        v = alpha * t.values[:t.nnz].double()
        ref.index_add_(0, slot, v)
        absd.index_add_(0, slot, v.abs())
    return limit_check(c.values[:nnz], ref, absd)


def union_phase(name, a, b, card):
    """E3: a union add of two uniform 1M matrices, two-phase: one
    ``add_inspect``, then ``add_compute`` on two sets of values (numeric
    reuse), each timed; the structure that of the host union of the
    packed (row, col) keys; each entry within 64 * eps * (|alpha a| +
    |beta b|) of the float64 sum; 10 fills bit-equal.  Then a 1M-row COO
    operand whose entries come three to a slot: 10 fills bit-equal, in
    bound."""
    alpha, beta = 1.5, -0.75
    t0 = time.perf_counter()
    info = sp.add_inspect(a, b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    inspect_ms = sync_ms(lambda: sp.add_inspect(a, b), 3)
    union = np.union1d(live_keys(a).cpu().numpy(),
                       live_keys(b).cpu().numpy())
    require(info.result_nnz == len(union),
            f"{name}: result_nnz {info.result_nnz}, host union "
            f"{len(union)}")
    recs, errs = [], []
    for i in range(2):
        if i:   # new values on the same structures (numeric reuse)
            g = torch.Generator(device=DEVICE)
            g.manual_seed(70)
            a = a.update(torch.rand(a.capacity, generator=g, device=DEVICE)
                         * a.entry_mask())
            b = b.update(torch.rand(b.capacity, generator=g, device=DEVICE)
                         * b.entry_mask())
        fill = functools.partial(sp.add_compute, info, sp.scaled(alpha, a),
                                 sp.scaled(beta, b))
        c = fill()
        if not i:
            require(np.array_equal(live_keys(c).cpu().numpy(), union),
                    f"{name}: C's structure differs from the host union")
        errs.append(union_check(name, c, [(a, alpha), (b, beta)]))
        same_bits(f"add_compute {name} fill {i}", lambda: fill().values, (),
                  runs=SAME_BITS_RUNS)
        recs.append(wall_ms(fill, 20))
        del c
    # cuSPARSE's csrgeam2 (behind torch.add) takes sorted columns only
    # (unsorted ones fail its launch and leave the context unusable):
    # the same matrices, their rows sorted by a double transpose
    sa, sb = (cusparse(sp.transpose(sp.transpose(t))) for t in (a, b))
    l_ms, l_why = library_or_none("add", lambda: torch.add(sa, sb), 20)
    del sa, sb
    rec = {"op": "add_union", "case": name, "m": a.shape[0],
           "a_nnz": a.nnz, "b_nnz": b.nnz, "c_nnz": info.result_nnz,
           "max_run": info.plan.max_run, "inspect_first_s": first_s,
           "inspect_ms": inspect_ms, "compute_ms": recs,
           "max_abs_err": max(e for e, _ in errs),
           "err_over_limit": max(r for _, r in errs), "library_ms": l_ms,
           "library_note": l_why, "same_bits_runs": SAME_BITS_RUNS,
           "card": card}
    emit(rec)
    del info, union
    torch.cuda.empty_cache()
    # repeated COO entries: three terms a slot, summed in stream order;
    # m distinct slots in B's shape
    cname, copies, seed = REPEAT_COO
    m, n = b.shape
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(m * n, size=m, replace=False))
    coo = sp.COO.from_arrays(
        rng.uniform(-100, 100, m * copies).astype(np.float32),
        np.repeat(flat // n, copies), np.repeat(flat % n, copies), (m, n),
        device=DEVICE)
    info = sp.add_inspect(coo, b)
    require(info.plan.max_run >= copies,
            f"{cname}: longest run {info.plan.max_run}")
    fill = functools.partial(sp.add_compute, info, sp.scaled(alpha, coo),
                             sp.scaled(beta, b))
    err = union_check(cname, fill(), [(coo, alpha), (b, beta)])
    same_bits(f"add_compute {cname}", lambda: fill().values, (),
              runs=SAME_BITS_RUNS)
    crec = {"op": "add_repeated_coo", "case": cname, "m": m,
            "coo_nnz": coo.nnz, "copies": copies, "c_nnz": info.result_nnz,
            "max_run": info.plan.max_run, "compute_ms": wall_ms(fill, 20),
            "max_abs_err": err[0], "err_over_limit": err[1],
            "same_bits_runs": SAME_BITS_RUNS, "card": card}
    emit(crec)
    del coo, info, fill
    torch.cuda.empty_cache()
    return [rec, crec]


def dcsr_phase(rates, card):
    """E4: the hypersparse DCSR: ``multiply(D, x)`` (the base path) and
    ``multiply(scaled(2.0, matrix_opt(D)), x)`` each held against the
    float64 base path; the kind chosen recorded, and where it is a ROUTE
    kind its kernel held on the main path's plan."""
    name, m, n, nnz, seed = DCSR_MAIN
    t0 = time.perf_counter()
    d = gen.generate_dcsr(m, n, nnz, seed=seed)
    gen_s = time.perf_counter() - t0
    # the generator draws nnz // 4 + 1 rows (12.5 %); those that drew no
    # entry stay empty
    require(0 < d.nrows <= nnz // 4 + 1, f"{name}: {d.nrows} stored rows")
    x = gen.generate_vector(n, seed=seed + 1)
    d64 = dataclasses.replace(d, values=d.values.double())
    absdot = sp.multiply(dataclasses.replace(d64, values=d64.values.abs()),
                         x.abs().double())
    y = sp.multiply(d, x)
    err = row_check(y, sp.multiply(d64, x.double()), absdot)
    base_ms = wall_ms(lambda: sp.multiply(d, x), 20)
    rec = {"op": "dcsr_base", "case": name, "m": m, "n": n, "nnz": d.nnz,
           "stored_rows": d.nrows, "drawn_rows": nnz // 4 + 1,
           "generate_s": gen_s,
           "max_abs_err_vs_f64": err, "ms": base_ms, "card": card}
    emit(rec)
    main_rec, plan = main_path(name, d, None, 61, card)
    kernel_rec = None
    if main_rec["kind"] == "route":
        kernel_rec = route2_case(name, d.to_csr(), {}, 62, rates, card,
                                 plan=plan)
    elif main_rec["kind"] == "route_paned":
        kernel_rec = paned_case(name, d.to_csr(), plan, 62, rates, card)
    del d, d64, plan
    torch.cuda.empty_cache()
    return rec, main_rec, kernel_rec


def ell_phase(name, a, card):
    """E5: an ELL plan of the uniform 300k cell: ``ell_spmv`` and
    ``ell_spmm`` (k = ELL_K) held against the float64 base path;
    ``refresh_values`` with new values gives a fresh plan's values and
    products bit for bit."""
    t0 = time.perf_counter()
    plan = ell.build_ell_plan(a)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = gen.generate_vector(a.shape[1], seed=63)
    b = gen.generate_dense(a.shape[1], ELL_K, seed=64)
    a64 = dataclasses.replace(a, values=a.values.double())
    a_abs = dataclasses.replace(a64, values=a64.values.abs())
    y = ell.ell_spmv(plan, x)
    err_v = row_check(y, sp.multiply(a64, x.double()),
                      sp.multiply(a_abs, x.abs().double()))
    c = ell.ell_spmm(plan, b)
    err_m, ratio_m = limit_check(c, sp.multiply(a64, b.double()),
                                 sp.multiply(a_abs, b.abs().double()))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(65)
    new = torch.rand(a.capacity, generator=g, device=DEVICE) \
        * a.entry_mask()
    fresh = ell.build_ell_plan(a.update(new))
    refreshed = plan.refresh_values(new)
    require(torch.equal(refreshed.values, fresh.values)
            and torch.equal(ell.ell_spmv(refreshed, x),
                            ell.ell_spmv(fresh, x))
            and torch.equal(ell.ell_spmm(refreshed, b),
                            ell.ell_spmm(fresh, b)),
            f"{name}: refresh_values differs from a fresh plan")
    rec = {"op": "ell", "case": name, "m": a.shape[0], "nnz": a.nnz,
           "width": plan.width, "m_pad": plan.m_pad, "build_s": build_s,
           "spmv_ms": wall_ms(lambda: ell.ell_spmv(plan, x), 20),
           "spmm_k": ELL_K,
           "spmm_ms": wall_ms(lambda: ell.ell_spmm(plan, b), 5),
           "spmv_max_abs_err_vs_f64": err_v,
           "spmm_max_abs_err_vs_f64": err_m, "spmm_err_over_limit": ratio_m,
           "refresh_same_bits": True, "card": card}
    emit(rec)
    return rec


def algebra_phase(head, u300, u1m, rates, card):
    """E1-E5 in turn (each prints its own records); returns the main-path
    records, the ROUTE2 and band kernel records to join their kernels'
    entries, and the DCSR kernel record or None."""
    t0 = time.perf_counter()
    _, t_main, t_kernel = transpose_phase(ROUTE_MAIN[1][0], u1m, rates,
                                              card)
    _, s_main, s_kernel = shift_phase(HEADLINE[0], head, HEADLINE[3],
                                          rates, card)
    union_phase(f"{ROUTE_MAIN[1][0]}_union", u1m, gen.generate_csr(
        *u1m.shape, u1m.nnz, seed=UNION_SEED), card)
    _, d_main, d_kernel = dcsr_phase(rates, card)
    ell_phase(f"{ROUTE_MAIN[0][0]}_ell", u300, card)
    log(f"[algebra] E1-E5 in {time.perf_counter() - t0:.1f} s")
    return [t_main, s_main, d_main], t_kernel, s_kernel, d_kernel


# ------------------------------------------------------------------ #
# phase F: the solvers, the band SpMV's gradient, the Matrix Market
# files and plan files
# ------------------------------------------------------------------ #

SOLVER_TOL = 1e-6
SOLVER_MAXITER = 200
JACOBI_ITERS = 20
POWER_ITERS = 100
# S's condition number that sigma aims at (cg then takes tens of
# iterations), and the power steps that estimate H's extreme eigenvalues
SPD_KAPPA = 10
SPECTRUM_ITERS = 200
AD_REPS = 5
# the checked-in benchmark matrices (data/*.mtx.gz, generator exports)
DATA_FILES = ("fem2d_128", "stencil3d_32", "rmat_32k", "fem2d_512",
              "powerlaw_64k")
# kind -> the SpMV kernel its plan launches, for the solver records
SOLVER_KERNELS = {"band": "band_spmv", "dia": "dia_spmv"}


def diagonal(a):
    """The diagonal of a square CSR on the card, f32."""
    rows = a.row_ids()[:a.nnz].long()
    on = a.colind[:a.nnz].long() == rows
    return torch.zeros(a.shape[0], device=DEVICE).index_add_(
        0, rows[on], a.values[:a.nnz][on].float())


def spd_operator(a):
    """S = H + sigma I, H = (A + A^T) / 2, by the sparse algebra ops
    (transpose, scale, add), sigma set from H's spectrum so that S's
    condition number is about SPD_KAPPA: cg then takes tens of
    iterations.  H's extreme eigenvalues are estimated by
    ``solvers.power_method`` (SPECTRUM_ITERS steps) on H shifted by its
    Gershgorin bounds c_lo <= lambda <= c_hi: c_hi I - H and H - c_lo I
    are positive semidefinite, with dominant eigenvalues c_hi - lambda_min
    and lambda_max - c_lo (the Rayleigh quotient falls short of each, so
    S's true condition number is somewhat above the aim).  Returns (S,
    sigma, (lambda_min, lambda_max), whether S is strictly diagonally
    dominant)."""
    m = a.shape[0]
    h = sp.add(sp.scale(0.5, a), sp.scale(0.5, sp.transpose(a)))
    d = diagonal(h)
    off = sp.multiply(dataclasses.replace(h, values=h.values.abs()),
                      torch.ones(m, device=DEVICE)) - d.abs()
    c_hi, c_lo = float((d + off).max()), float((d - off).min())
    lam_min = c_hi - float(solvers.power_method(
        lambda v: c_hi * v - sp.spmv(h, v), m,
        iters=SPECTRUM_ITERS).eigenvalue)
    lam_max = c_lo + float(solvers.power_method(
        lambda v: sp.spmv(h, v) - c_lo * v, m,
        iters=SPECTRUM_ITERS).eigenvalue)
    sigma = (lam_max - SPD_KAPPA * lam_min) / (SPD_KAPPA - 1)
    dominant = bool(((d + sigma).abs() > off).all())
    return (sp.add(h, sp.scale(sigma, identity_csr(m))), sigma,
            (lam_min, lam_max), dominant)


def timed(fn):
    """(result, ms) of one call between CUDA events, host included."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def plan_bytes(plan) -> int:
    """Bytes of a band or DIA plan's values, read once an SpMV."""
    t = plan.panels if hasattr(plan, "panels") else plan.diags
    return t.numel() * t.element_size()


def cg_case(name, op, kind, seed, rates, card):
    """``solvers.cg`` on ``matrix_opt(S)``: every SpMV on the plan's
    kernel (its launches are 1 + the iterations the loop ran, the frozen
    ones past convergence included), the card's x held in float64 to
    ||b - S x|| <= 10 tol ||b||, its iteration count within 10 % of a
    float64 ``cg`` on the base path; ms an iteration beside the bound:
    one SpMV's bytes (the plan's values, x, y) and the vector ops' (12 m
    floats: p.Ap, the x and r updates, r.r, the p update) at the card's
    memory rate, per counted iteration and per iteration run (the frozen
    ones to the next host read of the flag included).  ``op`` is
    :func:`spd_operator`'s result."""
    s, sigma, (lam_min, lam_max), dominant = op
    m = s.shape[0]
    kname = SOLVER_KERNELS[kind]
    opt = sp.matrix_opt(s)
    b = gen.generate_vector(m, seed=seed)
    t0 = time.perf_counter()
    sp.multiply(opt, b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got, plan = opt._plans["matvec"]
    require(got == kind, f"{name}: chooser picked {got!r}, want {kind!r}")
    solvers.cg(opt, b, tol=SOLVER_TOL, maxiter=2)   # warm-up: first loads
    torch.cuda.synchronize()
    reset_launches()
    res, ms = timed(lambda: solvers.cg(opt, b, tol=SOLVER_TOL,
                                       maxiter=SOLVER_MAXITER))
    launches = read_launches(kind)
    k = int(res.iterations)
    ran = min(SOLVER_MAXITER,
              solvers.CHECK_EVERY * math.ceil(k / solvers.CHECK_EVERY))
    require(0 < k < SOLVER_MAXITER, f"{name}: cg ran {k} iterations")
    require(launches[kname] == 1 + ran,
            f"{name}: {launches[kname]} {kname} launches for {1 + ran} "
            f"SpMVs")
    s64 = dataclasses.replace(s, values=s.values.double())
    b64 = b.double()
    rel = float(torch.linalg.norm(b64 - sp.spmv(s64, res.x.double()))
                / torch.linalg.norm(b64))
    require(rel <= 10 * SOLVER_TOL,
            f"{name}: true residual {rel:.3e} past 10 tol")
    ref = solvers.cg(s64, b64, tol=SOLVER_TOL, maxiter=SOLVER_MAXITER)
    k64 = int(ref.iterations)
    require(abs(k - k64) <= max(1, 0.1 * k64),
            f"{name}: {k} iterations against float64's {k64}")
    nbytes = plan_bytes(plan) + 2 * m * 4 + 12 * m * 4
    b_ms = nbytes / rates[0] * 1e3
    rec = {"main_path": f"{name}_cg", "op": "solver", "solver": "cg",
           "kind": kind, "kernels": [kname], "m": m, "nnz": s.nnz,
           "launches": launches, "iterations": k, "iterations_run": ran,
           "iterations_f64": k64, "true_residual_f64": rel,
           "sigma": sigma, "h_lambda_min_est": lam_min,
           "h_lambda_max_est": lam_max, "kappa_aim": SPD_KAPPA,
           "diag_dominant": dominant,
           "tol": SOLVER_TOL, "first_call_s": first_s, "ms": ms,
           "ms_per_iteration": ms / ran,
           "ms_per_counted_iteration": ms / k, "bound_ms_per_iteration": b_ms,
           "bound_by": "bytes", "card": card}
    log(f"[solver] {name} cg (sigma {sigma:.4f}, H's spectrum about "
        f"[{lam_min:.4f}, {lam_max:.4f}], diagonally dominant {dominant}): "
        f"{k} iterations ({ran} run, float64 {k64}), true residual "
        f"{rel:.3e}, {ms / k:.4f} ms a counted iteration, {ms / ran:.4f} "
        f"ms an iteration run, against {b_ms:.4f}; {card}")
    emit(rec)
    return rec, opt, b


def jacobi_case(name, s, opt, b, card):
    """``solvers.jacobi`` on the same operator, JACOBI_ITERS steps: one
    launch of the plan's kernel a step, the card's x held to the float64
    run's per entry within 64 eps (|D^-1| (|S| |x| + |b|) + |x|) (the
    rounding of a step, carried by an iteration matrix of norm below 1,
    S being strictly diagonally dominant), and its residual falling as
    the float64 run's does."""
    m = s.shape[0]
    kind = opt._plans["matvec"][0]
    kname = SOLVER_KERNELS[kind]
    d = diagonal(s)
    solvers.jacobi(opt, b, d, iters=1)               # warm-up
    torch.cuda.synchronize()
    reset_launches()
    x, ms = timed(lambda: solvers.jacobi(opt, b, d, iters=JACOBI_ITERS))
    launches = read_launches(kind)
    require(launches[kname] == JACOBI_ITERS,
            f"{name}: {launches[kname]} {kname} launches for "
            f"{JACOBI_ITERS} steps")
    s64 = dataclasses.replace(s, values=s.values.double())
    b64 = b.double()
    x64 = solvers.jacobi(s64, b64, d.double(), iters=JACOBI_ITERS)
    sabs = dataclasses.replace(s, values=s.values.abs().double())
    lim = 64 * EPS32 * ((sp.spmv(sabs, x64.abs()) + b64.abs())
                        / d.double().abs() + x64.abs())
    err = (x.double() - x64).abs()
    require(bool((err <= lim).all()),
            f"{name} jacobi: {int((err > lim).sum())} entries off the "
            f"float64 run")
    r32 = float(torch.linalg.norm(b64 - sp.spmv(s64, x.double())))
    r64 = float(torch.linalg.norm(b64 - sp.spmv(s64, x64)))
    r0 = float(torch.linalg.norm(b64))
    slack = 64 * EPS32 * float(torch.linalg.norm(sp.spmv(sabs, x64.abs())
                                                 + b64.abs()))
    require(r32 <= r64 + slack,
            f"{name} jacobi: residual {r32:.3e} against float64's {r64:.3e}")
    rec = {"main_path": f"{name}_jacobi", "op": "solver",
           "solver": "jacobi", "kind": kind, "kernels": [kname], "m": m,
           "launches": launches, "iterations": JACOBI_ITERS,
           "residual": r32 / r0, "residual_f64": r64 / r0,
           "max_err_over_limit": float((err / lim).max()), "ms": ms,
           "ms_per_iteration": ms / JACOBI_ITERS, "card": card}
    log(f"[solver] {name} jacobi: residual {r32 / r0:.3e} (float64 "
        f"{r64 / r0:.3e}), {ms / JACOBI_ITERS:.4f} ms a step; {card}")
    emit(rec)
    return rec


def power_case(name, s, opt, card):
    """``solvers.power_method`` on matrix_opt(S), POWER_ITERS steps: the
    plan's kernel once a step and once for the Rayleigh quotient; the
    eigenvalue within 1e-3 (relative) of float64 power iterations from
    the same v0 (a generator seeded 0) on the base path."""
    m = s.shape[0]
    kind = opt._plans["matvec"][0]
    kname = SOLVER_KERNELS[kind]
    solvers.power_method(opt, m, iters=1)            # warm-up
    torch.cuda.synchronize()
    reset_launches()
    res, ms = timed(lambda: solvers.power_method(opt, m, iters=POWER_ITERS))
    launches = read_launches(kind)
    require(launches[kname] == POWER_ITERS + 1,
            f"{name}: {launches[kname]} {kname} launches for power "
            f"iterations")
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    v = torch.randn(m, generator=g, device=DEVICE).double()
    v = v / torch.linalg.norm(v)
    s64 = dataclasses.replace(s, values=s.values.double())
    for _ in range(POWER_ITERS):
        w = sp.spmv(s64, v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    lam64 = float(torch.dot(v, sp.spmv(s64, v)))
    lam = float(res.eigenvalue)
    rel = abs(lam - lam64) / abs(lam64)
    require(rel <= 1e-3, f"{name}: eigenvalue {lam} against float64's "
                         f"{lam64}")
    rec = {"main_path": f"{name}_power", "op": "solver",
           "solver": "power_method", "kind": kind, "kernels": [kname],
           "m": m, "launches": launches, "iterations": POWER_ITERS,
           "eigenvalue": lam, "eigenvalue_f64": lam64, "rel_err": rel,
           "ms": ms, "ms_per_iteration": ms / (POWER_ITERS + 1),
           "card": card}
    log(f"[solver] {name} power_method: eigenvalue {lam:.6f} (float64 "
        f"{lam64:.6f}, rel {rel:.2e}), {ms / (POWER_ITERS + 1):.4f} ms a "
        f"step; {card}")
    emit(rec)
    return rec


def band_ad_reference(panels, x, dy, pad_l, n):
    """The band SpMV's backward in float64 (the JAX package's
    ``_band_spmv_bwd``): dx the overlap-add of the panels' column sums
    weighted by dy at stride 128, d(panels) the window outer products."""
    rows, w = panels.shape
    nblk = rows // 128
    dyp = torch.nn.functional.pad(dy.double(), (0, rows - dy.shape[0]))
    blocksum = (panels.double() * dyp[:, None]).view(nblk, 128, w).sum(1)
    chunks = -(-w // 128)
    bs = torch.nn.functional.pad(blocksum, (0, chunks * 128 - w))
    acc = torch.zeros((nblk + chunks) * 128, dtype=torch.float64,
                      device=panels.device)
    for k in range(chunks):
        acc[k * 128:(k + nblk) * 128] += bs[:, k * 128:(k + 1) * 128] \
            .reshape(-1)
    lx = rows - 128 + w
    xp = torch.nn.functional.pad(x.double(), (pad_l, max(
        0, lx - pad_l - n)))[:lx]
    win = xp.unfold(0, w, 128)
    return acc[pad_l:pad_l + n], (dyp.view(nblk, 128, 1)
                                  * win[:, None, :]).reshape(rows, w)


def band_ad_case(name, a, card):
    """``band_spmv_ad`` on the headline band: the forward on the band
    kernel (one launch), then dx and d(panels) of sum(w * y) held to the
    float64 backward, per entry within 64 eps in the dot-product form
    (|P|^T |w| for dx, |w| |x| for d(panels)); forward and backward
    timed."""
    plan = banded.build_band_plan(a)
    m, n = plan.shape
    x = gen.generate_vector(n, seed=171) / 50 - 1
    wt = gen.generate_vector(m, seed=172) / 50 - 1
    panels = plan.panels.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    ad_plan = dataclasses.replace(plan, panels=panels)
    reset_launches()
    y = banded.band_spmv_ad(ad_plan, xg)
    torch.cuda.synchronize()
    require(banded.band_spmv_padded.launches == 1,
            f"{name}: the forward made {banded.band_spmv_padded.launches} "
            f"band_spmv launches")
    (y * wt).sum().backward()
    dx64, dp64 = band_ad_reference(plan.panels, x, wt, plan.pad_l, n)
    ax, ap = band_ad_reference(plan.panels.abs(), x.abs(), wt.abs(),
                               plan.pad_l, n)
    dx_err, dx_ratio = limit_check(xg.grad, dx64, ax)
    dp_err, dp_ratio = limit_check(panels.grad, dp64, ap)
    del dx64, dp64, ax, ap
    fwd, bwd = [], []
    for _ in range(AD_REPS):
        panels.grad = xg.grad = None
        y, f_ms = timed(lambda: banded.band_spmv_ad(ad_plan, xg))
        _, b_ms = timed(lambda: (y * wt).sum().backward())
        fwd.append(f_ms)
        bwd.append(b_ms)
    rec = {"case": f"{name}_band_spmv_ad", "m": m, "width": plan.width,
           "launches_forward": 1, "dx_max_abs_err": dx_err,
           "dx_err_over_limit": dx_ratio, "dpanels_max_abs_err": dp_err,
           "dpanels_err_over_limit": dp_ratio, "forward_ms": min(fwd),
           "backward_ms": min(bwd), "card": card}
    log(f"[ad] {name} band_spmv_ad: dx err / limit {dx_ratio:.4f}, "
        f"d(panels) {dp_ratio:.4f}; forward {min(fwd):.4f} ms, backward "
        f"{min(bwd):.4f} ms; {card}")
    emit(rec)
    del panels, xg, ad_plan, plan, y
    torch.cuda.empty_cache()
    return rec


def _same_plan(p, q, path="plan"):
    """Every tensor of two plans bit-equal, every other field equal."""
    require(type(p) is type(q), f"{path}: {type(p)} against {type(q)}")
    if isinstance(p, torch.Tensor):
        require(p.dtype == q.dtype and torch.equal(p, q),
                f"{path}: differs")
    elif dataclasses.is_dataclass(p):
        for f in dataclasses.fields(p):
            _same_plan(getattr(p, f.name), getattr(q, f.name),
                       f"{path}.{f.name}")
    elif isinstance(p, tuple):
        require(len(p) == len(q), f"{path}: lengths")
        for i, (u, v) in enumerate(zip(p, q)):
            _same_plan(u, v, f"{path}[{i}]")
    elif isinstance(p, np.ndarray):
        require(np.array_equal(p, q), f"{path}: differs")
    else:
        require(p == q, f"{path}: {p!r} against {q!r}")


def data_phase(card):
    """F5: the five data files through ``load_matrix_market`` (their
    load times), each through ``matrix_opt`` and SpMV on the card held
    to the float64 base path (``main_path``: the kind the chooser picks
    and its kernel's launches recorded); then one SpGEMM plan and one
    SpTRSV plan saved and loaded on the card: the loaded plans equal the
    first ones array for array, the SpGEMM fill (one writer a slot)
    gives the first plan's bits, and the solve over the loaded plan is
    held to the backward error bound, as every solve is.  Returns the
    main-path records."""
    recs = []
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    mats = {}
    for i, fname in enumerate(DATA_FILES):
        t0 = time.perf_counter()
        a = sio.load_matrix_market(os.path.join(root, fname + ".mtx.gz"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rec, _ = main_path(f"data_{fname}", a, None, 180 + i, card)
        rec["load_s"] = load_s
        kern = KIND_KERNELS.get(rec["kind"]) or (
            (SOLVER_KERNELS[rec["kind"]],) if rec["kind"] in SOLVER_KERNELS
            else ())
        require(all(rec["launches"][k] > 0 for k in kern),
                f"{fname}: kind {rec['kind']} launched none of {kern}")
        rec["kernels"] = list(kern)
        log(f"[data] {fname}: {a.shape[0]} rows, {a.nnz} entries, loaded "
            f"in {load_s:.2f} s, kind {rec['kind']}, launches "
            f"{ {k: rec['launches'][k] for k in kern} }; {card}")
        emit({"data_file": fname, "load_s": load_s, "kind": rec["kind"],
              "m": a.shape[0], "nnz": a.nnz, "card": card})
        recs.append(rec)
        mats[fname] = a
    a = mats["fem2d_128"]
    del mats
    with tempfile.TemporaryDirectory() as tmp:
        info = sp.multiply_compute(a, a)
        require(info.plan.route is not None
                and info.plan.route.expansion is not None,
                "plan files: the SpGEMM plan has no engine")
        c1 = sp.multiply_fill(info, a, a)
        path = os.path.join(tmp, "spgemm.npz")
        t0 = time.perf_counter()
        serialize.save_plan(path, info.plan)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = serialize.load_plan(path)
        load_s = time.perf_counter() - t0
        _same_plan(info.plan, loaded)
        c2 = sp.multiply_fill(info.update(plan=loaded), a, a)
        require(torch.equal(c1.values, c2.values)
                and torch.equal(c1.colind, c2.colind),
                "plan files: the loaded SpGEMM plan's fill differs")
        log(f"[plan-file] SpGEMM plan of fem2d_128 A.A: saved in "
            f"{save_s:.3f} s, loaded in {load_s:.3f} s, the same arrays and "
            f"the same fill bits")
        name, make, kind, _ = TRSV_MAIN[0]
        lo = make()
        tinfo = sp.triangular_solve_inspect(lo)
        require(tinfo.plan.route is not None, "plan files: no route solve")
        path = os.path.join(tmp, "trsv.npz")
        serialize.save_plan(path, tinfo.plan)
        loaded = serialize.load_plan(path)
        _same_plan(tinfo.plan, loaded, "trsv")
        b = gen.generate_vector(lo.shape[0], seed=190)
        info2 = dataclasses.replace(tinfo, plan=loaded)
        x = sp.triangular_solve(sp.scaled(2.0, lo), b, info=info2)
        ratio, _ = trsv_checks(lo, info2, x, b, 2.0)
        log(f"[plan-file] SpTRSV plan of {name}: the same arrays; its "
            f"solve within the backward error bound (err / limit "
            f"{ratio:.4f})")
    emit({"plan_files": {"spgemm": "same arrays, same fill bits",
                         "trsv": "same arrays, solve in bound"},
          "card": card})
    return recs


def solver_phase(head, stencil, rates, card):
    """F1-F5: ``cg`` on the symmetrised headline band (band kernel) and
    on the symmetrised 1000^2 stencil (DIA kernel), ``jacobi`` on the
    stencil's operator, ``power_method`` on the band's, ``band_spmv_ad``
    on the headline band, then the data files and plan files.  Returns
    the main-path records."""
    t0 = time.perf_counter()
    main = []
    op = spd_operator(head)
    rec, opt, _ = cg_case(f"{HEADLINE[0]}_spd", op, "band", 161, rates,
                          card)
    main.append(rec)
    main.append(power_case(f"{HEADLINE[0]}_spd", op[0], opt, card))
    del op, opt
    op = spd_operator(stencil)
    # Jacobi converges on a strictly diagonally dominant S
    require(op[3], f"{DIA_MAIN[0][0]}_spd: S is not diagonally dominant")
    rec, opt, b = cg_case(f"{DIA_MAIN[0][0]}_spd", op, "dia", 162, rates,
                          card)
    main.append(rec)
    main.append(jacobi_case(f"{DIA_MAIN[0][0]}_spd", op[0], opt, b, card))
    del op, opt
    torch.cuda.empty_cache()
    band_ad_case(HEADLINE[0], head, card)
    main += data_phase(card)
    log(f"[solver] F1-F5 in {time.perf_counter() - t0:.1f} s")
    return main


# ------------------------------------------------------------------ #
# phase D: the distribution layer (spblas_tpu_torch.parallel)
# ------------------------------------------------------------------ #

# D1 runs an NCCL world of one rank in this process (NCCL refuses two
# ranks on one card); D2 a gloo world of DIST_RANKS processes sharing the
# card, its meshes staging every collective through the host (gloo
# carries no CUDA tensor), which checks the distributed semantics on the
# card and is no speed figure for NCCL.  DIST_LIMIT bounds each D2 case
# and every collective (seconds).
DIST_RANKS = 4
DIST_D1_BACKEND = "nccl"
DIST_DEVICE = "cuda:0"
DIST_LIMIT = 600.0
DIST_REPS = 10
DIST_SPMM_K = 64
DIST_SEED = 141
DIST_FILLS = SPGEMM_FILLS
DIST_NOTE = ("gloo world of 4 on one card, staged through the host: a "
             "check of the distributed semantics, not an NCCL speed figure")


def local_rows(a, r0, r1):
    """Rows [r0, r1) of the CSR ``a`` as a CSR of their own (global
    columns), on ``a``'s device: the block a rank owns."""
    r1 = min(r1, a.shape[0])
    rp = a.rowptr[r0:r1 + 1].long()
    lo, hi = int(rp[0]), int(rp[-1])
    return CSR(values=a.values[lo:hi], rowptr=(rp - lo).int(),
               colind=a.colind[lo:hi], nnz=hi - lo,
               shape=(r1 - r0, a.shape[1]))


def in_turn(mesh, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier, so
    a rank's kernel timings share the card with no other rank."""
    import torch.distributed as dist
    out = None
    for r in range(mesh.size):
        if mesh.rank == r:
            out = fn()
            torch.cuda.synchronize()
        dist.barrier()
    return out


def call_ms(mesh, fn, reps=DIST_REPS):
    """Mean host ms of ``reps`` distributed calls run by every rank at
    once, each ended by a synchronize (staging and collectives
    included)."""
    import torch.distributed as dist
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def rank_setup():
    """A D2 rank's process settings: those of ``run``."""
    warnings.filterwarnings("ignore", message="Sparse")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def d2_band(mesh, rates, card):
    """Rank task: the headline band through ``dist_band_spmv`` and
    ``dist_band_spmm`` at k = DIST_SPMM_K (the halo, then R5 and the
    resident R12 a rank); rank 0 holds the gathered result against the
    float64 base path."""
    rank_setup()
    _, hm, hn, hbw = HEADLINE
    a = gen.generate_banded_csr(hm, hn, hbw, seed=0)
    t0 = time.perf_counter()
    plan = par.partition_band(a, mesh)
    inspect_s = time.perf_counter() - t0
    x = gen.generate_vector(hn, seed=DIST_SEED)
    b = dense_operands(hn, DIST_SPMM_K, DIST_SEED + 1)[0]
    out = {"inspect_s": inspect_s}
    r0 = mesh.rank * plan.mloc
    a_loc = local_rows(a, r0, r0 + plan.mloc)
    for op, fn, g, kname, ref_fn, plain in (
            ("spmv", par.dist_band_spmv, x, "band_spmv",
             banded.band_spmv_padded, banded.band_spmv_reference),
            ("spmm", par.dist_band_spmm, b, "band_spmm",
             banded.band_spmm_padded, banded.band_spmm_reference)):
        xl = par.partition_band_vector(g, plan, mesh)
        s0 = mesh.staged_bytes
        reset_launches()
        y = fn(plan, xl, mesh)
        torch.cuda.synchronize()
        launches = read_launches("band")[kname]
        staged = mesh.staged_bytes - s0
        require(launches == 1, f"dist {op} rank {mesh.rank}: {launches} "
                               f"{kname} launches")
        yg = par.gather_result(y, plan, mesh)
        err = ratio = None
        if mesh.rank == 0:
            if op == "spmv":
                a64 = dataclasses.replace(a, values=a.values.double())
                absd = sp.multiply(dataclasses.replace(
                    a, values=a.values.abs().double()), g.abs().double())
                err, ratio = limit_check(yg, sp.multiply(a64, g.double()),
                                         absd)
            else:
                err, ratio = spmm_check(a, g, yg, 1.0)
        ms = call_ms(mesh, lambda: fn(plan, xl, mesh))
        win = par.banded.halo_window(plan, xl, mesh)
        k = 1 if win.dim() == 1 else win.shape[1]
        nbytes = (plan.panels.numel() * 4 + win.numel() * 4
                  + plan.panels.shape[0] * 4 * k)
        b_ms, b_by = bound(nbytes, 2 * plan.panels.numel() * k, rates)

        def timings():
            ins = replicas(lambda: (plan.panels.clone(), win.clone()),
                           nbytes)
            lib = library_ms(a_loc, g) if op == "spmv" \
                else library_mm_ms(a_loc, g)
            return (device_ms(ref_fn, ins), device_ms(plain, ins), lib)

        k_ms, p_ms, l_ms = in_turn(mesh, timings)
        out[op] = dict(kernel=kname, launches=launches, staged=staged,
                       call_ms=ms, kernel_ms=k_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err, err_over_limit=ratio)
        del y, yg, win
    return out


def d2_route(mesh, rates, card):
    """Rank task: uniform 1M^2 degree 10 through ``dist_route_spmv``
    (x all-gathered, then R3 on the rank's ROUTE2 plan)."""
    rank_setup()
    a = ROUTE_MAIN[1][1]()
    t0 = time.perf_counter()
    plan = par.partition_route(a, mesh)
    inspect_s = time.perf_counter() - t0
    x = gen.generate_vector(a.shape[1], seed=DIST_SEED + 2)
    xl = par.partition_spmv_vector(("route", plan), x, mesh)
    s0 = mesh.staged_bytes
    reset_launches()
    y = par.dist_route_spmv(plan, xl, mesh)
    torch.cuda.synchronize()
    launches = read_launches("route")["route2_spmv"]
    staged = mesh.staged_bytes - s0
    ranges = len(plan.route.launch_ranges())
    require(launches == ranges, f"dist route rank {mesh.rank}: {launches} "
                                f"route2_spmv launches, {ranges} ranges")
    yg = par.gather_result(y, plan, mesh)
    err = ratio = None
    if mesh.rank == 0:
        a64 = dataclasses.replace(a, values=a.values.double())
        absd = sp.multiply(dataclasses.replace(
            a, values=a.values.abs().double()), x.abs().double())
        err, ratio = limit_check(yg, sp.multiply(a64, x.double()), absd)
    ms = call_ms(mesh, lambda: par.dist_route_spmv(plan, xl, mesh))
    route = plan.route
    x2 = r2k.pack_x2(route, x)
    nch = route.nchunks
    nbytes = (nch * (8 * 1024 + 12) + route.x_rows * 512
              + 2 * r2k.out_rows(route) * 512)
    b_ms, b_by = bound(nbytes, 2 * nch * 1024, rates)
    r0 = mesh.rank * plan.mloc
    a_loc = local_rows(a, r0, r0 + plan.mloc)

    def timings():
        def copy():
            return dataclasses.replace(
                route, tile=route.tile.clone(), val=route.val.clone(),
                slab_base=route.slab_base.clone(),
                y_base=route.y_base.clone(),
                src_flag=route.src_flag.clone()), x2.clone()
        ins = replicas(copy, nbytes)
        return (device_ms(r2k.route2_spmv_padded, ins),
                device_ms(r2k.route2_spmv_reference, ins),
                library_ms(a_loc, x))

    k_ms, p_ms, l_ms = in_turn(mesh, timings)
    return {"inspect_s": inspect_s, "spmv": dict(
        kernel="route2_spmv", launches=launches, staged=staged, call_ms=ms,
        kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=err, err_over_limit=ratio, nchunks=nch,
        launch_ranges=ranges)}


def mul_bound(stream, cap, rates):
    """(bound_ms, bound_by, bytes) of a slot fill: the index stream (sa,
    sb, run_start), A and B read once, c written once."""
    ent = int(stream.sa.numel())
    nbytes = (2 * ent + stream.nslots + 1 + cap) * 4 + (
        stream.a_len + stream.b_len) * 4
    return (*bound(nbytes, 2 * ent, rates), nbytes)


def mul_timings(eng, a_arr, bg, nbytes):
    """(kernel, plain) ms of a rank's slot fill."""
    ex, cap = eng.expansion, eng.capacity

    def copy():
        return (dataclasses.replace(ex, sa=ex.sa.clone(), sb=ex.sb.clone(),
                                    run_start=ex.run_start.clone()),
                a_arr.clone(), bg.clone())

    ins = replicas(copy, nbytes)
    return (device_ms(lambda s_, a_, b_: mf.mul_fill(s_, a_, b_, cap), ins),
            device_ms(lambda s_, a_, b_: mf.mul_fill_reference(
                s_, a_, b_, cap), ins))


def d2_spgemm(mesh, rates, card):
    """Rank task: the 100k A.A product through the engine: the rank's
    host symbolic and paned plan, then one numeric (B's values
    all-gathered, one R6 slot fill a rank); rank 0 holds the assembled
    C against the float64 torch numeric of one card."""
    rank_setup()
    name, make, _, _ = SPGEMM_MAIN[1]
    a = make()
    ar = par.partition_rowblock(a, mesh)
    t0 = time.perf_counter()
    plan = par.dist_spgemm_compute(ar, ar, mesh)
    compute_s = time.perf_counter() - t0
    require(plan.engine is not None, f"dist {name}: no engine on the card")
    s0 = mesh.staged_bytes
    reset_launches()
    c = par.dist_spgemm_numeric(plan, ar, ar, mesh)
    torch.cuda.synchronize()
    launches = read_launches("paned")["route2_mul_paned"]
    staged = mesh.staged_bytes - s0
    require(launches == 1, f"dist {name} rank {mesh.rank}: {launches} "
                           "slot fills, want 1")
    back = par.assemble_csr(c, mesh)
    err = ratio = None
    if mesh.rank == 0:
        info = sp.spgemm_compute(a, a, reuse=False)
        a64 = dataclasses.replace(a, values=a.values.double())
        aab = dataclasses.replace(a, values=a.values.abs().double())
        ref = sp.spgemm_fill(info, a64, a64)
        absd = sp.spgemm_fill(info, aab, aab)
        nnz = ref.nnz
        require(back.nnz == nnz == plan.result_nnz
                and torch.equal(back.rowptr, ref.rowptr)
                and torch.equal(back.colind[:nnz], ref.colind[:nnz]),
                f"dist {name}: C structure differs from one card's")
        err, ratio = limit_check(back.values[:nnz], ref.values[:nnz],
                                 absd.values[:nnz])
        del info, ref, absd
    del back
    ms = call_ms(mesh, lambda: par.dist_spgemm_numeric(plan, ar, ar, mesh))
    eng = plan.engine
    a_arr = torch.cat([ar.values, ar.values.new_ones(1)])
    bg = mesh.all_gather(ar.values).reshape(-1)
    b_ms, b_by, nbytes = mul_bound(eng.expansion, eng.capacity, rates)
    k_ms, p_ms, l_ms = in_turn(mesh, lambda: mul_timings(
        eng, a_arr, bg, nbytes) + (library_spgemm_ms(ar.local_csr(), a),))
    return {"inspect_s": compute_s, "fill": dict(
        kernel="route2_mul_paned", launches=launches, staged=staged,
        call_ms=ms, kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        err_over_limit=ratio, panels=len(eng.panels),
        result_nnz=plan.result_nnz)}


def d2_trsv(mesh, rates, card):
    """Rank task: the 20k triangular factor through
    ``dist_triangular_solve`` (p steps, a level sweep and one broadcast
    each); rank 0 holds x to the componentwise backward error."""
    rank_setup()
    name, make, _, _ = TRSV_MAIN[0]
    a = make()
    t0 = time.perf_counter()
    plan = par.dist_triangular_solve_inspect(a, mesh, uplo="lower")
    inspect_s = time.perf_counter() - t0
    b = gen.generate_vector(a.shape[0], seed=DIST_SEED + 3)
    bl = par.partition_vector(b, plan, mesh, axis="rows")
    s0 = mesh.staged_bytes
    x = par.dist_triangular_solve(plan, bl, mesh)
    torch.cuda.synchronize()
    staged = mesh.staged_bytes - s0
    xg = par.gather_result(x, plan, mesh)
    ratio = None
    if mesh.rank == 0:
        a64 = dataclasses.replace(a, values=a.values.double())
        x64 = xg.double()
        r = (sp.multiply(a64, x64) - b.double()).abs()
        lim = 64 * EPS32 * (sp.multiply(abs_csr(a), x64.abs())
                            + b.double().abs())
        bad = int((r > lim).sum())
        require(bad == 0, f"dist {name}: {bad} rows past the backward "
                          "bound")
        ratio = float((r / lim).max())
    ms = call_ms(mesh, lambda: par.dist_triangular_solve(plan, bl, mesh))
    return {"inspect_s": inspect_s, "solve": dict(
        staged=staged, call_ms=ms, backward_ratio=ratio,
        levels=int(plan.rows.shape[0]))}


def d2_add(mesh, rates, card):
    """Rank task: ``dist_add`` of two uniform 300k^2 matrices (the union
    planned a rank, no collective in the numeric); rank 0 holds the
    assembled C to one card's ``add``, bit for bit."""
    rank_setup()
    a = ROUTE_MAIN[0][1]()
    b = gen.generate_csr(*a.shape, a.nnz, seed=UNION_SEED)
    ar, br = par.partition_rowblock(a, mesh), par.partition_rowblock(b, mesh)
    t0 = time.perf_counter()
    plan = par.dist_add_compute(ar, br, mesh)
    inspect_s = time.perf_counter() - t0
    s0 = mesh.staged_bytes
    c = par.dist_add_numeric(plan, ar, br, mesh)
    torch.cuda.synchronize()
    staged = mesh.staged_bytes - s0
    back = par.assemble_csr(c, mesh)
    if mesh.rank == 0:
        ref = sp.add(a, b)
        nnz = ref.nnz
        require(back.nnz == nnz and torch.equal(back.rowptr, ref.rowptr)
                and torch.equal(back.colind[:nnz], ref.colind[:nnz])
                and torch.equal(back.values[:nnz], ref.values[:nnz]),
                "dist add: C differs from one card's add")
    ms = call_ms(mesh, lambda: par.dist_add_numeric(plan, ar, br, mesh))
    return {"inspect_s": inspect_s, "numeric": dict(
        staged=staged, call_ms=ms, bit_equal=True)}


D2_CASES = (("band", d2_band), ("route", d2_route), ("spgemm", d2_spgemm),
            ("trsv", d2_trsv), ("add", d2_add))


def d1_spgemm(mesh, cells, rates, card):
    """D1: the bench's distributed cell (bench.py:330) on an NCCL world
    of one: ``dist_spgemm_compute`` of the 100k A.A product, then
    DIST_FILLS numerics on distinct values, one slot fill each, each C
    held per entry to one card's ``multiply_fill`` within 64 eps
    (|A||B|); 10 fills give the same bits."""
    name = SPGEMM_MAIN[1][0]
    a, info, lib_ms = cells[name]
    ar = par.partition_rowblock(a, mesh)
    require(ar.local_capacity == a.capacity, f"{name}: capacities differ")
    g = torch.Generator(device=DEVICE)
    g.manual_seed(DIST_SEED)
    vals = [torch.rand(a.capacity, generator=g, device=DEVICE) * 2 - 1
            for _ in range(DIST_FILLS)]
    t0 = time.perf_counter()
    plan = par.dist_spgemm_compute(ar, ar, mesh)
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    eng = plan.engine
    require(eng is not None, f"dist {name}: no engine on the card")
    nnz = info.result_nnz
    require(plan.c_nnz == nnz and plan.result_nnz == nnz,
            f"dist {name}: result_nnz {plan.result_nnz}, one card {nnz}")
    reset_launches()
    t0 = time.perf_counter()
    cs = [par.dist_spgemm_numeric(plan, dataclasses.replace(ar, values=v),
                                  ar, mesh).values for v in vals]
    torch.cuda.synchronize()
    numerics_s = time.perf_counter() - t0
    launches = read_launches("paned")
    fills = launches["route2_mul_paned"]
    require(fills == DIST_FILLS, f"dist {name}: {fills} slot fills for "
                                 f"{DIST_FILLS} numerics, want one each")
    err = ratio = 0.0
    for v, c in zip(vals, cs):
        ai = dataclasses.replace(a, values=v)
        ref = sp.multiply_fill(info, ai, a)
        if err == 0.0:
            require(torch.equal(plan.c_rowptr, ref.rowptr)
                    and torch.equal(plan.c_colind[:nnz], ref.colind[:nnz]),
                    f"dist {name}: C structure differs from one card's")
        absd = sp.multiply_fill(info, dataclasses.replace(
            a, values=v.abs().double()), abs_csr(a))
        e, r = limit_check(c[:nnz], ref.values[:nnz], absd.values[:nnz])
        err, ratio = max(err, e), max(ratio, r)
        del ref, absd
    a0 = dataclasses.replace(ar, values=vals[0])
    same_bits(f"dist_spgemm_numeric {name} (nccl world 1)",
              lambda: par.dist_spgemm_numeric(plan, a0, ar, mesh).values, (),
              runs=SAME_BITS_RUNS)
    del cs
    ms = wall_ms(lambda: par.dist_spgemm_numeric(plan, a0, ar, mesh),
                 DIST_FILLS)
    a_arr = torch.cat([vals[0], vals[0].new_ones(1)])
    b_ms, b_by, nbytes = mul_bound(eng.expansion, eng.capacity, rates)
    k_ms, p_ms = mul_timings(eng, a_arr, a.values, nbytes)
    rec = {"main_path": f"dist1_{name}", "op": "dist", "kind": "paned",
           "backend": mesh.backend, "ranks": mesh.size, "m": a.shape[0],
           "nnz": a.nnz, "result_nnz": nnz, "panels": len(eng.panels),
           "launches": launches, "kernels": ["route2_mul_paned"],
           "numerics": DIST_FILLS, "max_abs_err_vs_one_card": err,
           "max_err_over_limit": ratio, "compute_s": compute_s,
           "numerics_s": numerics_s, "numeric_ms": ms, "card": card}
    emit(rec)
    kern = {"kernel": "route2_mul_paned", "case": f"dist1_{name}",
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "launches": fills}
    return rec, kern


def d1_spmv(mesh, name, a, kind, seed, card):
    """D1: ``dist_plan_spmv`` at p = 1 through the chooser (which must
    pick ``kind``), held per row to the float64 base path."""
    t0 = time.perf_counter()
    kp = par.partition_spmv(a, mesh)
    inspect_s = time.perf_counter() - t0
    require(kp[0] == kind, f"dist1 {name}: chooser picked {kp[0]!r}, "
                           f"want {kind!r}")
    x = gen.generate_vector(a.shape[1], seed=seed)
    xl = par.partition_spmv_vector(kp, x, mesh)
    reset_launches()
    y = par.dist_plan_spmv(kp, xl, mesh)
    torch.cuda.synchronize()
    launches = read_launches(kind)
    a64 = dataclasses.replace(a, values=a.values.double())
    absd = sp.multiply(abs_csr(a), x.abs().double())
    err, ratio = limit_check(y[:a.shape[0]], sp.multiply(a64, x.double()),
                             absd)
    ms = wall_ms(lambda: par.dist_plan_spmv(kp, xl, mesh), 20)
    rec = {"main_path": f"dist1_{name}", "op": "dist", "kind": kind,
           "backend": mesh.backend, "ranks": mesh.size, "m": a.shape[0],
           "nnz": a.nnz, "launches": launches,
           "kernels": list(KIND_KERNELS[kind]),
           "max_abs_err_vs_f64": err, "max_err_over_limit": ratio,
           "inspect_s": inspect_s, "ms": ms, "card": card}
    emit(rec)
    return rec


def dist_phase(cells, rates, card):
    """Phase D.  D1: an NCCL world of one rank in this process: the 100k
    A.A engine over 20 numerics, and ``dist_plan_spmv`` on the headline
    band and uniform 1M.  D2: a gloo world of DIST_RANKS processes on the
    one card (``parallel/launch.py``): the headline band's SpMV and SpMM,
    uniform 1M's ROUTE2 SpMV, the 100k engine, the 20k solve and a union
    add, each rank launching its kernel.  Returns (main-path records,
    kernel records)."""
    import torch.distributed as dist
    from spblas_tpu_torch.parallel.launch import World
    t_d = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    par.init_distributed(DIST_D1_BACKEND, rank=0, world_size=1,
                         store=dist.FileStore(os.path.join(tmp, "store"), 1),
                         device=DIST_DEVICE, timeout=DIST_LIMIT)
    try:
        mesh = par.make_row_mesh()
        require(mesh.backend == DIST_D1_BACKEND and mesh.size == 1
                and not mesh.stage_through_host, f"D1 mesh {mesh}")
        rec, d1_kern = d1_spgemm(mesh, cells, rates, card)
        main = [rec]
        _, hm, hn, hbw = HEADLINE
        main.append(d1_spmv(mesh, HEADLINE[0], gen.generate_banded_csr(
            hm, hn, hbw, seed=0), "band", DIST_SEED + 4, card))
        main.append(d1_spmv(mesh, ROUTE_MAIN[1][0], ROUTE_MAIN[1][1](),
                            "route", DIST_SEED + 5, card))
    finally:
        dist.destroy_process_group()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    cells.clear()
    torch.cuda.empty_cache()
    log(f"[dist] D1 (nccl world 1) in {time.perf_counter() - t_d:.1f} s")

    t_2 = time.perf_counter()
    res = {}
    with World(DIST_RANKS, backend="gloo", device=DIST_DEVICE,
               stage_through_host=True, timeout=DIST_LIMIT,
               start_timeout=DIST_LIMIT) as world:
        for case, fn in D2_CASES:
            t0 = time.perf_counter()
            res[case] = world.run(fn, rates, card, timeout=DIST_LIMIT)
            log(f"[dist] D2 {case}: {time.perf_counter() - t0:.1f} s")
    recs = [d1_kern]
    for case, ranks in res.items():
        for op, r0 in ranks[0].items():
            if op == "inspect_s":
                continue
            per = [r[op] for r in ranks]
            line = {"main_path": f"dist4_{case}_{op}", "op": "dist",
                    "backend": "gloo", "ranks": DIST_RANKS,
                    "stage_through_host": True, "note": DIST_NOTE,
                    "inspect_s": [r["inspect_s"] for r in ranks],
                    "staged_bytes": [p["staged"] for p in per],
                    "slowest_call_ms": max(p["call_ms"] for p in per),
                    "card": card}
            for key in ("kernel_ms", "launches", "plain_ms", "library_ms"):
                if key in r0:
                    line[key] = [p[key] for p in per]
            line.update({k: v for k, v in r0.items() if k in (
                "max_abs_err", "err_over_limit", "backward_ratio",
                "bit_equal", "panels", "result_nnz", "levels",
                "nchunks")})
            log(f"[dist] {case} {op}: rank kernel ms "
                f"{line.get('kernel_ms')}, slowest rank call ms "
                f"{line['slowest_call_ms']:.3f}, staged_bytes "
                f"{line['staged_bytes']} ({DIST_NOTE}) {card}")
            emit(line)
            if "kernel" not in r0:
                continue
            require(all(p["launches"] > 0 for p in per),
                    f"dist4 {case} {op}: a rank launched no {r0['kernel']}")
            recs.append({
                "kernel": r0["kernel"], "case": f"dist4_{case}_{op}",
                "kernel_ms": max(p["kernel_ms"] for p in per),
                "plain_ms": max(p["plain_ms"] for p in per),
                "library_ms": max(p["library_ms"] for p in per),
                "bound_ms": max(p["bound_ms"] for p in per),
                "bound_by": r0["bound_by"], "max_abs_err": r0["max_abs_err"],
                "launches": sum(p["launches"] for p in per)})
    log(f"[dist] D2 (gloo world {DIST_RANKS}) in "
        f"{time.perf_counter() - t_2:.1f} s; phase D "
        f"{time.perf_counter() - t_d:.1f} s")
    return main, recs


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
    band_misaligned_check()
    band_wide_check()
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
    hub_plan = route2.build_route2_plan(
        hubbed.rowptr, hubbed.colind, hubbed.values, hubbed.shape,
        hubbed.nnz, device=hubbed.device)
    route_recs += [
        route2_case("uniform_300k_hub_rows_aux", hubbed, {}, 63, rates,
                    card, plan=hub_plan),
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
    x2 = r2k.pack_x2(hub_plan, gen.generate_vector(hubbed.shape[1],
                                                    seed=80))
    race_check("route2_spmv uniform_300k_hub_rows_aux",
               lambda: r2k.route2_spmv_padded(hub_plan, x2),
               r2k.route2_spmv_reference(hub_plan, x2),
               r2k.route2_spmv_reference(dataclasses.replace(
                   hub_plan, val=hub_plan.val.abs()), x2.abs()))
    del hubbed, hub_paned, hub_plan, rmat_v1, x2

    # SpMM kernels: both band kernels on the headline at the spmm_banded
    # k, at an odd k and on bf16 panels; BSR kernels on (128, 128) and
    # (8, 8) blocks with empty block rows
    band_cases = {c[0]: c for c in BAND_CASES}
    spmm_name = f"spmm_{hname}_k{SPMM_BANDED_K}"
    hplan = banded.build_band_plan(head)
    spmm_band_recs = band_spmm_case(spmm_name, hplan, SPMM_BANDED_K, 85,
                                    rates, card, csr=head, full=True)
    del hplan
    for i, (cname, k) in enumerate(BAND_SPMM_ONLY):
        _, m, n, bw, dt, seed = band_cases[cname]
        a = gen.generate_banded_csr(m, n, bw, seed=seed)
        spmm_band_recs += band_spmm_case(
            f"{cname}_k{k}", banded.build_band_plan(a, dtype=dt), k,
            96 + i, rates, card, csr=a)
    edges_phase()
    bsr_recs = []
    for bname, mb, nbc, per_row, block, every, k, seed in (BSR_ONLY
                                                          + BSR_SPMV_ONLY):
        a = random_bsr(mb, nbc, per_row, block, every, seed)
        bsr_recs += bsr_cases(bname, a, bsr_to_csr(a), k, seed, rates, card,
                              spmm=k is not None)
        # the SpMV's f64 instantiations of the span and cols mappings
        a = random_bsr(mb, nbc, per_row, block, every, seed, torch.float64)
        bsr_recs += bsr_cases(bname, a, bsr_to_csr(a), None, seed, rates,
                              card, spmm=False)
    require(all(r["empty_block_rows"] > 0 for r in bsr_recs),
            "BSR kernel cases have no empty block row")
    del a
    fname, side, fseed = FEM_BSR
    for dt in (torch.float32, torch.float64):
        a = fem_bsr(side, dt, fseed)
        require(a.nnz_blocks == (3 * side - 2) ** 3,
                f"{fname}: {a.nnz_blocks} blocks")
        bsr_recs += bsr_cases(fname, a, bsr_to_csr(a), None, fseed, rates,
                              card, spmm=False)
        del a
        torch.cuda.empty_cache()

    # phase 3: the main path at full width, counts read around each run
    main = [main_path(hname, head, "band", 31, card)[0]]
    main += [main_path(n, a, "dia", 41, card)[0] for n, a in mats.items()]
    main += [main_path(n, a, "route", 51, card)[0]
             for n, a in general.items()]
    cx_a = CX_MAIN[1]()
    rec, plan = main_path(CX_MAIN[0], cx_a, "route_cx", 52, card)
    main.append(rec)
    cx_recs = [route_cx_case(CX_MAIN[0], cx_a, plan, 57, rates, card,
                             race=True)]
    require(cx_recs[0]["n_aux_chunks"] > 0,
            f"{CX_MAIN[0]}: the complex plan has no aux level to race")
    cx_a = CX_ONLY[1]()
    got = plans._try_route_cx(cx_a)
    cx_recs.append(route_cx_case(CX_ONLY[0], cx_a, got[1], 58, rates,
                                 card))
    require(cx_recs[1]["slab_sized"],
            f"{CX_ONLY[0]}: the plan is below SLAB_MIN_CHUNKS")
    cx_a = CX_ROTATED[1]()
    got = plans._try_route_cx(cx_a)
    cx_recs.append(route_cx_case(CX_ROTATED[0], cx_a, got[1], 59, rates,
                                 card))
    require(cx_recs[2]["rotated"],
            f"{CX_ROTATED[0]}: the complex plan is not rotated")
    del cx_a, plan, got
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
    # the sparse algebra ops, DCSR and ELL (E1-E5): their results run the
    # ROUTE2 and band kernels through matrix_opt; the kernel records join
    # those kernels' entries (the paned one ahead of its head record)
    alg_main, t_kernel, s_kernel, d_kernel = algebra_phase(
        head, u300, general[ROUTE_MAIN[1][0]], rates, card)
    main += alg_main
    # the solvers, the band SpMV's gradient, the data and plan files (F)
    main += solver_phase(head, mats[DIA_MAIN[0][0]], rates, card)
    route_recs.append(t_kernel)
    band_recs.append(s_kernel)
    if d_kernel is not None and d_kernel["kernel"] == "route2_spmv":
        route_recs.append(d_kernel)
    elif d_kernel is not None:
        paned_recs.insert(0, d_kernel)
    del general, u300

    # the BSR and RCM-band rungs, SpMV then SpMM, and their kernels on
    # the main path's own plans
    bname, bargs, bsr_k = BSR_MAIN
    ba = block_csr(*bargs)
    rec, plan = main_path(bname, ba, "bsr", 87, card)
    main.append(rec)
    bsr_recs = bsr_cases(bname, plan[0], ba, bsr_k, 88, rates, card,
                         full=True) + bsr_recs
    rec = main_path_spmm(f"{bname}_k{bsr_k}", ba, "bsr", bsr_k, 89, card)[0]
    # the two tensor-core launches, and the FMA kernel gated behind them
    require(rec["launches"]["bsr_spmm"] == 2
            and rec["launches"]["bsr_spmm_gated"] == 1,
            f"{bname}_k{bsr_k}: not the tensor-core passes and one gated "
            f"launch")
    main.append(rec)
    del ba, plan
    pname, pseed, pk = PERM_MAIN
    pa = permuted_csr(head, pseed)
    # one handle for the SpMV and SpMM main paths: the plan cache
    # aliases the structured band_perm plan across both (its RCM
    # inspection runs once, as in a user's code)
    popt = sp.matrix_opt(pa)
    rec, plan = main_path(pname, pa, "band_perm", 90, card, opt=popt)
    main.append(rec)
    spmm_band_recs.append(band_perm_spmm_case(f"{pname}_k{pk}", plan, pk,
                                              91, rates, card, pa))
    spmm_band_recs += band_spmm_case(f"{pname}_k{pk}_padded", plan.band,
                                     pk, 91, rates, card, csr=pa)
    rec = main_path_spmm(f"{pname}_k{pk}", pa, "band_perm", pk, 92, card,
                         opt=popt)[0]
    require(rec["launches"]["band_spmm"] == 1,
            f"{pname}: {rec['launches']['band_spmm']} band_spmm launches")
    main.append(rec)
    del pa, plan, popt
    torch.cuda.empty_cache()
    # SpMM over the band (B streamed), SELL, DIA and the complex band
    rec = main_path_spmm(spmm_name, head, "band", SPMM_BANDED_K, 86,
                         card)[0]
    # one tensor-core launch, and the resident kernel gated behind it
    require(rec["launches"]["band_spmm_stream"] == 1
            and rec["launches"]["band_spmm_gated"] == 1
            and rec["launches"]["band_spmm"] == 0,
            f"{spmm_name}: not one tensor-core launch and one gated launch")
    main.append(rec)
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
    require(rec["launches"]["band_spmm_cx"] == 1
            and rec["launches"]["band_spmm"] == 0,
            f"{cname}: {rec['launches']['band_spmm_cx']} complex and "
            f"{rec['launches']['band_spmm']} real band SpMM launches")
    cx_planes = opt._plans["matmul"][1]
    spmm_cx_recs = band_cx_spmm_case(cname, cx_planes, ca, ck, 97, rates,
                                     card)
    spmm_band_recs += band_spmm_case(
        f"{cname}_real_plane", cx_planes[0], ck, 99, rates, card,
        csr=dataclasses.replace(ca, values=ca.values.real.contiguous()))
    del ca, opt, cx_planes
    # a band whose B fits the resident switch: the resident kernel, B
    # read in place (its rows past the window trimmed by the read)
    _, m, n, bw, _, seed = band_cases["odd_h_wide"]
    sa = gen.generate_banded_csr(m, n, bw, seed=seed)
    rec = main_path_spmm(f"odd_h_wide_k{SMALL_BAND_K}", sa, "band",
                         SMALL_BAND_K, 94, card, expect=("band_spmm",))[0]
    require(rec["launches"]["band_spmm"] == 1
            and rec["launches"]["band_spmm_stream"] == 0,
            f"odd_h_wide_k{SMALL_BAND_K}: not one resident launch")
    main.append(rec)
    del sa
    torch.cuda.empty_cache()
    # SpGEMM: the two-phase main paths on the mul engines, the block
    # SpGEMM through multiply, and their kernels
    spgemm_main_recs, spgemm_recs, deferred, cells = spgemm_phase(rates,
                                                                  card)
    main += spgemm_main_recs
    # the ROUTE v1 SpGEMM engine, the band power chain, and SpTRSV
    rec, v1_recs_mul, v1_deferred = v1_phase(rates, card)
    main.append(rec)
    deferred += v1_deferred
    rec, power_recs = power_phase(rates, card)
    main.append(rec)
    trsv_main_recs, solve_recs = trsv_phase(rates, card)
    main += trsv_main_recs
    # phase D: the distribution layer, on an NCCL world of one and a
    # gloo world of four ranks on the card
    dist_main, dist_recs = dist_phase(cells, rates, card)
    main += dist_main
    tables = {"spmm": SPMM_KIND_KERNELS, "spgemm": SPGEMM_KIND_KERNELS,
              "trsv": TRSV_KIND_KERNELS, "power": POWER_KIND_KERNELS}
    for r in main:
        table = tables.get(r.get("op"), KIND_KERNELS)
        for k in r.get("kernels") or table.get(r["kind"], ()):
            require(r["launches"][k] > 0,
                    f"{r['main_path']} ({r['kind']}) did not launch {k}")
    launches = {k: sum(r["launches"][k] for r in main) for k in WRAPPERS}
    require(all(launches.values()),
            f"main path missed a kernel: {launches}")

    # phase 4: one line per kernel and shape, with the launches of the
    # main-path call on that matrix (0: a kernel-only shape)
    by_name = {r["main_path"]: r["launches"] for r in main}
    for r in (band_recs + list(dia_recs.values()) + route_recs + [unperm]
              + cx_recs + v1_recs + paned_recs + spmm_band_recs
              + spmm_cx_recs + bsr_recs
              + spgemm_recs + v1_recs_mul + power_recs + solve_recs):
        r["launches"] = by_name.get(r["case"], {}).get(r["kernel"], 0)
        emit(r)

    def line(kname, source, replaces, head_rec, recs):
        # an f32 matrix product's least time is its tensor-core bound
        # (three TF32 products), with the f32 FMA bound beside it
        tc = head_rec.get("tc_bound_ms")
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": head_rec["kernel_ms"], "plain_ms": head_rec["plain_ms"],
                "bound_ms": head_rec["bound_ms"] if tc is None else tc,
                "bound_by": head_rec["bound_by" if tc is None
                                     else "tc_bound_by"],
                "library_ms": head_rec["library_ms"],
                "fma_bound_ms": None if tc is None else head_rec["bound_ms"],
                "tc_bound_ms": tc}

    def dist_line(r):
        # a distributed path's kernel: launches summed over the ranks of
        # its main-path call, the slowest rank's times and bound
        return {"name": f"{r['kernel']}@{r['case']}", "route": "cuda",
                "source": DIST_SOURCES[r["kernel"]][0],
                "replaces": DIST_SOURCES[r["kernel"]][1],
                "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

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
        line("route2_cx_spmv", ROUTE_SOURCE, CX_REPLACES, cx_recs[0],
             cx_recs),
        line("route_spmv", V1_SOURCE, V1_REPLACES,
             of(v1_recs, "route_spmv", RMAT_MAIN[0])[0], v1_recs),
        line("route_paned_spmv", PANED_SOURCE, PANED_REPLACES,
             paned_recs[-1], paned_recs),
        line("band_spmm", BAND_SPMM_SOURCE, BAND_SPMM_REPLACES,
             of(spmm_band_recs, "band_spmm", f"{pname}_k{pk}")[0],
             of(spmm_band_recs, "band_spmm")),
        line("band_spmm_cx", BAND_SPMM_SOURCE, BAND_CX_REPLACES,
             of(spmm_cx_recs, "band_spmm_cx", cname)[0], spmm_cx_recs),
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
    ] + [dist_line(r) for r in dist_recs]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    require(not deferred, "; ".join(deferred))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(run())

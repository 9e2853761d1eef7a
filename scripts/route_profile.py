#!/usr/bin/env python3
"""Device-time profile of the ROUTE SpMV kernels, the ROUTE2 solve, the
paned SpGEMM fill, the band row kernel and the two streamed SpMM kernels
of spblas_tpu_torch on their main-path shapes: ``route_spmv`` (ROUTE v1)
on the degree-sorted base plan of the 131k R-MAT graph (bench.py:768,
seed 5), ``route_paned_spmv`` (paned ROUTE2) on uniform 4M degree 10
(bench.py:606, seed 3), ``route2_spmv`` (resident ROUTE2) on uniform 300k
and 1M degree 10 (bench.py:145, :794, seed 3, chip_smoke.py's
``ROUTE_MAIN``), ``route2_solve`` on the 20k triangular factor and the 1M
block chain (bench.py:410-417, :467-482, chip_smoke.py's ``TRSV_MAIN``),
the paned fill ``route2_mul_paned`` on the 100k A.A product (bench.py:254)
and chip_smoke.py's paned hub fixture, ``band_spmv`` (f32 and bf16
panels) and ``band_power`` (10 iterations) on the 409,600-row headline
band (bench.py:125, seed 0), ``band_spmm_stream`` on that band at k 256
(f32 and bf16 panels; bench.py:574), ``bsr_spmm`` on chip_smoke.py's
block cell (``BSR_MAIN``: 131,072^2, 65,536 blocks of 8x128, k 256),
``route_cx`` over ROUTE2 plans on uniform 100k and 300k complex64 degree
10 (chip_smoke.py's ``CX_MAIN`` and ``CX_ONLY``: the complex pass beside
the four real applies it replaced) and ``bsr_spgemm`` on chip_smoke.py's
32,768^2 block product (f32, f64) and its (8,128).(128,128) case,
``bsr_spmv`` on the block cell's BSR, the 8x8 kernel-only shape and the
3x3 blocks of a 27-point 64^3 node grid (f32, f64), the ROUTE v1
SpGEMM numeric ``route_mul`` on the 2k A.A v1 plan and the dup-40
stream, the resident SpGEMM numeric ``route2_mul`` on the 2k A.A plan
and the resident hub fixture, and ``dia_spmv`` on the three DIA main
paths and two kernel-only shapes, each as the CUDA chooser or
``chip_smoke.py`` builds it.

    python3 scripts/route_profile.py [--tree DIR ...] [--kernels K,...]
                                     [--out FILE] [--no-variants]
                                     [--graph]

Each ``--tree`` is a checkout holding ``spblas_tpu_torch/`` (default: this
one); the trees run one worker process each, in the order given, so
``--tree _checkout/parent --tree . --tree . --tree _checkout/parent``
compares two versions in turns on one card.  ``--kernels`` picks from
``v1``, ``paned``, ``route2``, ``solve``, ``band``, ``mul_paned``,
``band_mm``, ``bsr_mm``, ``cx``, ``block_spgemm``, ``bsr_mv``,
``v1_mul``, ``mul`` and ``dia`` (``spmm`` names
``band_mm`` and ``bsr_mm``, ``route_cx`` ``cx``, ``bsr_spgemm``
``block_spgemm``; default: all); ``--only-variants`` names the variants
to run (default: every one that applies).
A worker reports, per kernel:

- what ``nvcc -Xptxas -v`` says of each of its ``__global__`` functions
  (registers a thread, shared memory a block, spill bytes) and the blocks
  an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from a
  small library built beside it that includes the kernel's source);
- the kernel chain as ``chip_smoke.py`` defines it (CUDA events over
  chains cycling through copies past the 50 MB L2, a device sleep queued
  ahead so host time does not count): the v1 levels from the packed
  level-0 x, the paned panels and the resident ROUTE2 launches (pane
  zeroing included), the solve as the tree runs it (one launch a level
  from one C call, or one persistent launch), one band SpMV, ten band
  power iterations, the paned fill (the tile walker's launches per
  panel, or the slot fill's one launch), one SpMM; beside them cuSPARSE's
  ``torch.mv`` on the same matrix, or its SpGEMM with the symbolic pass,
  or its SpMM (``torch.matmul`` on the sparse CSR), and the whole
  ``multiply_fill``, or the whole ``multiply(scaled(2.0, matrix_opt(A)),
  B)`` over distinct B, with the host;
- with ``--graph``, each solve replayed from a CUDA graph of one call
  (the host's enqueue out, the device's launch latency in); on a tree
  with the persistent solve, its ``stretch_N`` levers (the work list
  rebuilt with one-block stretches over launch ranges of at most N
  chunks, 0: none);
- the same chain rebuilt from variants of the tree's sources (the first
  time a tree appears, unless ``--no-variants``): ``no_publish`` (each
  publish ``atomicAdd``, or the slot fill's store, made a predicated
  store that never fires), ``const_gather`` (every x or pane read of the
  gather replaced by 1.0; the slot fill's A and B gathers by a value made
  from their indices), both at once (for the tile-walking paned fill
  of older trees: the tile stream alone), for the one-launch v1 kernel ``no_stream``
  (its ring filled by nothing) alone and with the other two, for the
  SpMM kernels ``const_b`` (every read of B taken from B's first 1,024
  rows, or the first column block's slice, so B costs no device-memory
  traffic) and ``const_a`` (every panel or block value read from the
  first 1,024 panel rows or the first block), and the ``lever_*``
  variants, each of
  which changes one integer design constant of the slab-staged ROUTE2
  kernel, the band row kernel or an SpMM kernel (for the old FMA
  ``bsr_spmm``: ``lever_ktile_64``, the k-tile cut to 64 columns, and
  ``lever_ktile_64_outer``, that with the k-tile the grid's slowest
  index, so one phase reads a 33.5 MB slice of B) (a variant runs only
  where its pattern matched, so a tree without the constant skips it),
  each output held to the plain version (``*_in_bound``);
- for the SpMM kernels, the bound: the larger of the bytes (each input
  once, C once) over 3.35 TB/s and the operations over the 67 TFLOP/s
  f32 peak (``fma_bound_ms``) or three times them over the 494.7
  TFLOP/s TF32 peak (``tc_bound_ms``, the full-f32 3xTF32 product);
- one ``torch.profiler`` trace of three chains and of three public
  applies (host included): the device operations a call, their busy
  time and the gaps between them, and the first 40 operations in order;
  the traces go to ``--trace-dir``.

Prints one JSON object per worker and writes them all to ``--out``.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import inspect
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (kernels, file, regex, replacement): a variant rebuilds the kernels
# whose patterns match (the paned and resident ROUTE2 kernels run
# route2_chunk.cuh's body)
_CHUNK = ("paned", "route2")
_PUBLISH = [
    (("v1",), "route_spmv.cu", r"atomicAdd\((\w+) \+ row \* kLanes \+ j, ",
     r"route_sink(\1 + row * kLanes + j, "),
    (_CHUNK, "route2_chunk.cuh",
     r"atomicAdd\((\w+ \+ row \* kLanes(?: \+ j)?), ", r"route_sink(\1, "),
    # the slot fill's one store a slot (the tiered kernel's and the short
    # kernel's)
    (("mul_paned", "mul"), "mul_fill.cu", r"c\[s\] = acc(\[k\])?;",
     r"route_sink(c + s, acc\1);")]
_GATHER = [
    (("v1",), "route_spmv.cu",
     r"\w+\[row \* kLanes \+ bits\(a\[i\], 3, 127\)\]", "1.0f"),
    (("v1",), "route_spmv.cu", r"d \? __ldcg\(px\) : __ldg\(px\)", "1.0f"),
    (_CHUNK + ("mul_paned",), "route2_chunk.cuh",
     r"src\[row \* kLanes \+ j\]", "1.0f"),
    # the slot fill's A and B gathers become a value made from the two
    # indices (their loads stay; only the gathers go)
    (("mul_paned", "mul"), "mul_fill.cu",
     r"A\[sa\[e\]\] \* B\[sb\[e\]\]",
     "__int_as_float(((sa[e] ^ sb[e]) & 0x7fff) | 0x3f800000)"),
    (("mul_paned", "mul"), "mul_fill.cu",
     r"(p[ab])\[k\] = [AB]\[(i[ab])\[k\]\];",
     r"\1[k] = __int_as_float((\2[k] & 0x7fff) | 0x3f800000);"),
    (("route2",), "route2_spmv.cu",
     r"slab\[min\(bits\(t\[a\], 0, 255\), rows - 1\) \* kLanes \+ j\]",
     "1.0f")]
# the one-launch v1 kernel only: no plan stream (the ring's bulk copies
# dropped; the chunks compute on whatever the ring holds)
_STREAM = [(("v1",), "route_spmv.cu",
            r"bar_expect\(bar, \d \* kTileBytes\);", "bar_expect(bar, 0);"),
           (("v1",), "route_spmv.cu", r"bulk_load\(st\.[^;]*\);", ";")]


def _lever(tag, fname, const, value):
    """One integer design constant of a kernel source set to ``value``."""
    return [[((tag,), fname, rf"(constexpr int {const} = )[^;]+;",
              rf"\g<1>{value};")]]


# the SpMM kernels: B's reads from its first 1,024 rows (the band) or
# the first column block's slice (BSR), A's from the first 1,024 panel
# rows or the first block: the loads stay, spread over the L2 slices,
# and their device-memory traffic goes
_CONST_B = [(("band_mm",), "band_spmm.cu",
             r"bp \+ \(r0 \+ c0 \+ cc\) \* k \+ col0 \+ j",
             "bp + ((r0 + c0 + cc) & 1023) * k + col0 + j"),
            (("band_mm",), "band_spmm.cu",
             r"bp \+ q \* k \+ col0 \+ j", "bp + (q & 1023) * k + col0 + j"),
            (("band_res",), "band_spmm.cu",
             r"a\.b \+ static_cast<long long>\(src\[t\]\) \* a\.kf",
             "a.b + static_cast<long long>(src[t] & 1023) * a.kf"),
            (("bsr_mm",), "bsr_spmm.cu",
             r"b \+ static_cast<long long>\(colind\[e\]\) \* bw \* k", "b"),
            (("bsr_mm",), "bsr_spmm.cu",
             r"b \+ static_cast<long long>\(j\) \* bw \* k", "b")]
_CONST_A = [(("band_mm",), "band_spmm.cu",
             r"panels\[\(r0 \+ r\) \* w \+ c\]",
             "panels[((r0 + r) & 1023) * w + c]"),
            (("band_mm",), "band_spmm.cu",
             r"panels \+ \(r0 \+ r\) \* w \+ c\b",
             "panels + ((r0 + r) & 1023) * w + c"),
            (("band_res",), "band_spmm.cu",
             r"p \+ \(r0 \+ r\) \* a\.w \+ c0 \+ cc",
             "p + ((r0 + r) & 1023) * a.w + c0 + cc"),
            (("bsr_mm",), "bsr_spmm.cu",
             r"values \+ static_cast<long long>\(e\) \* bh \* bw", "values")]
# the old FMA bsr_spmm only (whose f32 entry point launches it; the f64
# kernel keeps the design): a group that matches and changes nothing
_FMA_F32 = [(("bsr_mm",), "bsr_spmm.cu", r"(return launch<float>\()", r"\1")]
# the old FMA bsr_spmm: its k-tile as the grid's slowest index
_KTILE_OUTER = [(("bsr_mm",), "bsr_spmm.cu",
                 r"const int kt = blockIdx\.x % ktiles;\n"
                 r"  const long long rest = blockIdx\.x / ktiles;",
                 "const long long nrest = gridDim.x / ktiles;\n"
                 "  const int kt = static_cast<int>(blockIdx.x / nrest);\n"
                 "  const long long rest = blockIdx.x % nrest;")]

# a variant is a list of groups; a kernel is rebuilt under it where each
# group matched somewhere in its sources
VARIANTS = {"no_publish": [_PUBLISH], "const_gather": [_GATHER],
            "no_publish_const_gather": [_PUBLISH, _GATHER],
            "no_stream": [_STREAM],
            "no_stream_publish_gather": [_STREAM, _PUBLISH, _GATHER],
            # the slab-staged ROUTE2 kernel's groups a block
            "lever_groups_4": _lever("route2", "route2_spmv.cu", "kGroups",
                                     "4"),
            # the persistent solve's polling sleep and blocks an SM
            "lever_solve_poll_0": _lever("solve", "route2_spmv.cu",
                                         "kPollNs", "0"),
            "lever_solve_blocks_8": _lever("solve", "route2_spmv.cu",
                                           "kSolveBlocks", "8"),
            # the slot fill's hub cut; its middle tier off (runs past
            # kLong take the whole block, as before it)
            "lever_fill_long_256": _lever("mul_paned", "mul_fill.cu",
                                          "kLong", "256"),
            "lever_fill_mid_32": [[(("mul_paned", "v1_mul"), "mul_fill.cu",
                                    r"(constexpr int kMid = )[^;]+;",
                                    r"\g<1>32;")]],
            # the short kernel's slots a thread
            "lever_fill_slots_1": [[(("mul_paned", "v1_mul", "mul"),
                                     "mul_fill.cu",
                                     r"(constexpr int kSlots = )[^;]+;",
                                     r"\g<1>1;")]],
            "lever_fill_slots_4": [[(("mul_paned", "v1_mul", "mul"),
                                     "mul_fill.cu",
                                     r"(constexpr int kSlots = )[^;]+;",
                                     r"\g<1>4;")]],
            # the short fill's products a slot a round
            **{f"lever_fill_round_{n}": [[(("mul_paned", "v1_mul", "mul"),
                                           "mul_fill.cu",
                                           r"(constexpr int kRound = )[^;]+;",
                                           rf"\g<1>{n};")]]
               for n in (1, 2, 8)},
            # the in-place DIA kernel's threads a block and outputs a
            # thread
            "lever_dia_threads_256": _lever("dia", "dia_spmv.cu",
                                            "kInThreads", "256"),
            "lever_dia_threads_64": _lever("dia", "dia_spmv.cu",
                                           "kInThreads", "64"),
            "lever_dia_vec_8": _lever("dia", "dia_spmv.cu", "kVec", "8"),
            # the small BSR SpMV's CTAs an SM (its register cap, f32 and
            # f64) and row stages a warp, and a diagnostic (x's gathers
            # replaced by a constant; out of bound)
            "lever_bsr_min_small_8": _lever("bsr_mv", "bsr_spmv.cu",
                                            "kMinSmall", "8"),
            "lever_bsr_min_small64_4": _lever("bsr_mv", "bsr_spmv.cu",
                                              "kMinSmall64", "4"),
            "lever_bsr_ring_3": _lever("bsr_mv", "bsr_spmv.cu", "kRing",
                                       "3"),
            "lever_bsr_ring64_4": _lever("bsr_mv", "bsr_spmv.cu", "kRing64",
                                         "4"),
            "diag_bsr_small_no_x": [[(("bsr_mv",), "bsr_spmv.cu",
                                      r"at < n \? __ldg\(x \+ at\) : T\(0\)",
                                      "at < n ? T(1) : T(0)")]],
            # every shape on the cols mapping (a warp an output row)
            "lever_bsr_cols_only": [[(("bsr_mv",), "bsr_spmv.cu",
                                      r"if \(mapping == kCols\)",
                                      "if (true)")]],
            # the band row kernel's
            "lever_band_warps_4": _lever("band", "band_row.cuh", "kWarps",
                                         "4"),
            "lever_band_rows_128": _lever("band", "band_row.cuh",
                                          "kItemRows", "128"),
            "lever_band_warps_16_rows_128": _lever(
                "band", "band_row.cuh", "kWarps", "16") + _lever(
                "band", "band_row.cuh", "kItemRows", "128"),
            "lever_band_loads_16": _lever("band", "band_row.cuh", "kLoads",
                                          "16"),
            "lever_band_scalar": [[(("band",), "band_row.cuh",
                                    r"const bool vec = ", "const bool vec = "
                                    "false && ")]],
            # the SpMM kernels (old FMA designs and tensor-core ones)
            "const_b": [_CONST_B], "const_a": [_CONST_A],
            "const_a_const_b": [_CONST_A, _CONST_B],
            "lever_ktile_64": _lever("bsr_mm", "bsr_spmm.cu", "kColThreads",
                                     "16") + [_FMA_F32],
            "lever_ktile_64_outer": _lever("bsr_mm", "bsr_spmm.cu",
                                           "kColThreads", "16")
            + [_KTILE_OUTER, _FMA_F32],
            # the column-grouped f32 bsr_spmm: one CTA an SM (no register
            # cap) or three (85 registers); k-tiles of 128 columns (two
            # warps along them)
            "lever_bsr_min_blocks_1": _lever("bsr_mm", "bsr_spmm.cu",
                                             "kMinBlocks", "1"),
            "lever_bsr_min_blocks_3": _lever("bsr_mm", "bsr_spmm.cu",
                                             "kMinBlocks", "3"),
            "lever_bsr_warps_n_2": _lever("bsr_mm", "bsr_spmm.cu", "kWarpsN",
                                          "2")
            + _lever("bsr_mm", "bsr_spmm.cu", "kWarpsM", "4"),
            "lever_band_mm_warps_n_4": _lever("band_mm", "band_spmm.cu",
                                              "kWarpsN", "4"),
            # the resident band SpMM's CTAs an SM (its register cap),
            # columns of W a stage and ring stages
            "lever_res_blocks_2": _lever("band_res", "band_spmm.cu",
                                         "kResBlocks", "2"),
            "lever_res_blocks_4": _lever("band_res", "band_spmm.cu",
                                         "kResBlocks", "4"),
            "lever_res_chunk_32": _lever("band_res", "band_spmm.cu",
                                         "kResChunk", "32"),
            "lever_res_stages_4": _lever("band_res", "band_spmm.cu",
                                         "kResStages", "4"),
            # measurement only (stale shared memory, out of bound): the
            # resident kernel with its ring filled once, not in the loop
            "diag_res_no_fetch": [[(("band_res",), "band_spmm.cu",
                                    r"if \(nx < nchunks\) \{\n(\s+)fetch<T, "
                                    r"KTF, MODE>",
                                    "if (false) {\n\\1fetch<T, KTF, MODE>")]],
            # the complex ROUTE2 kernel's blocks an SM; the block
            # SpGEMM's copy ring (f64 and the 16-row tile)
            "lever_cx_min_blocks_4": _lever("cx", "route2_spmv.cu",
                                            "kMinBlocksCx", "4"),
            "lever_cx_min_blocks_12": _lever("cx", "route2_spmv.cu",
                                             "kMinBlocksCx", "12"),
            "lever_spgemm_ring_4": _lever("block_spgemm", "bsr_spgemm.cu",
                                          "kRing", "4"),
            "lever_spgemm_small_ring_5": _lever(
                "block_spgemm", "bsr_spgemm.cu", "kRingSmall", "5"),
            "lever_spgemm_small_ring_5_blocks_3": _lever(
                "block_spgemm", "bsr_spgemm.cu", "kRingSmall", "5")
            + _lever("block_spgemm", "bsr_spgemm.cu", "kSmallMinBlocks",
                     "3"),
            "lever_cx_min_blocks_10": _lever("cx", "route2_spmv.cu",
                                             "kMinBlocksCx", "10"),
            # the block SpGEMM's 16-row tiles (bh <= 16; f64 also bh <= 8)
            # left out: such C blocks run the 128-row tiles
            "lever_spgemm_no_small": [[(("block_spgemm",), "bsr_spgemm.cu",
                                        r": bh <= 16 \?", ": bh <= 0 ?"),
                                       (("block_spgemm",), "bsr_spgemm.cu",
                                        r"launch<double, Big64, Small64, "
                                        r"Small64>",
                                        "launch<double, Big64, Big64, "
                                        "Big64>")]],
            # the block SpGEMM's two mma steps a stage not unrolled in
            # the f32 tile configs too (the f64 ones are not unrolled)
            "lever_spgemm_step_unroll_1": [[(("block_spgemm",),
                                             "bsr_spgemm.cu",
                                             r"#pragma unroll\n(\s+for "
                                             r"\(int s = 0; s < kDepth / 8)",
                                             "#pragma unroll 1\n\\1")]],
            "lever_spgemm_big_blocks_1": _lever(
                "block_spgemm", "bsr_spgemm.cu", "kBigMinBlocks", "1"),
            # the split's clamp in integer operations: hi's bits capped by
            # the largest finite TF32 value of x's sign (one LOP3, one
            # IMNMX) in place of two f32 min/max
            "lever_split_int": [[(("band_mm", "bsr_mm", "block_spgemm"),
                                  "tf32_mma.cuh",
                                  r"const float h = fminf\(fmaxf\("
                                  r"__uint_as_float\(rna\(x\)\), -m\), "
                                  r"m\);",
                                  "const float h = __uint_as_float(min("
                                  "rna(x), (__float_as_uint(x) & "
                                  "0x80000000u) | kMaxTf32));")]],
            # the mma statements without `volatile`: the compiler may then
            # interleave independent tiles' three-product chains
            "lever_mma_free": [[(("band_mm", "bsr_mm", "block_spgemm"),
                                 "tf32_mma.cuh",
                                 r"asm volatile\(\n(\s+)\"mma\.sync",
                                 "asm(\n\\1\"mma.sync"),
                                (("block_spgemm",), "bsr_spgemm.cu",
                                 r"asm volatile\(\n(\s+)\"mma\.sync",
                                 "asm(\n\\1\"mma.sync")]],
            # the split's rounding by cvt.rna.tf32.f32 in place of the two
            # integer operations
            "lever_cvt_rna": [[(("band_mm", "bsr_mm"), "tf32_mma.cuh",
                                r"return \(__float_as_uint\(x\) \+ 0x1000u\) "
                                r"& 0xffffe000u;",
                                "uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;"
                                "\" : \"=r\"(r) : \"f\"(x));\n  return r;")]]}
_SINK = ("\n#ifndef ROUTE_SINK\n#define ROUTE_SINK\n"
         "__device__ __forceinline__ void route_sink(float* p, float v) "
         "{ if (v == 1.2345e-30f) *p = v; }\n"
         "__device__ __forceinline__ void route_sink(float2* p, float2 v) "
         "{ if (v.x == 1.2345e-30f) *p = v; }\n#endif\n")
_SLEEP_CYCLES = 50_000_000
_REPLICA_BYTES = 256 << 20


def variant_csrc(csrc: Path, dest: Path, groups):
    """A copy of ``csrc`` with the substitutions applied, and the
    kernels for which every group matched (a variant of one design may
    not apply to the other)."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(csrc, dest)
    hits = {}
    for gi, group in enumerate(groups):
        for tags, fname, pat, rep in group:
            path = dest / fname
            if not path.exists():       # a source of another tree
                continue
            new, n = re.subn(pat, rep, path.read_text())
            for tag in tags:
                hits[tag, gi] = hits.get((tag, gi), 0) + n
            if "route_sink(" in new and "void route_sink" not in new:
                head = new.index("\n", new.index("#include"))
                new = new[:head] + _SINK + new[head:]
            path.write_text(new)
    return dest, {t for t, _ in hits
                  if all(hits.get((t, gi), 0) for gi in range(len(groups)))}


# kernel tag -> the sources whose build it times (a tree builds those it
# has: the paned fill's source changed its name)
SOURCES = {"v1": ("route_spmv",), "paned": ("route_paned_spmv",),
           "route2": ("route2_spmv",), "solve": ("route2_spmv",),
           "band": ("band_spmv", "band_power"),
           "mul_paned": ("route_mul_paned", "mul_fill"),
           "band_mm": ("band_spmm",), "band_res": ("band_spmm",),
           "bsr_mm": ("bsr_spmm",),
           "cx": ("route2_spmv",), "block_spgemm": ("bsr_spgemm",),
           "bsr_mv": ("bsr_spmv",), "v1_mul": ("route_mul", "mul_fill"),
           "mul": ("route2_mul", "mul_fill"), "dia": ("dia_spmv",)}
# --kernels aliases
ALIASES = {"spmm": ("band_mm", "bsr_mm"), "route_cx": ("cx",),
           "resident": ("band_res",),
           "bsr_spgemm": ("block_spgemm",)}
# source -> (kernel expression, threads, dynamic shared bytes) of each
# __global__ that a design of it may hold; those a tree lacks fail to
# build and are left out
OCCUPANCY = {
    "route_spmv": [("route_spmv_kernel", 128, 0)],
    "route_paned_spmv": [("route_paned_spmv_kernel", 128, 0)],
    "route2_spmv": [("route2_spmv_kernel", 128, 0),
                    ("route2_apply_kernel<true>", 128, 0),
                    ("route2_apply_kernel<false>", 128, 0),
                    ("route2_apply_kernel", 128, 0),
                    ("route2_solve_kernel", 128, 0),
                    ("route2_slab_kernel", "kSlabThreads", "kSlabSmem"),
                    ("route2_cx_kernel<float2>", 128, 0)],
    "route_mul_paned": [("route_mul_paned_kernel", 128, 0)],
    # the one-kernel designs, then the short kernel and the tiered one
    # with and without the hub tier
    "mul_fill": [("mul_fill_kernel", 256, 0),
                 ("mul_fill_kernel<true>", 256, 0),
                 ("mul_fill_kernel<false>", 256, 0),
                 ("mul_fill_kernel<false, false>", 256, 0),
                 ("mul_fill_kernel<false, true>", 256, 0),
                 ("mul_fill_kernel<true, false>", 256, 0),
                 ("mul_fill_kernel<true, true>", 256, 0)],
    "dia_spmv": [("dia_spmv_kernel", 256, 0),
                 ("dia_inplace_kernel<float, 5>", 128, 0),
                 ("dia_inplace_kernel<float, 7>", 128, 0),
                 ("dia_inplace_kernel<float, 9>", 128, 0),
                 ("dia_inplace_kernel<float, 32>", 128, 0)],
    "band_spmv": [("band::row_kernel<float>", 256, 0),
                  ("band::row_kernel<__nv_bfloat16>", 256, 0),
                  ("band::row_kernel<float, 4>", "band::kThreads", 928),
                  ("band::row_kernel<__nv_bfloat16, 8>", "band::kThreads",
                   928),
                  ("band::row_kernel<float, 1>", "band::kThreads", 928)],
    # the old FMA designs, then the tensor-core ones and the resident
    # FMA kernel of PR 12 (real k-tiles of 64 and 32 floats, bf16, the
    # complex pass)
    "band_spmm": [("band_spmm_stream<float, true>", 256, 0),
                  ("band_spmm_stream<__nv_bfloat16, true>", 256, 0),
                  ("band_spmm_resident<float, true>", 256, 0),
                  ("res::band_spmm_res<float, 64, 0>", "res::kThreads",
                   "res::Layout<float, 64, 0>::kSmemBytes"),
                  ("res::band_spmm_res<float, 32, 0>", "res::kThreads",
                   "res::Layout<float, 32, 0>::kSmemBytes"),
                  ("res::band_spmm_res<__nv_bfloat16, 64, 0>",
                   "res::kThreads",
                   "res::Layout<__nv_bfloat16, 64, 0>::kSmemBytes"),
                  ("res::band_spmm_res<float, 64, 1>", "res::kThreads",
                   "res::Layout<float, 64, 1>::kSmemBytes"),
                  ("tc::band_spmm_tc<float, true, true>", "tc::kThreads",
                   "tc::kSmemBytes"),
                  ("tc::band_spmm_tc<__nv_bfloat16, true, true>",
                   "tc::kThreads", "tc::kSmemBytes")],
    # the one-warp-a-row design, then the three mappings (cols, span,
    # small)
    "bsr_spmv": [("bsr_spmv_kernel<float>", 256, 0),
                 ("bsr_cols<float, 4, 1>", 256, 0),
                 ("bsr_span<float, 4>", 256, 0),
                 ("bsr_small<float>", 128, 0),
                 ("bsr_small<double>", 128, 0)],
    "bsr_spmm": [("bsr_spmm_kernel<float, true>", 64, 0),
                 ("tc::bsr_spmm_tc<true>", "tc::kThreads", 0),
                 ("tc::bsr_spmm_columns<true>", "tc::kThreads",
                  "tc::kSmemBytes"),
                 ("tc::bsr_row_sums<true>", "tc::kSumThreads", 0)],
    # the old FMA design (32 x 8 threads at bh >= 64), then the
    # tensor-core one
    "bsr_spgemm": [("bsr_spgemm_kernel<float, true>", 256, 0),
                   ("bsr_spgemm_kernel<double, true>", 256, 0),
                   ("bsr_spgemm_tc<float, Big32, true>", "Big32::kThreads",
                    "Layout<float, Big32>::kSmemBytes"),
                   ("bsr_spgemm_tc<double, Big64, true>", "Big64::kThreads",
                    "Layout<double, Big64>::kSmemBytes"),
                   ("bsr_spgemm_tc<float, Small32, true>",
                    "Small32::kThreads",
                    "Layout<float, Small32>::kSmemBytes"),
                   ("bsr_spgemm_tc<float, Tiny32, true>", "Tiny32::kThreads",
                    "Layout<float, Tiny32>::kSmemBytes")]}


def sources(_build, tag):
    """The sources of ``tag`` that the tree has."""
    return [n for n in SOURCES[tag] if (_build.CSRC / f"{n}.cu").exists()]


def ptxas_report(text: str):
    """{function: {registers, smem, spill_stores, spill_loads}} from the
    ``-Xptxas -v`` lines of one build."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True,
                               timeout=30).stdout.split("\n")
        return {n: dict(out[m], mangled=m) for m, n in zip(out, names)}
    except (OSError, subprocess.SubprocessError):
        return out


def build_report(_build, names):
    """Build the sources ``names`` (all nvcc processes started together)
    and return their ptxas reports."""
    started = {n: _build._start(n) for n in names}
    return {n: ptxas_report(_build._finish(n, s)) for n, s in
            started.items()}


def occupancy(_build, names, work: Path):
    """Blocks an SM holds for each known ``__global__`` of ``names``:
    one library per kernel that includes the source and asks the runtime
    (the kernel must be in the same translation unit), all built at
    once; kernels a source lacks fail to build and are skipped."""
    import ctypes
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src = (_build.CSRC / f"{name}.cu").resolve()
        for i, (expr, threads, smem) in enumerate(OCCUPANCY.get(name, ())):
            cu = work / f"occ_{name}_{i}.cu"
            cu.write_text(
                f'#include "{src}"\n'
                'extern "C" int spb_occupancy(int* blocks) {\n'
                # a kernel past 48 KB of dynamic shared memory needs the
                # limit raised first, as its launcher does
                f"  cudaFuncSetAttribute({expr}, cudaFuncAttributeMax"
                f"DynamicSharedMemorySize, static_cast<int>({smem}));\n"
                f"  return static_cast<int>(cudaOccupancyMaxActiveBlocks"
                f"PerMultiprocessor(blocks, {expr}, {threads}, {smem}));\n"
                "}\n")
            lib = cu.with_suffix(".so")
            proc = subprocess.Popen(
                [_build._nvcc(), *[f for f in _build.NVCC_FLAGS
                                   if f != "-Xptxas=-v"],
                 "-o", str(lib), str(cu)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            jobs.append((name, expr, threads, smem, lib, proc))
    out = {}
    for name, expr, threads, smem, lib, proc in jobs:
        if proc.wait() != 0:
            continue
        fn = ctypes.CDLL(str(lib)).spb_occupancy
        fn.argtypes = (ctypes.POINTER(ctypes.c_int),)
        blocks = ctypes.c_int(0)
        code = fn(ctypes.byref(blocks))
        out[f"{name}:{expr}"] = {"threads": threads, "dyn_smem": smem,
                                 "blocks_per_sm": blocks.value,
                                 "error": code}
    return out


def device_ms(torch, fn, inputs, reps=None):
    reps = reps or max(20, 2 * len(inputs))
    fn(*inputs[0])
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


def trace_ops(torch, fn, args, calls, sleep, path):
    """Device operations of ``calls`` runs of ``fn`` from one profiler
    trace: [(name, start_us, dur_us)] in start order."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if sleep:
            torch.cuda._sleep(_SLEEP_CYCLES)
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(Path(path).read_text())["traceEvents"]
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events
           if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
           and not any(s in e["name"] for s in ("sleep", "spin_kernel"))]
    ops.sort(key=lambda o: o[1])
    return ops


def summarise(ops, calls, listed=40):
    """Per-call device op count and busy time, gap total, and the first
    ``listed`` ops of the first call (name, dur) with the gap before
    each."""
    if not ops:
        return {"device_ops": 0}
    per = len(ops) // calls
    busy = sum(d for _, _, d in ops)
    span = ops[-1][1] + ops[-1][2] - ops[0][1]
    first = []
    prev_end = None
    for name, ts, dur in ops[:min(per, listed)]:
        gap = None if prev_end is None else round(ts - prev_end, 3)
        first.append({"op": name[:60], "us": round(dur, 3), "gap_us": gap})
        prev_end = ts + dur
    return {"device_ops_per_call": per, "busy_us_per_call": busy / calls,
            "span_us_per_call": span / calls,
            "gap_us_per_call": (span - busy) / calls, "first_call": first}


def csr_ms(torch, a, x):
    """cuSPARSE's ``torch.mv`` on the CSR ``a`` (the yardstick of
    chip_smoke.py's ``library_ms``), over distinct copies of the values."""
    def make():
        return (torch.sparse_csr_tensor(a.rowptr, a.colind[: a.nnz].clone(),
                                        a.values[: a.nnz].clone(),
                                        size=a.shape), x.clone())
    k = min(32, max(2, math.ceil(_REPLICA_BYTES / max(a.nnz * 8, 1))))
    return device_ms(torch, torch.mv, [make() for _ in range(k)])


def within(torch, ref, absref):
    """A check of a chain's output against the plain version ``ref()``:
    per row within 64 eps (``absref()``, the same sum on |A| and |x|),
    as chip_smoke.py's ``row_check``; the references are made once."""
    cache = {}

    def check(y):
        if not cache:
            cache["ref"], cache["abs"] = ref().double(), absref().double()
        lim = 64 * torch.finfo(torch.float32).eps * cache["abs"]
        return bool(((y.double() - cache["ref"]).abs() <= lim).all())

    return check


def reps_of(make, nbytes):
    k = min(32, max(2, math.ceil(_REPLICA_BYTES / max(nbytes, 1))))
    return [make() for _ in range(k)]


def v1_bench(torch, sp, gen, rec):
    """The v1 chain on the R-MAT sorted base: (chain, inputs, apply)."""
    import dataclasses
    from spblas_tpu_torch.kernels import plans
    from spblas_tpu_torch.kernels import route_spmv as rsp
    # one launch per apply (the chain API changed with it)
    fused_v1 = hasattr(rsp, "route_spmv_fused_reference")
    rmat = gen.generate_rmat_csr(131_072, 131_072 * 16, seed=5)
    kind, sorted_plan = plans._try_route(rmat)
    assert kind == "route1_sorted", kind
    base = sorted_plan.base
    levels = []
    p = base
    while p is not None:
        levels.append(p)
        p = p.aux_plan
    x_v1 = gen.generate_vector(rmat.shape[1], seed=74)

    def v1_copy():
        ps, prev = [], None
        for q in reversed(levels):
            q = dataclasses.replace(q, aux_plan=prev, **{
                f: getattr(q, f).clone() for f in (
                    "tile1", "tile3", "val", "slab_base", "y_base")})
            if fused_v1:
                q = dataclasses.replace(q, **{
                    f: getattr(q, f).clone()
                    for f in ("fused_sb", "fused_yb")})
            ps.insert(0, q)
            prev = q
        if fused_v1:
            return (ps[0], rsp.pack_x(ps[0], x_v1))
        xs = [rsp.pack_x(q, torch.rand(q.shape[1], device="cuda"))
              for q in ps]
        return (ps, xs)

    def v1_chain(ps, xs):
        if fused_v1:
            return rsp.route_spmv_padded(ps, xs)
        for q, x2 in zip(ps, xs):
            rsp.route_spmv_padded(q, x2)

    v1_bytes = sum(q.nchunks * (12 * 1024 + 8) + q.x_rows * 512
                   + 2 * q.pane_rows * 512 for q in levels)
    rec.update({"fused_v1": fused_v1, "levels": len(levels),
                "nchunks": [q.nchunks for q in levels], "bytes": v1_bytes})
    return {"v1": (v1_chain, reps_of(v1_copy, v1_bytes),
                   (rsp.route_spmv, (base, x_v1)), None)}


def paned_bench(torch, sp, gen, rec):
    import dataclasses
    from spblas_tpu_torch.kernels import plans
    from spblas_tpu_torch.kernels import route_paned as rpn
    big = gen.generate_csr(4_000_000, 4_000_000, 40_000_000, seed=3)
    kind, paned = plans._try_route_paned(big)
    assert kind == "route_paned", kind
    x_pn = gen.generate_vector(big.shape[1], seed=75)
    del big

    def pn_copy():
        pl = dataclasses.replace(paned, panels=tuple(
            dataclasses.replace(q, **{f: getattr(q, f).clone() for f in (
                "tile", "val", "sb", "yb", "fl", "rho", "pane")})
            for q in paned.panels))
        return (pl, rpn.pack_x2(pl, x_pn))

    def pn_chain(pl, xx):
        for q in pl.panels:
            rpn.route_paned_spmv_padded(pl, q, xx)

    pn_bytes = paned.x_rows_pad * 512 + sum(
        q.nchunks * (8 * 1024 + 16 + 4 * q.rotated) + 2 * q.out_rows * 512
        for q in paned.panels)
    rec.update({"panels": len(paned.panels), "nchunks": paned.nchunks,
                "bytes": pn_bytes,
                "aux_levels": max(len(q.launch_starts) - 1
                                  for q in paned.panels)})
    return {"paned": (pn_chain, reps_of(pn_copy, pn_bytes),
                      (rpn.route_paned_spmv, (paned, x_pn)), None)}


def route2_bench(torch, sp, gen, rec):
    """The resident ROUTE2 launches on chip_smoke.py's ROUTE_MAIN plans,
    as ``route2_case`` times them."""
    import dataclasses
    from spblas_tpu_torch.kernels import route2
    from spblas_tpu_torch.kernels import route2_kernel as r2k
    out = {}
    for name, m in (("uniform_300k", 300_000), ("uniform_1m", 1_000_000)):
        a = gen.generate_csr(m, m, 10 * m, seed=3)
        plan = route2.build_route2_plan(a.rowptr, a.colind, a.values,
                                        a.shape, a.nnz, device=a.device)
        x = gen.generate_vector(m, seed=62)
        x2 = r2k.pack_x2(plan, x)

        def copy(plan=plan, x2=x2):
            return dataclasses.replace(
                plan, tile=plan.tile.clone(), val=plan.val.clone(),
                slab_base=plan.slab_base.clone(),
                y_base=plan.y_base.clone(), src_flag=plan.src_flag.clone(),
                rho=plan.rho.clone() if plan.rotated else None), x2.clone()

        nbytes = (plan.nchunks * (8 * 1024 + 12 + 4 * plan.rotated)
                  + plan.x_rows * 512 + 2 * r2k.out_rows(plan) * 512)
        yb = plan.y_base.long()
        rec[name] = {"nchunks": plan.nchunks, "rotated": plan.rotated,
                     "launches": len(plan.launch_ranges()), "bytes": nbytes,
                     # atomics a call (vA slots) and chunks a y window
                     "published_slots": int(((plan.tile >> 24) & 1).sum()),
                     "windows": int(torch.unique(yb).numel()),
                     "same_window_as_next": float(
                         (yb[1:] == yb[:-1]).float().mean()),
                     "bound_ms": nbytes / 3.35e12 * 1e3,
                     "cusparse_ms": csr_ms(torch, a, x)}
        out[name] = (r2k.route2_spmv_padded, reps_of(copy, nbytes),
                     (r2k.route2_spmv, (plan, x)), within(
                         torch, lambda p=plan, xx=x2:
                         r2k.route2_spmv_reference(p, xx),
                         lambda p=plan, xx=x2: r2k.route2_spmv_reference(
                             dataclasses.replace(p, val=p.val.abs()),
                             xx.abs())))
        del a
    return out


def graph_ms(torch, fn, args, reps):
    """Device time of ``fn(*args)`` replayed from one CUDA graph: the
    launch sequence captured once, then enqueued as one graph, so the
    host's per-launch cost drops out and what is left is the device's
    (launch latency included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    ms = device_ms(torch, graph.replay, [()], reps)
    del graph
    return ms


def solve_bench(torch, sp, gen, rec):
    """The solve (``route2_solve_padded``) on the main path's plans of
    chip_smoke.py's ``TRSV_MAIN`` 20k factor and 1M chain, timed as
    ``route2_solve_case`` times them (4 right-hand sides, 8 solves);
    with ``--graph`` also replayed from a CUDA graph of one call.  On a
    tree whose solve is one persistent launch (``route2.build_solve_work``)
    the ``stretch_N`` levers rebuild the plan's work list with one-block
    stretches over launch ranges of at most N chunks (0: none)."""
    from spblas_tpu_torch.kernels import route2
    from spblas_tpu_torch.kernels import route2_kernel as r2k
    out = {}
    for name, a in (
            ("sptrsv_20k", gen.generate_triangular_csr(
                20_000, seed=0, lower=True, density=0.0005)),
            ("sptrsv_deep_1m", gen.generate_block_chain_lower(
                1_000_000, block=64, deg=4, seed=0))):
        info = sp.triangular_solve_inspect(a)
        plan = info.plan.route
        d = a.values[info.plan.route_diag.long()]
        m, rows = a.shape[0], r2k.solve_pane_rows(plan)

        def pane(i, plan=plan, d=d, m=m, rows=rows):
            y0 = gen.generate_vector(m, seed=300 + i) / d
            return (plan, torch.nn.functional.pad(
                y0.float(), (0, rows * 128 - m)).contiguous())

        panes = [pane(i) for i in range(4)]
        r = rec[name] = {"nchunks": plan.nchunks,
                         "launch_ranges": len(plan.launch_starts),
                         "levels": info.plan.num_levels}
        before = r2k.route2_solve_padded.launches
        ref = r2k.route2_solve_padded(*panes[0])
        r["launches"] = r2k.route2_solve_padded.launches - before
        if OPTS.get("graph"):
            r["graph_ms"] = graph_ms(torch, r2k.route2_solve_padded,
                                     panes[0], 8)
        out[name] = (r2k.route2_solve_padded, panes,
                     (r2k.route2_solve_padded, panes[0]), None, 8)
        if hasattr(route2, "build_solve_work"):
            r["stretch_default"] = route2.SOLVE_STRETCH_CHUNKS
            for n in (0, 1, 4, 16):
                if n == route2.SOLVE_STRETCH_CHUNKS:
                    continue
                lever = dataclasses.replace(
                    plan, solve_work=route2.build_solve_work(
                        plan.launch_starts, plan.nchunks, a.device,
                        stretch=n))
                ins = [(lever, p) for _, p in panes]
                y = r2k.route2_solve_padded(*ins[0])
                # the same plan and pane: every lever must agree with
                # the default within the solve's rounding
                r[f"stretch_{n}_ms"] = device_ms(
                    torch, r2k.route2_solve_padded, ins, 8)
                r[f"stretch_{n}_max_diff"] = float((y - ref).abs().max())
        del a
    return out


def _hub_stream(torch, n_ent, cap, hubs, a_len, b_len, seed):
    """chip_smoke.py's ``mul_hub_stream``: a slot-sorted stream whose hub
    slots hold many entries, A and B values on the card."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hub = np.concatenate([np.full(c, sl, np.int64) for sl, c in hubs])
    slots = np.sort(np.concatenate([hub, rng.integers(
        0, cap, n_ent - len(hub))]))
    sa = rng.integers(0, a_len - 1, n_ent)
    sb = rng.integers(0, b_len, n_ent)
    a = rng.standard_normal(a_len).astype(np.float32)
    a[-1] = 1.0
    b = rng.standard_normal(b_len).astype(np.float32)
    return (slots, sa, sb, torch.from_numpy(a).cuda(),
            torch.from_numpy(b).cuda())


def mul_paned_bench(torch, sp, gen, rec):
    """The paned SpGEMM fill on chip_smoke.py's 100k A.A main path
    (``SPGEMM_MAIN``, bench.py:254) and its paned hub fixture
    (``MUL_PANED_HUB``): on a tree without the slot fill the tile
    walker, one launch per launch range of each panel over the packed
    panes; on a tree with the slot fill (``kernels/mul_fill.py``) its
    one launch over the plan's expansion stream.  Each output is held to the plain tile
    walker, panel by panel, concatenated and padded to the capacity.
    Beside them: the whole ``multiply_fill`` (host included, no device
    sleep ahead) and cuSPARSE's SpGEMM with its symbolic pass."""
    from spblas_tpu_torch.kernels import route_mul_paned as rmp
    try:
        from spblas_tpu_torch.kernels import mul_fill as mf
    except ImportError:
        mf = None
    out = {}
    a = gen.generate_csr(100_000, 100_000, 1_000_000, seed=0)
    info = sp.multiply_compute(a, a)
    big = info.plan.route
    a_arr = torch.cat([2.0 * a.values, a.values.new_ones(1)])
    hub = _hub_stream(torch, 600_000, 262_144,
                      ((0, 20_000), (70_000, 30_000), (140_000, 8_000)),
                      20_001, 400_000, 102)
    hub_plan = rmp.build_route2_mul_paned_plan(
        *hub[:3], 20_001, 400_000, 262_144, device="cuda",
        panel_slots=65_536, pane_rows=512)
    for name, plan, aa, bb in (("spgemm_100k", big, a_arr, a.values),
                               ("hub_slots_paned", hub_plan, hub[3],
                                hub[4])):
        a2, b2 = rmp.pack_mul_panes(plan, aa, bb)

        def walker(pl, x2, y2, fn=rmp.route2_mul_paned_reference):
            parts = [fn(pl, p, x2, y2).view(-1)[:p.slots]
                     for p in pl.panels]
            return torch.nn.functional.pad(
                torch.cat(parts), (0, pl.capacity - sum(
                    p.slots for p in pl.panels)))

        tiles = sum(p.nchunks * (8 * 1024 + 20) for p in plan.panels)
        r = rec[name] = {"panels": len(plan.panels),
                         "nchunks": plan.nchunks, "capacity": plan.capacity,
                         "tile_bytes": tiles,
                         "tile_bound_ms": (tiles + (plan.a_rows
                                                    + plan.b_rows_pad) * 512
                                           + sum(2 * p.out_rows * 512
                                                 for p in plan.panels))
                         / 3.35e12 * 1e3}
        check = within(torch, lambda pl=plan, x2=a2, y2=b2:
                       walker(pl, x2, y2),
                       lambda pl=plan, x2=a2, y2=b2:
                       walker(pl, x2.abs(), y2.abs()))
        stream = getattr(plan, "expansion", None)
        if mf is not None and stream is not None:
            ent = stream.sa.numel()
            nbytes = (2 * ent + stream.run_start.numel() + plan.capacity
                      ) * 4 + (stream.a_len + stream.b_len) * 4
            r.update(entries=ent, slots=stream.run_start.numel() - 1,
                     bytes=nbytes, bound_ms=nbytes / 3.35e12 * 1e3)

            def copy(plan=plan, aa=aa, bb=bb):
                s = plan.expansion
                return (dataclasses.replace(
                    s, sa=s.sa.clone(), sb=s.sb.clone(),
                    run_start=s.run_start.clone()), aa.clone(),
                    bb.clone(), plan.capacity)

            out[name] = (mf.mul_fill, reps_of(copy, nbytes),
                         (rmp.route2_mul_paned, (plan, aa, bb)), check)
            if name == "hub_slots_paned":
                _hub_variants(mf, out, rec, name, *hub[:3], 20_001, 400_000,
                              aa, bb, plan.capacity, check,
                              (rmp.route2_mul_paned, (plan, aa, bb)))
        else:
            def copy(plan=plan, a2=a2, b2=b2):
                return dataclasses.replace(plan, panels=tuple(
                    dataclasses.replace(p, **{f: getattr(p, f).clone()
                                              for f in ("t1", "t2", "ab",
                                                        "bb", "yb", "fl",
                                                        "pane")})
                    for p in plan.panels)), a2.clone(), b2.clone()

            def chain(pl, x2, y2):
                return walker(pl, x2, y2, rmp.route2_mul_paned_padded)

            r["bytes"] = tiles
            out[name] = (chain, reps_of(copy, tiles),
                         (rmp.route2_mul_paned, (plan, aa, bb)), check)
    # the whole fill as the main path runs it, host included
    ops = [sp.scaled(2.0, dataclasses.replace(a, values=a.values * (
        1 + i / 64))) for i in range(8)]
    sp.multiply_fill(info, ops[0], a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(20):
        sp.multiply_fill(info, ops[i % len(ops)], a)
    e1.record()
    torch.cuda.synchronize()
    rec["spgemm_100k"]["multiply_fill_ms"] = e0.elapsed_time(e1) / 20
    csr = torch.sparse_csr_tensor(a.rowptr, a.colind[: a.nnz],
                                  a.values[: a.nnz], size=a.shape)
    rec["spgemm_100k"]["cusparse_spgemm_ms"] = device_ms(
        torch, torch.matmul, [(csr, csr)], 10)
    del a, info
    return out


def _stream_copy(stream):
    """A copy of a slot stream's index arrays (its hub tables shared: the
    chains run one fill after another)."""
    return dataclasses.replace(stream, sa=stream.sa.clone(),
                               sb=stream.sb.clone(),
                               run_start=stream.run_start.clone())


def _stream_bytes(stream, capacity):
    """The bytes the slot fill must move: the index stream, A and B once,
    c once."""
    return ((2 * stream.sa.numel() + stream.run_start.numel() + capacity)
            * 4 + (stream.a_len + stream.b_len) * 4)


def _hub_variants(mf, out, rec, name, slots, sa, sb, a_len, b_len, aa, bb,
                  capacity, check, apply):
    """On a tree whose slot streams carry the hub tier: the fill over the
    same stream cut into hub segments of other lengths, each a bench of
    its own (``<name>_seg<S>``), the per-call zeroing of the arrival
    counters that resetting them in the kernel saves, and two parts of
    the stream alone (out of bound: other functions): its hub runs
    (``<name>_hubs_only``) and the rest (``<name>_no_hubs``)."""
    import numpy as np
    if not hasattr(mf, "HUB_SEG_LEN"):
        return
    counts = np.bincount(slots)
    hub = counts[slots] > mf.HUB_MIN
    for part, sel in (("hubs_only", hub), ("no_hubs", ~hub)):
        st = mf.build_slot_stream(slots[sel], sa[sel], sb[sel], a_len,
                                  b_len, "cuda")
        nbytes = _stream_bytes(st, capacity)
        rec[f"{name}_{part}"] = {"entries": int(sel.sum()),
                                 "hub_segments": st.nseg,
                                 "bound_ms": nbytes / 3.35e12 * 1e3}
        out[f"{name}_{part}"] = (
            mf.mul_fill, reps_of(lambda st=st: (
                _stream_copy(st), aa.clone(), bb.clone(), capacity), nbytes),
            apply, None)
    kept = mf.HUB_SEG_LEN
    for seg in (512, 2048, 4096):
        mf.HUB_SEG_LEN = seg
        try:
            st = mf.build_slot_stream(slots, sa, sb, a_len, b_len, "cuda")
        finally:
            mf.HUB_SEG_LEN = kept
        nbytes = _stream_bytes(st, capacity)
        rec[f"{name}_seg{seg}"] = {"hub_segments": st.nseg}
        out[f"{name}_seg{seg}"] = (
            mf.mul_fill, reps_of(lambda st=st: (
                _stream_copy(st), aa.clone(), bb.clone(), capacity), nbytes),
            apply, check)
    st = mf.build_slot_stream(slots, sa, sb, a_len, b_len, "cuda")
    rec[f"{name}_counter_zeroing"] = {"hubs": int(st.hub_count.numel())}
    out[f"{name}_counter_zeroing"] = (
        lambda t: t.zero_(), [(st.hub_count.clone(),) for _ in range(8)],
        apply, None)


def mul_bench(torch, sp, gen, rec):
    """The resident SpGEMM numeric ``route2_mul`` on chip_smoke.py's 2k
    A.A main path (``SPGEMM_MAIN``, bench.py:190) and its resident hub
    fixture (``MUL_HUB``), as the tree runs it: the tile kernel's
    launches (one a launch range, the out pane zeroed) over the packed
    panes, or the slot fill's one launch over the plan's expansion
    stream; each output held to the plain tile walker.  On a tree with
    the hub tier, the hub fixture also with other segment lengths.
    Beside them the whole ``multiply_fill`` on the 2k plan (host
    included)."""
    import numpy as np
    from spblas_tpu_torch.kernels import mul_fill as mf
    from spblas_tpu_torch.kernels import route2 as r2
    from spblas_tpu_torch.kernels import route2_kernel as r2k
    cs = _smoke()
    name, make, _, _ = cs.SPGEMM_MAIN[0]
    a = make()
    info = sp.multiply_compute(a, a)
    n_ent, cap, hubs, a_len, b_len, seed = cs.MUL_HUB
    rng = np.random.default_rng(seed)
    hub = np.concatenate([np.full(c, sl, np.int64) for sl, c in hubs])
    slots = np.sort(np.concatenate([hub, rng.integers(
        0, cap, n_ent - len(hub))]))
    sa = rng.integers(0, a_len - 1, n_ent)
    sb = rng.integers(0, b_len, n_ent)
    av = torch.from_numpy(rng.standard_normal(a_len).astype(np.float32))
    av[-1] = 1.0
    bv = torch.from_numpy(rng.standard_normal(b_len).astype(np.float32))
    hplan = r2.build_route2_mul_plan(slots, sa, sb, a_len, b_len, cap,
                                     device="cuda")
    out = {}
    for nm, pl, aa, bb in ((name, info.plan.route, torch.cat([
            2.0 * a.values, a.values.new_ones(1)]), a.values),
            ("hub_slots_aux", hplan, av.cuda(), bv.cuda())):
        a2, b2 = r2k.pack_mul_panes(pl, aa, bb)
        cap_ = pl.capacity
        check = within(
            torch, lambda pl=pl, a2=a2, b2=b2: r2k.route2_mul_reference(
                pl, a2, b2).view(-1)[:pl.capacity],
            lambda pl=pl, a2=a2, b2=b2: r2k.route2_mul_reference(
                pl, a2.abs(), b2.abs()).view(-1)[:pl.capacity])
        apply = (r2k.route2_mul, (pl, aa, bb))
        ex = getattr(pl, "expansion", None)
        tiles = (pl.nchunks * (8 * 1024 + 12) + (pl.a_rows + pl.b_rows)
                 * 512 + 2 * r2k.mul_out_rows(pl) * 512)
        r = rec[nm] = {"nchunks": pl.nchunks, "capacity": cap_,
                       "aux_levels": len(pl.launch_starts) - 1,
                       "tile_bound_ms": tiles / 3.35e12 * 1e3,
                       "stream": ex is not None}
        if ex is not None:
            nbytes = _stream_bytes(ex, cap_)
            r.update(entries=int(ex.sa.numel()), slots=ex.nslots,
                     longest=ex.longest,
                     hub_segments=getattr(ex, "nseg", 0), bytes=nbytes,
                     bound_ms=nbytes / 3.35e12 * 1e3)
            out[nm] = (mf.mul_fill, reps_of(lambda ex=ex, aa=aa, bb=bb: (
                _stream_copy(ex), aa.clone(), bb.clone(), cap_), nbytes),
                apply, check)
            if nm == "hub_slots_aux":
                _hub_variants(mf, out, rec, nm, slots, sa, sb, a_len, b_len,
                              aa, bb, cap_, check, apply)
        else:
            def copy(pl=pl, a2=a2, b2=b2):
                return (dataclasses.replace(pl, **{
                    f: getattr(pl, f).clone() for f in (
                        "tile1", "tile2", "a_base", "b_base", "y_base")}),
                        a2.clone(), b2.clone())

            r["bytes"] = tiles
            out[nm] = (r2k.route2_mul_padded, reps_of(copy, tiles), apply,
                       lambda y, check=check, cap_=cap_: check(
                           y.view(-1)[:cap_]))
    ops = [sp.scaled(2.0, dataclasses.replace(a, values=a.values * (
        1 + i / 64))) for i in range(8)]
    sp.multiply_fill(info, ops[0], a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(20):
        sp.multiply_fill(info, ops[i % len(ops)], a)
    e1.record()
    torch.cuda.synchronize()
    rec[name]["multiply_fill_ms"] = e0.elapsed_time(e1) / 20
    return out


def dia_bench(torch, sp, gen, rec):
    """The DIA kernel on chip_smoke.py's three DIA main paths
    (``DIA_MAIN``: the 1000^2 stencil, the 800^2 FEM mesh, the 64^3
    stencil) and its kernel-only shapes (``DIA_KERNEL_ONLY``: a wide
    rectangle, the 2000^2 stencil): ``pad_<m>`` the padded kernel over x
    in the TPU kernel's padded pane, ``inplace_<m>`` (on a tree that has
    it) the kernel that reads x in place, ``fused_<m>`` the gated path
    as the tree runs it (with its pad of x, or without), each held to
    the plain version; beside them cuSPARSE's ``torch.mv``."""
    from spblas_tpu_torch.kernels import dia
    cs = _smoke()
    out = {}
    for i, (nm, make) in enumerate(cs.DIA_MAIN + cs.DIA_KERNEL_ONLY):
        a = make()
        plan = dia.build_dia_plan(a)
        plan.offsets_tensor
        m = a.shape[0]
        x = gen.generate_vector(a.shape[1], seed=21 + i)
        x2, lo = dia.pad_x(plan, x)
        span = max(plan.offsets) - min(plan.offsets)
        nbytes = plan.ndiag * m * 4 + min(m + span, a.shape[1]) * 4 + m * 4
        rec[nm] = {"m": m, "n": a.shape[1], "ndiag": plan.ndiag,
                   "bytes": nbytes, "bound_ms": nbytes / 3.35e12 * 1e3,
                   "cusparse_ms": csr_ms(torch, a, x)}
        ref = within(torch, lambda plan=plan, x2=x2, lo=lo, m=m:
                     dia.dia_spmv_reference(plan.diags, plan.offsets, x2,
                                            lo)[:m],
                     lambda plan=plan, x2=x2, lo=lo, m=m:
                     dia.dia_spmv_reference(plan.diags.abs(), plan.offsets,
                                            x2.abs(), lo)[:m])

        def copy(plan=plan, x2=x2, x=x):
            p = dataclasses.replace(plan, diags=plan.diags.clone())
            p.offsets_tensor
            if hasattr(p, "offsets_host"):
                p.offsets_host
            return p, x2.clone(), x.clone()

        ins = reps_of(copy, plan.diags.numel() * 4)
        apply = (dia.dia_spmv_fused, (plan, x))
        out[f"pad_{nm}"] = (lambda p, xx, xi, lo=lo: dia.dia_spmv_padded(
            p, xx, lo), ins, apply,
            lambda y, ref=ref, m=m: ref(y[:m]))
        if hasattr(dia, "dia_spmv_inplace"):
            out[f"inplace_{nm}"] = (lambda p, xx, xi: dia.dia_spmv_inplace(
                p, xi), ins, apply, ref)
        out[f"fused_{nm}"] = (lambda p, xx, xi: dia.dia_spmv_fused(p, xi),
                              ins, apply, ref)
        del a
    return out


def band_bench(torch, sp, gen, rec):
    """One band SpMV on the headline plan in f32 and bf16, and ten power
    iterations on the f32 one (chip_smoke.py's band_case, power_phase)."""
    from spblas_tpu_torch.kernels import banded
    m, iters = 409_600, 10
    a = gen.generate_banded_csr(m, m, 100, seed=0)
    x = gen.generate_vector(m, seed=1)
    out = {}
    for name, dt in (("band_f32", None), ("band_bf16", torch.bfloat16)):
        plan = banded.build_band_plan(a, dtype=dt)
        xp = banded.pad_x(plan, x)
        nbytes = (plan.panels.numel() * plan.panels.element_size()
                  + xp.numel() * 4 + plan.panels.shape[0] * 4)
        rec[name] = {"width": plan.width, "bytes": nbytes,
                     "bound_ms": nbytes / 3.35e12 * 1e3}
        out[name] = (banded.band_spmv_padded, reps_of(
            lambda p=plan, xx=xp: (p.panels.clone(), xx.clone()), nbytes),
            (banded.band_spmv, (plan, x)), within(
                torch, lambda p=plan, xx=xp:
                banded.band_spmv_reference(p.panels, xx),
                lambda p=plan, xx=xp:
                banded.band_spmv_reference(p.panels.abs(), xx.abs())))
        if dt is None:
            h = plan.pad_l
            rec["power_f32"] = {"iters": iters,
                                "bound_ms": iters * nbytes / 3.35e12 * 1e3}
            out["power_f32"] = (banded.band_power_padded, reps_of(
                lambda p=plan, xx=xp: (p.panels.clone(), xx.clone(), iters,
                                       h), nbytes),
                (banded.band_power_iterations, (plan, x, iters)), within(
                    torch, lambda p=plan, xx=xp: banded.band_power_reference(
                        p.panels, xx, iters, h),
                    lambda p=plan, xx=xp: iters * banded.band_power_reference(
                        p.panels.abs(), xx.abs(), iters, h)))
    rec["cusparse_ms"] = csr_ms(torch, a, x)
    del a
    return out


# data-sheet peaks of the H100 SXM: memory, f32 outside the tensor
# cores, dense TF32 on them, f64 on them
_HBM, _F32, _TF32, _F64TC = 3.35e12, 67e12, 494.7e12, 67e12


def spmm_bounds(nbytes, flops):
    """The FMA bound (bytes or f32 operations) and the tensor-core bound
    (bytes or the three TF32 products of a full-f32 product), in ms."""
    t_bytes = nbytes / _HBM * 1e3
    return {"bytes": nbytes, "flops": flops,
            "fma_bound_ms": max(t_bytes, flops / _F32 * 1e3),
            "tc_bound_ms": max(t_bytes, 3 * flops / _TF32 * 1e3)}


def dense_b(torch, n, k, seed, count=1):
    """chip_smoke.py's ``dense_operands``: seeded U[0, 100) on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.rand(n, k, generator=g, device="cuda") * 100
            for _ in range(count)]


def cusparse_mm_ms(torch, a, b):
    """cuSPARSE SpMM (``torch.matmul`` on the sparse CSR ``a``), over
    distinct copies of the values and B."""
    def make():
        return (torch.sparse_csr_tensor(a.rowptr, a.colind[: a.nnz].clone(),
                                        a.values[: a.nnz].clone(),
                                        size=a.shape), b.clone())
    return device_ms(torch, torch.matmul, reps_of(
        make, a.nnz * 8 + b.numel() * 4))


def multiply_ms(torch, sp, opt, bs, reps=20, mm=False):
    """The whole ``multiply(scaled(2.0, opt), B)``, host included, over
    the distinct ``bs`` (chip_smoke.py's ``main_path_spmm`` timing);
    ``mm``: each of ``bs`` is an operand pair for ``multiply``."""
    def call(i):
        if mm:
            return sp.multiply(*bs[i % len(bs)])
        return sp.multiply(sp.scaled(2.0, opt), bs[i % len(bs)])

    call(0)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(reps):
        call(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _sha1(torch, y):
    """A hash of a result's bits, to compare two trees' outputs."""
    import hashlib
    if y.is_complex():
        y = torch.view_as_real(y)
    return hashlib.sha1(y.detach().contiguous().view(torch.uint8).cpu()
                        .numpy().tobytes()).hexdigest()


def band_mm_bench(torch, sp, gen, rec):
    """``band_spmm_stream_padded`` on the headline plan at k 256 with f32
    and bf16 panels (chip_smoke.py's ``band_spmm_case``, seed 85), the
    main path's ``multiply`` on the headline band at k 256 (it streams B)
    and cuSPARSE's SpMM on the same CSR."""
    from spblas_tpu_torch.kernels import banded
    m, k = 409_600, 256
    a = gen.generate_banded_csr(m, m, 100, seed=0)
    b = dense_b(torch, m, k, 85)[0]
    out = {}
    for name, dt in (("band_stream_f32", None),
                     ("band_stream_bf16", torch.bfloat16)):
        plan = banded.build_band_plan(a, dtype=dt)
        bp = banded.pad_b(plan, b)
        rows, w = plan.panels.shape
        nbytes = (plan.panels.numel() * plan.panels.element_size()
                  + bp.numel() * 4 + rows * k * 4)
        rec[name] = dict(spmm_bounds(nbytes, 2 * rows * w * k), width=w,
                         k=k, sha1=_sha1(torch, banded.band_spmm_stream_padded(
                             plan.panels, bp)))
        out[name] = (banded.band_spmm_stream_padded, reps_of(
            lambda p=plan, bb=bp: (p.panels.clone(), bb.clone()), nbytes),
            (banded.band_spmm_stream, (plan, b)), within(
                torch, lambda p=plan, bb=bp:
                banded.band_spmm_reference(p.panels, bb),
                lambda p=plan, bb=bp:
                banded.band_spmm_reference(p.panels.abs(), bb.abs())))
    # chip_smoke.py's bf16 kernel case: odd_h_tall_bf16 at k 64 (seed 97)
    tall = banded.build_band_plan(gen.generate_banded_csr(
        60_001, 50_000, 66, seed=13), dtype=torch.bfloat16)
    bt = dense_b(torch, 50_000, 64, 97)[0]
    rec["band_stream_bf16_k64"] = {"sha1": _sha1(
        torch, banded.band_spmm_stream_padded(tall.panels,
                                              banded.pad_b(tall, bt)))}
    rec["cusparse_ms"] = cusparse_mm_ms(torch, a, b)
    opt = sp.matrix_opt(a)
    bs = dense_b(torch, m, k, 86, 4)
    rec["multiply_ms"] = multiply_ms(torch, sp, opt, bs)
    rec["multiply_kind"] = (opt._plans.get("matmul")
                            or opt._plans["matvec"])[0]
    del a, opt, bs, tall, bt
    return out


# the resident band SpMM's cells (chip_smoke.py's band_spmm_case shapes):
# (name, m, n, bandwidth, bf16 panels, seed, k); the headline band at
# k 64 has the permuted band's shape (409,600 rows, W 232)
_RES = (("res_head_k64", 409_600, 409_600, 100, False, 0, 64),
        ("res_head_k256", 409_600, 409_600, 100, False, 0, 256),
        ("res_odd_k33", 100_037, 120_000, 15, False, 11, 33),
        ("res_bf16_k64", 60_001, 50_000, 66, True, 13, 64))


def band_res_bench(torch, sp, gen, rec):
    """The resident band SpMM (``band_spmm_padded`` over a padded B, as
    every tree has it) on ``_RES``, each with a hash of its output's
    bits; on trees with the in-place forms also one launch over a random
    row index on the headline band at k 64 (``res_perm_k64``, a harder
    gather than RCM's), and the complex pass (``band_spmm_cx``) on
    odd_h_wide's structure in complex64 at k 32 (chip_smoke.py's
    ``CX_BAND_MAIN``), complex and real B."""
    import numpy as np
    from spblas_tpu_torch.kernels import banded, plans
    out, made = {}, {}
    for name, m, n, bw, bf16, seed, k in _RES:
        if (m, bf16) not in made:
            made[m, bf16] = banded.build_band_plan(
                gen.generate_banded_csr(m, n, bw, seed=seed),
                dtype=torch.bfloat16 if bf16 else None)
        plan = made[m, bf16]
        b = dense_b(torch, n, k, 85)[0]
        bp = banded.pad_b(plan, b)
        rows, w = plan.panels.shape
        nbytes = (plan.panels.numel() * plan.panels.element_size()
                  + bp.numel() * 4 + rows * k * 4)
        rec[name] = dict(spmm_bounds(nbytes, 2 * rows * w * k), width=w,
                         k=k, sha1=_sha1(torch, banded.band_spmm_padded(
                             plan.panels, bp)))
        out[name] = (banded.band_spmm_padded, reps_of(
            lambda p=plan, bb=bp: (p.panels.clone(), bb.clone()), nbytes),
            (banded.band_spmm, (plan, b)), within(
                torch, lambda p=plan, bb=bp:
                banded.band_spmm_reference(p.panels, bb),
                lambda p=plan, bb=bp:
                banded.band_spmm_reference(p.panels.abs(), bb.abs())))
    if not hasattr(banded, "band_spmm_inplace"):
        return out
    plan, m, k = made[409_600, False], 409_600, 64
    rows, w = plan.panels.shape
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    perm = torch.randperm(rows, generator=g, device="cuda").to(torch.int32)
    b = dense_b(torch, m, k, 85)[0]

    def fused(p, bb):
        return banded.band_spmm_inplace(p, bb, plan.pad_l, m, perm=perm)

    nbytes = plan.panels.numel() * 4 + 2 * m * k * 4 + rows * 4
    rec["res_perm_k64"] = dict(spmm_bounds(nbytes, 2 * rows * w * k),
                               width=w, k=k)
    out["res_perm_k64"] = (fused, reps_of(
        lambda: (plan.panels.clone(), b.clone()), nbytes),
        (fused, (plan.panels, b)), within(
            torch, lambda: banded.band_spmm_inplace_reference(
                plan.panels, b, plan.pad_l, m, perm),
            lambda: banded.band_spmm_inplace_reference(
                plan.panels.abs(), b.abs(), plan.pad_l, m, perm)))
    ca = gen.generate_banded_csr(100_037, 120_000, 15, seed=11,
                                 dtype=np.complex64)
    pr, pi = plans._build_band_cx(ca)
    mc, kc = 100_037, 32
    rows, w = pr.panels.shape
    mod = torch.sqrt(pr.panels ** 2 + pi.panels ** 2)
    g.manual_seed(98)
    bc = torch.complex(torch.rand(120_000, kc, generator=g, device="cuda"),
                       torch.rand(120_000, kc, generator=g, device="cuda"))
    for name, bb in (("cx_k32", bc), ("cx_k32_real_b", bc.real.contiguous())):
        def one(p0, p1, b2):
            return banded.band_spmm_cx(p0, p1, b2, pr.pad_l, mc)

        nbytes = 2 * rows * w * 4 + bb.numel() * bb.element_size() \
            + mc * kc * 8
        flops = (8 if bb.is_complex() else 4) * rows * w * kc
        rec[name] = dict(spmm_bounds(nbytes, flops), width=w, k=kc)
        out[name] = (one, reps_of(lambda bb=bb: (
            pr.panels.clone(), pi.panels.clone(), bb.clone()), nbytes),
            (plans.band_cx_spmm, ((pr, pi), bb)), within_cx(
                torch, lambda bb=bb: banded.band_spmm_cx_reference(
                    pr.panels, pi.panels, bb, pr.pad_l, mc),
                lambda bb=bb: banded.band_spmm_inplace_reference(
                    mod, bb.abs(), pr.pad_l, mc)))
    return out


def bsr_mm_bench(torch, sp, gen, rec):
    """``bsr_spmm_blocks`` on the BSR that the chooser builds for
    chip_smoke.py's block cell (``BSR_MAIN``, ``block_csr``) at k 256,
    the main path's ``multiply`` on it and cuSPARSE's SpMM on its CSR."""
    from spblas_tpu_torch.kernels import bsr_kernels as bk
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    _, bargs, k = cs.BSR_MAIN
    ba = cs.block_csr(*bargs)
    opt = sp.matrix_opt(ba)
    bs = dense_b(torch, ba.shape[1], k, 89, 4)
    t0 = time.perf_counter()
    sp.multiply(sp.scaled(2.0, opt), bs[0])
    torch.cuda.synchronize()
    rec["first_call_s"] = time.perf_counter() - t0
    kind, plan = opt._plans.get("matmul") or opt._plans["matvec"]
    assert kind == "bsr", kind
    a = plan[0]
    v, rp, ci = a.values, a.block_rowptr, a.block_colind
    bh, bw = a.block_shape
    nnzb, mb = a.nnz_blocks, rp.numel() - 1
    b = dense_b(torch, a.shape[1], k, 88)[0]
    nbytes = ((mb + 1) * 4 + nnzb * 4 + nnzb * bh * bw * 4 + b.numel() * 4
              + mb * bh * k * 4)
    rec["bsr_f32"] = dict(spmm_bounds(nbytes, 2 * nnzb * bh * bw * k),
                          block=[bh, bw], nnz_blocks=nnzb, k=k)
    rec["cusparse_ms"] = cusparse_mm_ms(torch, ba, b)
    rec["multiply_ms"] = multiply_ms(torch, sp, opt, bs)
    del ba, opt, bs
    fn = bk.bsr_spmm_blocks
    if "column_order" in inspect.signature(fn).parameters:
        # the column list the main path keeps on its BSR
        fn = functools.partial(fn, column_order=a.column_order)
    return {"bsr_f32": (fn, reps_of(
        lambda: (v.clone(), rp.clone(), ci.clone(), b.clone()), nbytes),
        (bk.bsr_spmm, (a, b)), within(
            torch, lambda: bk.bsr_spmm_reference(v, rp, ci, b),
            lambda: bk.bsr_spmm_reference(v.abs(), rp, ci, b.abs())))}


def within_cx(torch, ref, absref, factor=64):
    """``within`` for a complex pane: |y - ref| per slot within
    factor * eps * absref."""
    cache = {}

    def check(y):
        if not cache:
            cache["ref"] = ref().to(torch.complex128)
            cache["abs"] = absref().double()
        lim = factor * torch.finfo(torch.float32).eps * cache["abs"]
        return bool(((y.to(torch.complex128) - cache["ref"]).abs()
                     <= lim).all())

    return check


# route_cx cells: chip_smoke.py's CX_MAIN (100k) and CX_ONLY (300k, past
# SLAB_MIN_CHUNKS), complex64, degree 10: (name, rows, seed)
_CX = (("uniform_100k_c64", 100_000, 5), ("uniform_300k_c64", 300_000, 3))


def cx_bench(torch, sp, gen, rec):
    """``route_cx`` over a ROUTE2 plan, as chip_smoke.py's
    ``route_cx_case`` times it: the complex kernel's launches (trees that
    have it, ``*_cx``) and the four real applies it replaced (every tree,
    ``*_four``), each held to its plain version; beside them cuSPARSE's
    complex ``torch.mv`` and, on the 100k cell, the whole
    ``multiply(scaled(2.0, matrix_opt(A)), x)``."""
    from spblas_tpu_torch.kernels import plans
    from spblas_tpu_torch.kernels import route2_kernel as r2k
    out = {}

    def cell(name, m, seed):   # a scope a cell: the checks run later
        a = gen.generate_csr(m, m, 10 * m, seed=seed, complex_=True)
        p = plans._try_route_cx(a)[1]
        kind, pr, pi = p[:3]
        assert kind == "route", kind
        vi = torch.where(pr.val_src >= 0, pi.val, torch.zeros_like(pi.val))
        x = gen.generate_vector(m, seed=57, complex_=True)
        xs = [r2k.pack_x2(pr, x.real.float()),
              r2k.pack_x2(pr, x.imag.float())]
        absref = functools.partial(
            r2k.route2_spmv_reference, dataclasses.replace(
                pr, val=torch.sqrt(pr.val ** 2 + vi ** 2)),
            r2k.pack_x2(pr, x.abs()))

        def four(qr, qi, xr, xi, fn=r2k.route2_spmv_padded):
            return torch.complex(fn(qr, xr) - fn(qi, xi),
                                 fn(qr, xi) + fn(qi, xr))

        nch, rows = pr.nchunks, r2k.out_rows(pr)
        one = (nch * (8 * 1024 + 12 + 4 * pr.rotated) + pr.x_rows * 512
               + 2 * rows * 512)
        cx_bytes = (nch * (12 * 1024 + 12 + 4 * pr.rotated)
                    + pr.x_rows * 1024 + 2 * rows * 1024)
        rec[name] = {"nchunks": nch, "launch_ranges":
                     len(pr.launch_ranges()), "rotated": pr.rotated,
                     "four_bytes": 4 * one, "cx_bytes": cx_bytes,
                     "four_bound_ms": 4 * one / _HBM * 1e3,
                     "cx_bound_ms": cx_bytes / _HBM * 1e3,
                     "cusparse_ms": csr_ms(torch, a, x)}
        out[f"{name}_four"] = (four, reps_of(lambda: (
            dataclasses.replace(pr, val=pr.val.clone()),
            dataclasses.replace(pi, val=pi.val.clone()),
            xs[0].clone(), xs[1].clone()), 4 * one),
            (plans.route_cx_spmv, (p, x)), within_cx(
                torch, lambda: four(pr, pi, *xs,
                                    fn=r2k.route2_spmv_reference),
                absref, factor=128))
        if hasattr(r2k, "route2_cx_spmv_padded"):
            x2 = r2k.pack_x2(pr, x)
            out[f"{name}_cx"] = (r2k.route2_cx_spmv_padded, reps_of(
                lambda: (dataclasses.replace(pr, val=pr.val.clone()),
                         p[3].clone(), x2.clone()), cx_bytes),
                (plans.route_cx_spmv, (p, x)), within_cx(
                    torch, lambda: r2k.route2_cx_spmv_reference(
                        pr, p[3], x2), absref))
        if m == _CX[0][1]:
            opt = sp.matrix_opt(a)
            xv = [gen.generate_vector(m, seed=53 + i, complex_=True)
                  for i in range(4)]
            rec[name]["multiply_ms"] = multiply_ms(torch, sp, opt, xv)

    for c in _CX:
        cell(*c)
    return out


def spgemm_bench(torch, sp, gen, rec):
    """``bsr_spgemm_blocks`` on chip_smoke.py's block products
    (``BSR_SPGEMM_MAIN``: 32,768^2 of 128x128 blocks; the kernel-only
    ``BSR_SPGEMM_ONLY``: (8, 128).(128, 128), 16-row C blocks, odd
    depths and widths; each in f32 and f64), as
    ``bsr_spgemm_case`` times them, each held to its plain version;
    bounds on the tensor cores (three TF32 products; the FP64 ones) and
    the whole f32 ``multiply(scaled(2.0, A), B)``."""
    from spblas_tpu_torch.kernels import bsr_spgemm as bsg
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    out = {}

    def case(tag, a, b, plan, dt):   # a scope a case: the checks run later
        args = (plan.pair_ptr, plan.pair_a, plan.pair_b)
        bh, bk = a.block_shape
        bw = b.block_shape[1]
        av = a.values.to(dt).contiguous()
        bv = b.values.to(dt).contiguous()
        esz = av.element_size()
        nbytes = ((a.nnz_blocks * bh * bk + b.nnz_blocks * bk * bw
                   + plan.nnzb_c * bh * bw) * esz + plan.npairs * 8
                  + (plan.nnzb_c + 1) * 4)
        flops = 2 * plan.npairs * bh * bk * bw
        t_bytes = nbytes / _HBM * 1e3
        name = f"{tag}_{str(dt).split('.')[-1]}"
        rec[name] = {"pairs": plan.npairs, "nnzb_c": plan.nnzb_c,
                     "blocks": [bh, bk, bw], "bytes": nbytes,
                     "flops": flops,
                     "tc_bound_ms": max(t_bytes, (
                         3 * flops / _TF32 if dt == torch.float32
                         else flops / _F64TC) * 1e3)}
        out[name] = (bsg.bsr_spgemm_blocks, reps_of(
            lambda: args + (av.clone(), bv.clone()), nbytes),
            (bsg.bsr_spgemm_blocks, args + (av, bv)), within(
                torch, lambda: bsg.bsr_spgemm_reference(*args, av, bv),
                lambda: bsg.bsr_spgemm_reference(*args, av.abs(),
                                                 bv.abs())), 10)

    for tag, (_, sa, sb) in (
            ("main", cs.BSR_SPGEMM_MAIN),
            *((f"only{i}" if i else "only", c)
              for i, c in enumerate(cs.BSR_SPGEMM_ONLY))):
        a, b = cs.random_bsr(*sa), cs.random_bsr(*sb)
        plan = bsg.bsr_spgemm_compute(a, b)
        for dt in (torch.float32, torch.float64):
            case(tag, a, b, plan, dt)
        if tag == "main":
            ops = [sp.scaled(2.0, dataclasses.replace(a, values=a.values
                                                      * s))
                   for s in (1.0, -0.5, 0.25, 2.0)]
            rec["multiply_ms"] = multiply_ms(
                torch, sp, None, [(o, b) for o in ops], mm=True)
    return out


def _smoke():
    """chip_smoke.py of this script's own tree, for its matrix builders
    (the tree under test may predate them); imported after the tree's
    package, which the builders then use."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_builders",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bsr_mv_bench(torch, sp, gen, rec):
    """``bsr_spmv_blocks`` on the BSR that the chooser builds for
    chip_smoke.py's block cell (``BSR_MAIN``: 131,072^2, 8x128 blocks),
    its kernel-only 8x8 shape (``BSR_ONLY``) and the 3x3 blocks of the
    27-point 64^3 node grid (``FEM_BSR``, f32 and f64), each held to its
    plain version; beside them the main path's ``multiply`` on the block
    cell (host included) and cuSPARSE's ``torch.mv`` on each CSR; bound:
    each input once over 3.35 TB/s."""
    from spblas_tpu_torch.formats.convert import bsr_to_csr
    from spblas_tpu_torch.kernels import bsr_kernels as bk
    cs = _smoke()
    _, bargs, _ = cs.BSR_MAIN
    ba = cs.block_csr(*bargs)
    opt = sp.matrix_opt(ba)
    xs = [gen.generate_vector(ba.shape[1], seed=87 + i) for i in range(4)]
    rec["multiply_ms"] = multiply_ms(torch, sp, opt, xs)
    kind, plan = opt._plans["matvec"]
    assert kind == "bsr", kind
    cases = [("bsr_131072_8x128", plan[0], ba)]
    name, mb, nbc, per_row, block, every, _, seed = cs.BSR_ONLY[1]
    small = cs.random_bsr(mb, nbc, per_row, block, every, seed)
    cases.append((name, small, bsr_to_csr(small)))
    fname, side, fseed = cs.FEM_BSR
    for dt in (torch.float32, torch.float64):
        fem = cs.fem_bsr(side, dt, fseed)
        cases.append((f"{fname}_{str(dt)[6:]}", fem, bsr_to_csr(fem)))
    out = {}
    for name, a, csr in cases:
        v, rp, ci = a.values, a.block_rowptr, a.block_colind
        bh, bw = a.block_shape
        nnzb, mb = a.nnz_blocks, rp.numel() - 1
        isz = v.element_size()
        x = gen.generate_vector(a.shape[1], seed=88).to(v.dtype)
        nbytes = ((mb + 1) * 4 + nnzb * 4
                  + (nnzb * bh * bw + x.numel() + mb * bh) * isz)
        rec[name] = {"block": [bh, bw], "dtype": str(v.dtype)[6:],
                     "nnz_blocks": nnzb, "bytes": nbytes,
                     "bound_ms": nbytes / 3.35e12 * 1e3,
                     "cusparse_ms": csr_ms(torch, csr, x)}
        out[name] = (bk.bsr_spmv_blocks, reps_of(
            lambda v=v, rp=rp, ci=ci, x=x: (v.clone(), rp.clone(),
                                            ci.clone(), x.clone()), nbytes),
            (bk.bsr_spmv, (a, x)), within(
                torch, lambda v=v, rp=rp, ci=ci, x=x:
                bk.bsr_spmv_reference(v, rp, ci, x),
                lambda v=v, rp=rp, ci=ci, x=x:
                bk.bsr_spmv_reference(v.abs(), rp, ci, x.abs())))
    del ba, opt, xs
    return out


def v1_mul_bench(torch, sp, gen, rec):
    """The ROUTE v1 SpGEMM numeric ``route_mul`` as the tree runs it (the
    tile kernel ``route_mul.cu`` after padding both panes and zeroing an
    out pane, or the slot fill's one launch over the plan's expansion
    stream) on chip_smoke.py's 2k A.A v1 plan (``V1_MAIN``, bench.py:190
    under SPBLAS_ROUTE_SPGEMM=1) and its dup-40 stream (``V1_OVERLAP``),
    each held to the plain tile walker; beside them the whole
    ``multiply_fill`` on the 2k plan (host included)."""
    import numpy as np
    from spblas_tpu_torch.kernels import route_mul as rml
    from spblas_tpu_torch.kernels import route_mul_kernel as rmk
    cs = _smoke()
    name, make, _ = cs.V1_MAIN
    a = make()
    os.environ["SPBLAS_ROUTE_SPGEMM"] = "1"
    try:
        info = sp.multiply_compute(a, a)
    finally:
        del os.environ["SPBLAS_ROUTE_SPGEMM"]
    oname, (n_slots, dup, a_len, b_len, seed) = cs.V1_OVERLAP
    rng = np.random.default_rng(seed)
    slots = np.repeat(np.arange(n_slots), rng.poisson(dup, n_slots) + 1)
    sa = rng.integers(0, a_len, len(slots))
    sb = rng.integers(0, b_len, len(slots))
    dplan = rml.build_route_mul_plan(slots, sa, sb, a_len, b_len, n_slots,
                                     device="cuda")
    av = torch.from_numpy(rng.standard_normal(a_len).astype(np.float32))
    bv = torch.from_numpy(rng.standard_normal(b_len).astype(np.float32))
    out = {}
    for nm, pl, aa, bb in ((name, info.plan.route, torch.cat([
            2.0 * a.values, a.values.new_ones(1)]), a.values),
            (oname, dplan, av.cuda(), bv.cuda())):
        cap = pl.capacity
        ex = getattr(pl, "expansion", None)
        if ex is not None:
            nbytes = ((2 * ex.sa.numel() + ex.nslots + 1 + cap) * 4
                      + (ex.a_len + ex.b_len) * 4)

            def copy(pl=pl, ex=ex, aa=aa, bb=bb):
                return (dataclasses.replace(pl, expansion=dataclasses.replace(
                    ex, sa=ex.sa.clone(), sb=ex.sb.clone(),
                    run_start=ex.run_start.clone())), aa.clone(), bb.clone())
        else:
            nbytes = (pl.nchunks * (12 * 1024 + 12)
                      + (pl.a_rows + pl.b_rows) * 512 + 2 * pl.out_rows * 512)

            def copy(pl=pl, aa=aa, bb=bb):
                return (dataclasses.replace(pl, **{
                    f: getattr(pl, f).clone() for f in (
                        "tile1", "tile2", "tile3", "a_base", "b_base",
                        "o_base")}), aa.clone(), bb.clone())
        rec[nm] = {"nchunks": pl.nchunks, "capacity": cap, "bytes": nbytes,
                   "bound_ms": nbytes / 3.35e12 * 1e3,
                   "stream": ex is not None}

        def walk(pl=pl, aa=aa, bb=bb, f=abs):
            a2 = rmk.pad_pane(f(aa), pl.a_rows)
            b2 = rmk.pad_pane(f(bb), pl.b_rows)
            return rmk.route_mul_reference(pl, a2, b2).view(-1)[:pl.capacity]

        out[nm] = (rmk.route_mul, reps_of(copy, nbytes),
                   (rmk.route_mul, (pl, aa, bb)),
                   within(torch, lambda walk=walk: walk(f=lambda t: t),
                          walk))
    ops = [sp.scaled(2.0, dataclasses.replace(a, values=a.values * (
        1 + i / 64))) for i in range(8)]
    sp.multiply_fill(info, ops[0], a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(20):
        sp.multiply_fill(info, ops[i % len(ops)], a)
    e1.record()
    torch.cuda.synchronize()
    rec[name]["multiply_fill_ms"] = e0.elapsed_time(e1) / 20
    return out


BENCHES = {"v1": v1_bench, "paned": paned_bench, "route2": route2_bench,
           "solve": solve_bench, "band": band_bench,
           "mul_paned": mul_paned_bench, "band_mm": band_mm_bench,
           "band_res": band_res_bench,
           "bsr_mm": bsr_mm_bench, "cx": cx_bench,
           "block_spgemm": spgemm_bench, "bsr_mv": bsr_mv_bench,
           "v1_mul": v1_mul_bench, "mul": mul_bench, "dia": dia_bench}
# worker options the benches read (--graph)
OPTS = {}


def worker(args):
    import torch
    import spblas_tpu_torch as sp
    from spblas_tpu_torch import _build
    from spblas_tpu_torch.utils import generate as gen

    tree = Path(sp.__file__).resolve().parent.parent
    out_dir = Path(args.trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = [t for k in args.kernels.split(",")
               for t in ALIASES.get(k, (k,))]
    OPTS["graph"] = args.graph
    rec = {"tree": str(tree),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    names = [n for k in kernels for n in sources(_build, k)]
    rec["ptxas"] = build_report(_build, names)
    rec["occupancy"] = occupancy(_build, names,
                                 _build.BUILD / f"occ_{os.getpid()}")
    # tag -> {bench name: (chain fn, inputs, (apply fn, args), check[,
    # chain length])}
    benches = {}
    for k in kernels:
        rec[k] = {}
        benches[k] = BENCHES[k](torch, sp, gen, rec[k])
    chosen = [v for v in args.only_variants.split(",") if v] or VARIANTS
    variants = ["base"] + (list(chosen) if args.variants else [])
    csrc0, build0 = _build.CSRC, _build.BUILD
    # every variant's sources at once, one nvcc each, all started together
    started, vtags = {}, {}
    for v in variants[1:]:
        vdir = build0 / "variants" / v
        vsrc, tags = variant_csrc(csrc0, vdir / "csrc", VARIANTS[v])
        vtags[v] = tags & set(kernels)
        _build.CSRC, _build.BUILD = vsrc, vdir / "build"
        started[v] = {n: _build._start(n) for k in vtags[v]
                      for n in sources(_build, k)}
    _build.CSRC, _build.BUILD = csrc0, build0
    prebuilt = {v: {n: ptxas_report(_build._finish(n, st))
                    for n, st in sts.items()} for v, sts in started.items()}
    for v in variants:
        tags = set(kernels)
        if v != "base":
            vdir = build0 / "variants" / v
            tags = vtags[v]
            if not tags:
                continue
            _build.CSRC, _build.BUILD = vdir / "csrc", vdir / "build"
            _build._libs.clear()
            _build._fns.clear()
            report = prebuilt[v]
            rec.setdefault("variant_ptxas", {})[v] = {
                f: {"registers": r.get("registers"),
                    "spills": r.get("spill_stores", 0)
                    + r.get("spill_loads", 0)}
                for fns in report.values() for f, r in fns.items()}
        for k in tags:
            for bname, (fn, ins, _, check, *reps) in benches[k].items():
                rec[k].setdefault(bname, {})
                rec[k][bname][f"{v}_ms"] = device_ms(torch, fn, ins, *reps)
                if check is not None and (v == "base"
                                          or v.startswith("lever_")):
                    rec[k][bname][f"{v}_in_bound"] = check(fn(*ins[0]))
        if v == "base":
            tag = f"{os.getpid()}"
            for k in kernels:
                for bname, (fn, ins, (apply, aargs), *_) in \
                        benches[k].items():
                    rec[k][bname]["chain_trace"] = summarise(trace_ops(
                        torch, fn, ins[0], 3, True,
                        out_dir / f"{bname}_chain_{tag}.json"), 3)
                    rec[k][bname]["apply_trace"] = summarise(trace_ops(
                        torch, apply, aargs, 3, False,
                        out_dir / f"{bname}_apply_{tag}.json"), 3)
    print(json.dumps(rec), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append")
    ap.add_argument("--out", default="profile_out/route_profile.json")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-variants", action="store_true",
                    help="time each tree's kernels as they are, only")
    ap.add_argument("--trace-dir", default="profile_out/traces")
    ap.add_argument("--graph", action="store_true",
                    help="also replay each solve from a CUDA graph")
    ap.add_argument("--only-variants", default="",
                    help="comma-separated variants to run (default: all)")
    ap.add_argument("--kernels", default=",".join(BENCHES),
                    help="comma-separated subset of "
                    + ",".join([*BENCHES, *ALIASES]))
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    try:
        import torch
        if not torch.cuda.is_available():
            raise ImportError
    except ImportError:
        print("route_profile: no CUDA device", file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in (args.tree or [str(ROOT)])]
    seen, recs, failed = set(), [], False
    for tree in trees:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               "--trace-dir", str(Path(args.trace_dir).resolve()),
               "--kernels", args.kernels,
               "--only-variants", args.only_variants]
        if args.graph:
            cmd.append("--graph")
        if tree not in seen and not args.no_variants:
            cmd.append("--variants")
        seen.add(tree)
        env = dict(os.environ, PYTHONPATH=str(tree))
        out = subprocess.run(cmd, env=env, cwd=str(tree),
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"route_profile: worker for {tree} failed "
                  f"({out.returncode})", file=sys.stderr)
            failed = True
            continue
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of spblas_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``spblas_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the main
path ``multiply(scaled(2.0, matrix_opt(A)), x)`` at full width (the
409,600-row banded headline matrix, the 1000x1000 stencil, the 800x800
FEM mesh, the 64^3 stencil and a uniform 100k matrix) against the port's
float64 base path, and times every kernel beside its bound, its plain
version and the cuSPARSE call (``torch.mv`` on a ``torch.sparse_csr_tensor``,
timed here as a yardstick only; the port never calls it).

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

import dataclasses
import json
import math
import subprocess
import sys
import time
import warnings

import torch

import spblas_tpu_torch as sp
from spblas_tpu_torch import _build
from spblas_tpu_torch.kernels import banded, dia
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
SELL_MAIN = ("uniform_100k_deg10", lambda: gen.generate_csr(
    100_000, 100_000, 1_000_000, seed=5))

BAND_SOURCE = "spblas_tpu_torch/csrc/band_spmv.cu"
DIA_SOURCE = "spblas_tpu_torch/csrc/dia_spmv.cu"
BAND_REPLACES = "spblas_tpu/kernels/banded.py:104"
DIA_REPLACES = "spblas_tpu/kernels/dia.py:146"


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


def row_check(y, y_ref, absdot, scale=1.0):
    """Per-row tolerance; returns max |y - y_ref|."""
    err = (y.double() - y_ref.double()).abs()
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


# ------------------------------------------------------------------ #
# phase 3: the main path at full width
# ------------------------------------------------------------------ #

def main_path(name, a, kind, seed, card):
    x = gen.generate_vector(a.shape[1], seed=seed)
    opt = sp.matrix_opt(a)
    banded.band_spmv_padded.launches = 0
    dia.dia_spmv_padded.launches = 0
    t0 = time.perf_counter()
    y = sp.multiply(sp.scaled(2.0, opt), x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"band_spmv": banded.band_spmv_padded.launches,
                "dia_spmv": dia.dia_spmv_padded.launches}
    got = opt._plans["matvec"][0]
    log(f"[main] {name}: kind {got}, launches {launches}")
    require(got == kind, f"{name}: chooser picked {got!r}, want {kind!r}")
    require(y.shape == (a.shape[0],) and y.dtype == torch.float32
            and bool(torch.isfinite(y).all()), f"{name}: bad result")
    # reference: the port's own base path in float64 on the card
    a64 = dataclasses.replace(a, values=a.values.double())
    y_ref = sp.multiply(sp.scaled(2.0, a64), x.double())
    absdot = sp.multiply(dataclasses.replace(a, values=a.values.abs()
                                             .double()), x.abs().double())
    err = row_check(y, y_ref, absdot, scale=2.0)
    xs = [gen.generate_vector(a.shape[1], seed=seed + 1 + i)
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
    return rec


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

    # phase 1: build every kernel from the sources, all at once
    t0 = time.perf_counter()
    outs = _build.build_all()
    log(f"[build] {sorted(outs)} in {time.perf_counter() - t0:.1f} s")
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

    # phase 3: the main path at full width, counts read around each run
    main = [main_path(hname, head, "band", 31, card)]
    main += [main_path(n, a, "dia", 41, card) for n, a in mats.items()]
    main.append(main_path(SELL_MAIN[0], SELL_MAIN[1](), "sell", 51, card))
    launches = {k: sum(r["launches"][k] for r in main)
                for k in ("band_spmv", "dia_spmv")}
    require(launches["band_spmv"] > 0 and launches["dia_spmv"] > 0,
            f"main path missed a kernel: {launches}")

    # phase 4: one line per kernel and shape, with the launches of the
    # main-path call on that matrix (0: a kernel-only shape)
    by_name = {r["main_path"]: r["launches"] for r in main}
    for r in band_recs + list(dia_recs.values()):
        r["launches"] = by_name.get(r["case"], {}).get(r["kernel"], 0)
        emit(r)

    hb, hd = band_recs[len(BAND_CASES)], dia_recs[DIA_MAIN[0][0]]
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
    ]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(run())

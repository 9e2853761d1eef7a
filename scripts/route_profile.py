#!/usr/bin/env python3
"""Device-time profile of the two ROUTE SpMV kernels of spblas_tpu_torch
on their main-path shapes: ``route_spmv`` (ROUTE v1) on the degree-sorted
base plan of the 131k R-MAT graph (bench.py:768, seed 5), and
``route_paned_spmv`` (paned ROUTE2) on uniform 4M degree 10 (bench.py:606,
seed 3), both as the CUDA chooser builds them.

    python3 scripts/route_profile.py [--tree DIR ...] [--out FILE]

Each ``--tree`` is a checkout holding ``spblas_tpu_torch/`` (default: this
one); the trees run one worker process each, in the order given, so
``--tree _checkout/parent --tree . --tree . --tree _checkout/parent``
compares two versions in turns on one card.  A worker times, per kernel:

- the kernel chain as ``chip_smoke.py`` defines it (CUDA events over
  chains cycling through copies past the 50 MB L2, a device sleep queued
  ahead so host time does not count): the v1 levels from the packed
  level-0 x, the paned panels, pane zeroing included;
- the same chain rebuilt from variants of the tree's sources (the first
  time a tree appears, unless ``--no-variants``): ``no_publish`` (each
  publish ``atomicAdd`` made a predicated store that never fires),
  ``const_gather`` (every x or pane read of the gather replaced by 1.0),
  both at once, and for the one-launch v1 kernel ``no_stream`` (its ring
  filled by nothing) alone and with the other two;
- one ``torch.profiler`` trace of three chains and of three public
  applies (``route_spmv`` / ``route_paned_spmv`` from x, host included):
  every device operation in order with its duration, and the gaps; the
  traces go to ``--trace-dir``.

Prints one JSON object per worker and writes them all to ``--out``.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (kernel, file, regex, replacement): a variant rebuilds the kernels
# whose patterns match (the paned chunk body is route2_chunk.cuh's)
_PUBLISH = [
    (tag, f, r"atomicAdd\((\w+) \+ row \* kLanes \+ j, ",
     r"route_sink(\1 + row * kLanes + j, ")
    for tag, f in (("v1", "route_spmv.cu"), ("paned", "route2_chunk.cuh"))]
_GATHER = [
    ("v1", "route_spmv.cu",
     r"\w+\[row \* kLanes \+ bits\(a\[i\], 3, 127\)\]", "1.0f"),
    ("v1", "route_spmv.cu", r"d \? __ldcg\(px\) : __ldg\(px\)", "1.0f"),
    ("paned", "route2_chunk.cuh", r"src\[row \* kLanes \+ j\]", "1.0f")]
# the one-launch v1 kernel only: no plan stream (the ring's bulk copies
# dropped; the chunks compute on whatever the ring holds)
_STREAM = [("v1", "route_spmv.cu", r"bar_expect\(bar, \d \* kTileBytes\);",
            "bar_expect(bar, 0);"),
           ("v1", "route_spmv.cu", r"bulk_load\(st\.[^;]*\);", ";")]
# a variant is a list of groups; a kernel is rebuilt under it where each
# group matched somewhere in its sources
VARIANTS = {"no_publish": [_PUBLISH], "const_gather": [_GATHER],
            "no_publish_const_gather": [_PUBLISH, _GATHER],
            "no_stream": [_STREAM],
            "no_stream_publish_gather": [_STREAM, _PUBLISH, _GATHER]}
_SINK = ("\n#ifndef ROUTE_SINK\n#define ROUTE_SINK\n"
         "__device__ __forceinline__ void route_sink(float* p, float v) "
         "{ if (v == 1.2345e-30f) *p = v; }\n#endif\n")
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
        for tag, fname, pat, rep in group:
            path = dest / fname
            new, n = re.subn(pat, rep, path.read_text())
            hits[tag, gi] = hits.get((tag, gi), 0) + n
            if "route_sink(" in new and "void route_sink" not in new:
                head = new.index("\n", new.index("#include"))
                new = new[:head] + _SINK + new[head:]
            path.write_text(new)
    return dest, {t for t, _ in hits
                  if all(hits.get((t, gi), 0) for gi in range(len(groups)))}


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
           and "sleep" not in e["name"]]
    ops.sort(key=lambda o: o[1])
    return ops


def summarise(ops, calls):
    """Per-call device op count and busy time, gap total, and each op of
    the first call (name, dur) with the gap before it."""
    if not ops:
        return {"device_ops": 0}
    per = len(ops) // calls
    busy = sum(d for _, _, d in ops)
    span = ops[-1][1] + ops[-1][2] - ops[0][1]
    first = []
    prev_end = None
    for name, ts, dur in ops[:per]:
        gap = None if prev_end is None else round(ts - prev_end, 3)
        first.append({"op": name[:60], "us": round(dur, 3), "gap_us": gap})
        prev_end = ts + dur
    return {"device_ops_per_call": per, "busy_us_per_call": busy / calls,
            "span_us_per_call": span / calls,
            "gap_us_per_call": (span - busy) / calls, "first_call": first}


def worker(args):
    import torch
    import spblas_tpu_torch as sp
    from spblas_tpu_torch import _build
    from spblas_tpu_torch.kernels import plans
    from spblas_tpu_torch.kernels import route_paned as rpn
    from spblas_tpu_torch.kernels import route_spmv as rsp
    from spblas_tpu_torch.utils import generate as gen

    tree = Path(sp.__file__).resolve().parent.parent
    out_dir = Path(args.trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
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

    big = gen.generate_csr(4_000_000, 4_000_000, 40_000_000, seed=3)
    kind, paned = plans._try_route_paned(big)
    assert kind == "route_paned", kind
    x_pn = gen.generate_vector(big.shape[1], seed=75)
    del big

    import dataclasses

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

    def pn_copy():
        pl = dataclasses.replace(paned, panels=tuple(
            dataclasses.replace(q, **{f: getattr(q, f).clone() for f in (
                "tile", "val", "sb", "yb", "fl", "rho", "pane")})
            for q in paned.panels))
        return (pl, rpn.pack_x2(pl, x_pn))

    def pn_chain(pl, xx):
        for q in pl.panels:
            rpn.route_paned_spmv_padded(pl, q, xx)

    v1_bytes = sum(q.nchunks * (12 * 1024 + 8) + q.x_rows * 512
                   + 2 * q.pane_rows * 512 for q in levels)
    pn_bytes = paned.x_rows_pad * 512 + sum(
        q.nchunks * (8 * 1024 + 16 + 4 * q.rotated) + 2 * q.out_rows * 512
        for q in paned.panels)

    def reps_of(make, nbytes):
        k = min(32, max(2, math.ceil(_REPLICA_BYTES / max(nbytes, 1))))
        return [make() for _ in range(k)]

    v1_ins = reps_of(v1_copy, v1_bytes)
    pn_ins = reps_of(pn_copy, pn_bytes)
    rec = {"tree": str(tree), "fused_v1": fused_v1,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "v1": {"levels": len(levels),
                  "nchunks": [q.nchunks for q in levels],
                  "bytes": v1_bytes},
           "paned": {"panels": len(paned.panels),
                     "nchunks": paned.nchunks, "bytes": pn_bytes,
                     "aux_levels": max(len(q.launch_starts) - 1
                                       for q in paned.panels)}}
    variants = ["base"] + (list(VARIANTS) if args.variants else [])
    csrc0, build0 = _build.CSRC, _build.BUILD
    for v in variants:
        kernels = {"v1", "paned"}
        if v != "base":
            vdir = build0 / "variants" / v
            vsrc, kernels = variant_csrc(csrc0, vdir / "csrc", VARIANTS[v])
            _build.CSRC, _build.BUILD = vsrc, vdir / "build"
            _build._libs.clear()
            _build._fns.clear()
        if "v1" in kernels:
            rec["v1"][f"{v}_ms"] = device_ms(torch, v1_chain, v1_ins)
        if "paned" in kernels:
            rec["paned"][f"{v}_ms"] = device_ms(torch, pn_chain, pn_ins)
        if v == "base":
            tag = f"{os.getpid()}"
            rec["v1"]["chain_trace"] = summarise(trace_ops(
                torch, v1_chain, v1_ins[0], 3, True,
                out_dir / f"v1_chain_{tag}.json"), 3)
            rec["paned"]["chain_trace"] = summarise(trace_ops(
                torch, pn_chain, pn_ins[0], 3, True,
                out_dir / f"paned_chain_{tag}.json"), 3)
            rec["v1"]["apply_trace"] = summarise(trace_ops(
                torch, rsp.route_spmv, (base, x_v1), 3, False,
                out_dir / f"v1_apply_{tag}.json"), 3)
            rec["paned"]["apply_trace"] = summarise(trace_ops(
                torch, rpn.route_paned_spmv, (paned, x_pn), 3, False,
                out_dir / f"paned_apply_{tag}.json"), 3)
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
               "--trace-dir", str(Path(args.trace_dir).resolve())]
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

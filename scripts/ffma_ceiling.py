#!/usr/bin/env python3
"""The f32 FMA rate one NVIDIA GPU sustains, beside which an FMA kernel's
share of the data-sheet peak can be read.

    python3 scripts/ffma_ceiling.py [--out FILE]

Builds a kernel of independent FFMA chains in registers (64 accumulators
a thread, 128 threads a block, no memory traffic in the loop; ``nvcc``
into the ignored ``profile_out/``), runs it for about three seconds at 3,
4 and 8 blocks an SM, and reports TFLOP/s from CUDA events with the SM
clock and power that ``nvidia-smi`` samples meanwhile.  Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(128) ffma(float* out, int iters) {
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = threadIdx.x * 1e-3f + j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = fmaf(acc[j], 0.999f, 1e-3f);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 64; ++j) s += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_ffma(float* out, int blocks, int iters, void* stream) {
  ffma<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
_ITERS = 20_000
_SECONDS = 3.0


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from spblas_tpu_torch import _build
    work = ROOT / "profile_out" / "ffma"
    work.mkdir(parents=True, exist_ok=True)
    src, lib = work / "ffma.cu", work / "libffma.so"
    src.write_text(_SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_build._nvcc(), *flags, "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).run_ffma
    fn.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p)
    return fn


def run(torch, fn, blocks):
    """TFLOP/s of ``blocks`` blocks over about _SECONDS, with the mean SM
    clock and the largest power draw sampled meanwhile."""
    out = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn(out.data_ptr(), blocks, _ITERS, stream)
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    launches, t0 = 0, time.time()
    while time.time() - t0 < _SECONDS:
        if fn(out.data_ptr(), blocks, _ITERS, stream) != 0:
            raise RuntimeError("ffma launch failed")
        launches += 1
        if launches % 16 == 0:
            torch.cuda.synchronize()
    e1.record()
    torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.strip()][3:]      # the first samples precede the load
    ms = e0.elapsed_time(e1)
    flops = 2.0 * blocks * 128 * 64 * _ITERS * launches
    return {"blocks": blocks, "tflop_s": flops / (ms * 1e-3) / 1e12,
            "mean_sm_mhz": (sum(float(r[0]) for r in rows) / len(rows)
                            if rows else None),
            "max_power_w": max((float(r[1]) for r in rows), default=None)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out/ffma_ceiling.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ffma_ceiling: no CUDA device", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    fn = build()
    rec = {"card": card, "sms": sms,
           "runs": [run(torch, fn, sms * b) for b in (3, 4, 8)]}
    for r in rec["runs"]:
        r["blocks_per_sm"] = r.pop("blocks") // sms
    print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

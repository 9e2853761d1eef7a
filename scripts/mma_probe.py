#!/usr/bin/env python3
"""What the card's tensor cores do with the operands the port's kernels
give them, measured rather than assumed:

- TF32 ``mma.sync.m16n8k8``: a subnormal operand (2^-130, 2^-140) against
  2^120, a subnormal product, infinities, and an operand near FLT_MAX
  (does the unit truncate an f32 register's low 13 bits, or round?).
  ``csrc/tf32_mma.cuh`` (the 3xTF32 split's limits) rests on these.
- FP64 ``mma.sync`` shapes m8n8k4, m16n8k4, m16n8k8 and m16n8k16: each
  checked against ``A @ B`` in float64 (fragment layouts of the PTX ISA),
  and its throughput in registers, 1,056 blocks of 128 or 256 threads,
  four independent accumulators a warp (``csrc/bsr_spgemm.cu`` runs
  m16n8k8).
- ``atomicAdd`` on ``float2`` in global memory (``csrc/route2_spmv.cu``'s
  complex pass publishes each slot with one).

    python3 scripts/mma_probe.py [--out FILE]

Builds its kernels with ``nvcc`` into the ignored ``profile_out/``, prints
one JSON object and writes it to ``--out``.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NVCC = ("/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

TF32 = r'''
#include <cuda_runtime.h>
#include <cstdint>
// one warp: D (16x8) = A (16x8) B (8x8), row-major f32 registers as TF32
__global__ void k(const float* A, const float* B, float* D) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t a[4], b[2];
  a[0] = __float_as_uint(A[g * 8 + t]);
  a[1] = __float_as_uint(A[(g + 8) * 8 + t]);
  a[2] = __float_as_uint(A[g * 8 + t + 4]);
  a[3] = __float_as_uint(A[(g + 8) * 8 + t + 4]);
  b[0] = __float_as_uint(B[t * 8 + g]);
  b[1] = __float_as_uint(B[(t + 4) * 8 + g]);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  D[g * 8 + 2 * t] = d[0]; D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2]; D[(g + 8) * 8 + 2 * t + 1] = d[3];
}
__global__ void atomic2(float2* p, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(p + (i % 7), make_float2(1.f, 2.f));
}
extern "C" int run(const void* A, const void* B, void* D) {
  k<<<1, 32>>>((const float*)A, (const float*)B, (float*)D);
  return (int)cudaGetLastError();
}
extern "C" int run_atomic2(void* p, int n) {
  atomic2<<<(n + 127) / 128, 128>>>((float2*)p, n);
  return (int)cudaGetLastError();
}
'''

# (shape, M, K, A registers, B registers, C registers)
F64 = (("m8n8k4", 8, 4, 1, 1, 2), ("m16n8k4", 16, 4, 2, 1, 4),
       ("m16n8k8", 16, 8, 4, 2, 4), ("m16n8k16", 16, 16, 8, 4, 4))


def f64_source(shape, m, k, na, nb, nc):
    """A layout check (one warp, D = A B) and a throughput kernel (four
    independent accumulators a warp) for one f64 mma shape."""
    if m == 8:
        aidx = ["A[g * K + t]"]
        cst = "D[g * 8 + 2 * t] = d[0]; D[g * 8 + 2 * t + 1] = d[1];"
    else:
        aidx = [f"A[(g + {8 * (q % 2)}) * K + t + {4 * (q // 2)}]"
                for q in range(na)]
        cst = ("D[g * 8 + 2 * t] = d[0]; D[g * 8 + 2 * t + 1] = d[1]; "
               "D[(g + 8) * 8 + 2 * t] = d[2]; "
               "D[(g + 8) * 8 + 2 * t + 1] = d[3];")
    bidx = [f"B[(t + {4 * q}) * 8 + g]" for q in range(nb)]
    regs = (", ".join(f"%{i}" for i in range(nc)),
            ", ".join(f"%{nc + i}" for i in range(na)),
            ", ".join(f"%{nc + na + i}" for i in range(nb)))

    def mma(acc):
        outs = ", ".join(f'"+d"({acc}[{i}])' for i in range(nc))
        ins = ", ".join([f'"d"(a[{i}])' for i in range(na)]
                        + [f'"d"(b[{i}])' for i in range(nb)])
        return (f'asm volatile("mma.sync.aligned.{shape}.row.col.f64.f64.'
                f'f64.f64 {{{regs[0]}}}, {{{regs[1]}}}, {{{regs[2]}}}, '
                f'{{{regs[0]}}};\\n" : {outs} : {ins});')

    loads = " ".join([f"a[{q}] = {e};" for q, e in enumerate(aidx)]
                     + [f"b[{q}] = {e};" for q, e in enumerate(bidx)])
    body = "\n    ".join(mma(f"d{i}") for i in range(4))
    return f'''
#include <cuda_runtime.h>
constexpr int K = {k};
__global__ void k(const double* A, const double* B, double* D) {{
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[{na}], b[{nb}], d[{nc}] = {{}};
  {loads}
  {mma("d")}
  {cst}
}}
__global__ void bench(double* out, int iters) {{
  double a[{na}], b[{nb}], d0[{nc}] = {{}}, d1[{nc}] = {{}}, d2[{nc}] = {{}},
      d3[{nc}] = {{}};
  for (int q = 0; q < {na}; ++q) a[q] = 1.0 + 1e-9 * (threadIdx.x + q);
  for (int q = 0; q < {nb}; ++q) b[q] = 1.0 - 1e-9 * (threadIdx.x + q);
  for (int it = 0; it < iters; ++it) {{
    {body}
  }}
  double s = 0;
  for (int q = 0; q < {nc}; ++q) s += d0[q] + d1[q] + d2[q] + d3[q];
  if (s == 12345.0) out[threadIdx.x] = s;
}}
extern "C" int run(const void* A, const void* B, void* D) {{
  k<<<1, 32>>>((const double*)A, (const double*)B, (double*)D);
  return (int)cudaGetLastError();
}}
extern "C" int run_bench(void* out, int blocks, int threads, int iters) {{
  bench<<<blocks, threads>>>((double*)out, iters);
  return (int)cudaGetLastError();
}}
'''


def build(work: Path, sources):
    """Every source built at once; returns {name: CDLL}."""
    procs = {}
    for name, text in sources.items():
        src = work / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [*NVCC, "-o", str(work / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}: {out[-2000:]}")
        libs[name] = ctypes.CDLL(str(work / f"{name}.so"))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out/mma_probe.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device", file=sys.stderr)
        return 2
    work = ROOT / "profile_out" / "mma_probe"
    work.mkdir(parents=True, exist_ok=True)
    libs = build(work, {"tf32": TF32, **{f"f64_{s[0]}": f64_source(*s)
                                         for s in F64}})
    dev = "cuda"
    rec = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "tf32": {}, "f64": {}}
    ptr = ctypes.c_void_p

    def tf32(a_val, b_val, fill_a=None, fill_b=None):
        """D[0, 0] of one mma: A, B filled with a_val, b_val (or only
        their first entry, the rest 0)."""
        a = torch.zeros(16, 8, device=dev)
        b = torch.zeros(8, 8, device=dev)
        if fill_a is None:
            a.fill_(a_val)
            b.fill_(b_val)
        else:
            a[0, 0], b[0, 0] = fill_a, fill_b
        d = torch.zeros(16, 8, device=dev)
        libs["tf32"].run(ptr(a.data_ptr()), ptr(b.data_ptr()),
                         ptr(d.data_ptr()))
        torch.cuda.synchronize()
        return float(d[0, 0])

    for label, av in (("2^-130 (TF32 subnormal)", 2.0 ** -130),
                      ("2^-126", 2.0 ** -126),
                      ("2^-140 (below TF32's grid)", 2.0 ** -140)):
        rec["tf32"][f"8 x {label} x 2^120"] = {
            "got": tf32(av, 2.0 ** 120), "exact": 8 * av * 2.0 ** 120}
    rec["tf32"]["8 x 2^-70 x 2^-62 (subnormal product)"] = {
        "got": tf32(2.0 ** -70, 2.0 ** -62), "exact": 8 * 2.0 ** -132}
    for av, bv in ((float("inf"), 1.0), (float("inf"), 0.0),
                   (3.4026e38, 1.0)):
        rec["tf32"][f"{av} x {bv}"] = tf32(0, 0, av, bv)
    # 1 + 2^-11 + 2^-12 + 2^-23 (TF32's ulp at 1 is 2^-10): truncated it
    # reads 1, rounded to nearest 1 + 2^-10
    x = 1 + 2.0 ** -11 + 2.0 ** -12 + 2.0 ** -23
    rec["tf32"]["operand 1 + 2^-11 + 2^-12 + 2^-23 x 1"] = {
        "got": tf32(0, 0, x, 1.0), "truncated": 1.0,
        "rounded": 1 + 2.0 ** -10}
    buf = torch.zeros(14, device=dev)
    libs["tf32"].run_atomic2(ptr(buf.data_ptr()), 7000)
    torch.cuda.synchronize()
    rec["float2_atomicAdd_7000_into_7"] = buf.view(7, 2).tolist()
    g = torch.Generator().manual_seed(0)
    for shape, m, k, *_ in F64:
        lib = libs[f"f64_{shape}"]
        a = torch.rand(m, k, generator=g, dtype=torch.float64).to(dev)
        b = torch.rand(k, 8, generator=g, dtype=torch.float64).to(dev)
        d = torch.zeros(m, 8, dtype=torch.float64, device=dev)
        lib.run(ptr(a.data_ptr()), ptr(b.data_ptr()), ptr(d.data_ptr()))
        torch.cuda.synchronize()
        out = torch.zeros(1024, dtype=torch.float64, device=dev)
        r = {"layout_max_err": float((d - a @ b).abs().max())}
        iters, blocks = 4096, 132 * 8
        for threads in (128, 256):
            lib.run_bench(ptr(out.data_ptr()), blocks, threads, 16)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            lib.run_bench(ptr(out.data_ptr()), blocks, threads, iters)
            e1.record()
            torch.cuda.synchronize()
            flops = 2 * m * 8 * k * 4 * iters * blocks * (threads // 32)
            r[f"tflop_s_{threads}_threads"] = flops / e0.elapsed_time(e1) / 1e9
        rec["f64"][shape] = r
    print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

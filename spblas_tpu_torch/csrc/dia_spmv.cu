// Fused multi-diagonal (DIA) SpMV for Hopper:
//   y[i] = sum_k diags[k][i] * x[i + offsets[k]]   (x read as 0 outside
//                                                    [0, n))
//
// Replaces the TPU kernel spblas_tpu/kernels/dia.py::_dia_kernel
// (pl.pallas_call in _dia_spmv_pallas).  The diagonals keep the JAX
// plan's (ndiag, rows_pad, 128) layout, viewed flat.
//
// What bounds it on the H100: bytes.  It reads every diagonal slot of
// the m output rows once and x once (the ndiag shifted reads of x
// overlap and hit L1/L2), and writes y once: about (ndiag + 2) * m * 4
// bytes, 28 MB (8.4 us at 3.35 TB/s) for the 1000x1000 5-point stencil,
// 9.4 MB (2.8 us) for the 7-point 64^3 stencil.
//
// Two kernels, one sum: both run over k in the TPU kernel's order, each
// step acc += d * x (one fused multiply-add), so they give the same bits.
//  - dia_inplace_kernel (dia_spmv_inplace_f32 / _bf16x), the main path's:
//    x read in place, f32 or bf16, with zeros outside [0, n), and y
//    written as m rows.  A thread takes kVec consecutive outputs: each
//    diagonal's values in 16-byte loads (a diagonal row is rows_pad * 128
//    floats, so every such load is aligned), x's in aligned vector loads
//    where the diagonal's offset keeps the thread's run aligned (stencil
//    offsets are mostly multiples of 4), else one load an output.  The
//    offsets ride in the launch's parameters (no load), and the diagonal
//    count is a compile-time parameter (exact up to kExact, then 16 or
//    32 with the rest predicated off), so every load of a thread is
//    issued before its first sum.  The first design
//    (below) gave one output to a thread behind a run-time loop: at 64^3
//    one wave of 1,024 blocks, each warp waiting out its 7 diagonal and
//    7 x loads one diagonal at a time (0.0068 ms against a 0.0028 ms
//    bound, NVIDIA H100 80GB HBM3, 700 W), after a copy of x into the
//    TPU kernel's padded x pane on every call.
//  - dia_spmv_kernel (dia_spmv_f32), the first design, over that padded
//    x2 (pad_lo zeros in front and enough behind, so every read is in
//    bounds), all rows_pad * 128 outputs; kept for the padded form
//    dia_spmv_padded, which the chip check holds the in-place kernel to.
// Each output has exactly one writer: no atomics, and no reliance on the
// TPU's in-order grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDiags = 32;      // the plan gate's cap (kernels/dia.py)
constexpr int kExact = 9;          // diagonal counts compiled exactly
constexpr int kInThreads = 128;    // threads a block of the in-place kernel
constexpr int kVec = 4;            // outputs a thread (16-byte loads)

struct Offsets {
  int v[kMaxDiags];
};

__device__ __forceinline__ float load_x(const float* x, long long j) {
  return __ldg(x + j);
}

__device__ __forceinline__ float load_x(const __nv_bfloat16* x,
                                        long long j) {
  return __bfloat162float(x[j]);
}

// 4 values of x from j (aligned: j and x's base make one vector load)
__device__ __forceinline__ void load_x4(const float* x, long long j,
                                        float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(x + j));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_x4(const __nv_bfloat16* x,
                                        long long j, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(x + j));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

// ND diagonals (ndiag exactly, for ND <= kExact; else at most ND, the
// rest predicated off); x_vec: x's base allows vector loads (16 bytes
// f32, 8 bytes bf16).  Every load of the thread is issued before its
// first sum, the loops being unrolled whole: the offsets are then read
// from the parameters at fixed places (an index known only at run time
// would copy them out).
template <typename XT, int ND>
__global__ void __launch_bounds__(kInThreads)
    dia_inplace_kernel(const float* __restrict__ diags, Offsets off,
                       int ndiag, const XT* __restrict__ x,
                       float* __restrict__ y, long long m, long long n,
                       long long total, bool x_vec) {
  static_assert(kVec % 4 == 0, "whole 16-byte loads of each diagonal");
  constexpr int kQ = kVec / 4;
  const int nd = ND <= kExact ? ND : ndiag;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kInThreads + threadIdx.x) *
      kVec;
  if (i0 >= m) return;
  float4 d[ND][kQ];
  float xv[ND][kVec];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    if (k < nd) {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        d[k][q] = __ldg(reinterpret_cast<const float4*>(
            diags + k * total + i0 + 4 * q));
      const long long j = i0 + off.v[k];
      if (x_vec && (off.v[k] & 3) == 0 && j >= 0 && j + kVec <= n) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) load_x4(x, j + 4 * q, xv[k] + 4 * q);
      } else {
#pragma unroll
        for (int t = 0; t < kVec; ++t)
          xv[k][t] = j + t >= 0 && j + t < n ? load_x(x, j + t) : 0.f;
      }
    }
  }
  float acc[kVec];
#pragma unroll
  for (int t = 0; t < kVec; ++t) acc[t] = 0.f;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    if (k < nd) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        acc[4 * q] += d[k][q].x * xv[k][4 * q];
        acc[4 * q + 1] += d[k][q].y * xv[k][4 * q + 1];
        acc[4 * q + 2] += d[k][q].z * xv[k][4 * q + 2];
        acc[4 * q + 3] += d[k][q].w * xv[k][4 * q + 3];
      }
    }
  }
  if (i0 + kVec <= m) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      *reinterpret_cast<float4*>(y + i0 + 4 * q) = make_float4(
          acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < kVec; ++t)
      if (i0 + t < m) y[i0 + t] = acc[t];
  }
}

__global__ void dia_spmv_kernel(const float* __restrict__ diags,
                                const int* __restrict__ offsets, int ndiag,
                                const float* __restrict__ x2,
                                float* __restrict__ y, long long total,
                                int pad_lo) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int k = 0; k < ndiag; ++k) {
    acc += diags[k * total + i] * x2[i + pad_lo + __ldg(offsets + k)];
  }
  y[i] = acc;
}

}  // namespace

// diags: (ndiag, total) f32; offsets: (ndiag,) int32 on the device;
// x2: f32 of length >= total + pad_lo + max(offsets); y: (total,) f32.
extern "C" int dia_spmv_f32(const void* diags, const void* offsets,
                            int ndiag, const void* x2, void* y,
                            long long total, int pad_lo, void* stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0) {
    dia_spmv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(diags), static_cast<const int*>(offsets),
        ndiag, static_cast<const float*>(x2), static_cast<float*>(y), total,
        pad_lo);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename XT, int ND>
void launch_nd(unsigned blocks, cudaStream_t stream, const float* diags,
               const Offsets& off, int ndiag, const XT* x, float* y,
               long long m, long long n, long long total, bool x_vec) {
  dia_inplace_kernel<XT, ND><<<blocks, kInThreads, 0, stream>>>(
      diags, off, ndiag, x, y, m, n, total, x_vec);
}

// the kernel of ndiag diagonals: exact up to kExact, then 16 or 32
template <typename XT, int ND = 1>
void dispatch(int ndiag, unsigned blocks, cudaStream_t stream,
              const float* diags, const Offsets& off, const XT* x, float* y,
              long long m, long long n, long long total, bool x_vec) {
  if constexpr (ND <= kExact) {
    if (ndiag == ND)
      return launch_nd<XT, ND>(blocks, stream, diags, off, ndiag, x, y, m,
                               n, total, x_vec);
    return dispatch<XT, ND + 1>(ndiag, blocks, stream, diags, off, x, y, m,
                                n, total, x_vec);
  } else {
    if (ndiag <= 16)
      return launch_nd<XT, 16>(blocks, stream, diags, off, ndiag, x, y, m,
                               n, total, x_vec);
    return launch_nd<XT, kMaxDiags>(blocks, stream, diags, off, ndiag, x, y,
                                    m, n, total, x_vec);
  }
}

template <typename XT>
int launch_inplace(const void* diags, const int* offsets, int ndiag,
                   const void* x, void* y, long long m, long long n,
                   long long total, void* stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || total % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets off{};
  for (int k = 0; k < ndiag; ++k) off.v[k] = offsets[k];
  const long long threads = (m + kVec - 1) / kVec;
  const long long blocks = (threads + kInThreads - 1) / kInThreads;
  const bool x_vec = reinterpret_cast<unsigned long long>(x) %
                         (4 * sizeof(XT)) == 0;
  if (blocks > 0) {
    dispatch<XT>(ndiag, static_cast<unsigned>(blocks),
                 static_cast<cudaStream_t>(stream),
                 static_cast<const float*>(diags), off,
                 static_cast<const XT*>(x), static_cast<float*>(y), m, n,
                 total, x_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// diags: (ndiag, total) f32 on the device, total = rows_pad * 128 >= m;
// offsets: (ndiag,) int32 on the host (1 <= ndiag <= 32), passed by
// value; x: (n,) f32 (or bf16 for _bf16x) read in place; y: (m,) f32.
extern "C" int dia_spmv_inplace_f32(const void* diags, const int* offsets,
                                    int ndiag, const void* x, void* y,
                                    long long m, long long n,
                                    long long total, void* stream) {
  return launch_inplace<float>(diags, offsets, ndiag, x, y, m, n, total,
                               stream);
}

extern "C" int dia_spmv_inplace_bf16x(const void* diags,
                                      const int* offsets, int ndiag,
                                      const void* x, void* y, long long m,
                                      long long n, long long total,
                                      void* stream) {
  return launch_inplace<__nv_bfloat16>(diags, offsets, ndiag, x, y, m, n,
                                       total, stream);
}

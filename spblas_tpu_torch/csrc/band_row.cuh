// The band-panel row kernel, shared by band_spmv.cu (one SpMV) and
// band_power.cu (y = A^iters x, one launch per iteration):
// y[row] = sum_c panels[row, c] * xp[(row / 128) * 128 + c].
//
// Panel row r belongs to row block blk = r / 128, and panel column c
// holds A[r, blk*128 + c - pad_l]; x arrives pre-padded by pad_l as xp,
// so the row's window is xp[blk*128 .. blk*128 + W).  The 128 rows of a
// row block share that window.
//
// What bounds it on the H100: bytes (every panel element is read once,
// for 2 flops).  What held the first design (one warp a row, each lane
// striding over W with 4-byte loads, the window read again from L1 for
// every element, a 5-step shuffle tree a row) short of the bytes was the
// count of load instructions and the bytes each kept in flight: f32 ran
// at 70 % of its bound, and bf16, with half the bytes, at 43 %.
//
// Design: a CUDA block of 8 warps takes 64 rows (half a row block) and
// first copies the window into shared memory, once.  A warp then takes
// its rows in groups of RW (4 for f32, 8 for bf16): every lane loads 16
// bytes (4 f32 or 8 bf16) of each row of the group at neighbouring
// addresses, evict-first, 8 loads issued before the first FMA, and reads
// the matching window values from shared memory once for all RW rows.
// The group's RW partial sums leave the warp in log2(RW) halving
// exchanges (each lane trades half its sums with its partner) and
// 5 - log2(RW) plain ones: 6 shuffles for 4 rows, 9 for 8, where a tree
// a row takes 5 each.  One lane writes each row: one writer, no atomics.
// A window wider than kTile floats passes through shared memory in
// tiles, the sums staying in registers.  A panels pointer that is not
// 16-byte aligned, or a row that is not a whole number of 16-byte loads
// (W not a multiple of 4 in f32, of 8 in bf16), takes the same design
// with one-element loads; the window copy reads one float at a time and
// takes any xp.  Row offsets are 64-bit (past 2^27 rows a 32-bit row
// times W wraps).  At the headline shape this takes 122 us in f32 and
// 62 us on bf16 panels, 94 % and 93 % of the bytes' rate (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py); scripts/route_profile.py rebuilds
// the kernel with one of the integer constants below changed to time
// each choice.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace band {

constexpr int kRowsPerBlock = 128;   // panel rows per row block
constexpr int kWarps = 8;            // warps per CUDA block
constexpr int kThreads = 32 * kWarps;
constexpr int kItemRows = 64;        // panel rows per CUDA block
constexpr int kLoads = 8;            // panel loads a lane issues at once
constexpr int kTile = 8192;          // window floats in shared memory

// E elements of T, loaded as one: 16 bytes (E = 16 / sizeof(T)) or one
// element (E = 1); panel rows stream once, so evict-first (ld.cs)
template <typename T, int E>
struct Pack;

template <>
struct Pack<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  // a bf16 is the top half of the f32 of the same value: exact
  __device__ __forceinline__ float at(int e) const {
    const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Pack<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldcs(p); }
  __device__ __forceinline__ float at(int) const { return v; }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  unsigned short v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ float at(int) const {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
};

// the window values xs[c .. c + E)
template <int E>
__device__ __forceinline__ void window(const float* xs, float (&x)[E]) {
  if constexpr (E == 1) {
    x[0] = xs[0];
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(xs)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  }
}

// The RW sums of a warp's row group, each spread over the 32 lanes:
// lane l ends with the full sum of row l / (32 / RW).
template <int RW>
__device__ __forceinline__ float warp_rows(float (&acc)[RW], int lane) {
  int off = 16;
#pragma unroll
  for (int n = RW; n > 1; n >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? acc[i] : acc[i + n / 2];
      const float keep = up ? acc[i + n / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (; off > 0; off >>= 1) {
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
  }
  return acc[0];
}

// E elements a load; RW rows a group, U loads of each row in flight
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    row_kernel(const T* __restrict__ panels, const float* __restrict__ xp,
               float* __restrict__ y, int w) {
  constexpr int RW = E == 8 ? 8 : 4;
  constexpr int U = kLoads / RW;
  constexpr int G = kItemRows / (kWarps * RW);   // groups a warp
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kItemRows;
  const float* xwin = xp + row0 / kRowsPerBlock * kRowsPerBlock;

  float acc[G][RW];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int r = 0; r < RW; ++r) acc[gi][r] = 0.f;

  for (int t0 = 0; t0 < w; t0 += kTile) {
    const int t1 = min(w, t0 + kTile);
    if (t0 > 0) __syncthreads();   // every read of the last tile is done
    for (int c = t0 + threadIdx.x; c < t1; c += kThreads) {
      xs[c - t0] = xwin[c];
    }
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const T* prow = panels + (row0 + (gi * kWarps + warp) * RW) * w;
      for (int c0 = t0; c0 < t1; c0 += 32 * E * U) {
        Pack<T, E> p[U][RW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + (u * 32 + lane) * E;
          if (c < t1) {
#pragma unroll
            for (int r = 0; r < RW; ++r) p[u][r].load(prow + r * w + c);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + (u * 32 + lane) * E;
          if (c < t1) {
            float x[E];
            window<E>(xs + (c - t0), x);
#pragma unroll
            for (int r = 0; r < RW; ++r)
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[gi][r] = fmaf(p[u][r].at(e), x[e], acc[gi][r]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const float sum = warp_rows<RW>(acc[gi], lane);
    if ((lane & (32 / RW - 1)) == 0) {
      y[row0 + (gi * kWarps + warp) * RW + lane / (32 / RW)] = sum;
    }
  }
}

// One launch of row_kernel over `rows` panel rows (a multiple of 128) on
// `stream`, with 16-byte loads where the panels allow them (W = 0 writes
// zeros); returns cudaGetLastError().
template <typename T>
int launch_rows(const T* panels, const float* xp, float* y, int rows, int w,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int blocks = rows / kItemRows;
  if (blocks > 0) {
    const int tile = w < kTile ? w : kTile;
    const size_t smem = sizeof(float) * ((tile + 3) / 4 * 4);
    const bool vec = reinterpret_cast<std::uintptr_t>(panels) % 16 == 0 &&
                     w % kVec == 0;
    if (vec) {
      row_kernel<T, kVec><<<blocks, kThreads, smem, stream>>>(panels, xp, y,
                                                              w);
    } else {
      row_kernel<T, 1><<<blocks, kThreads, smem, stream>>>(panels, xp, y, w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band

// The register tile of the FMA BSR SpMM kernel (bsr_spmm.cu,
// bsr_spmm_kernel: f64 blocks, and f32 blocks that the tensor cores'
// split would not keep exact); the resident band SpMM has its own design
// (band_spmm.cu, namespace res).  Each thread owns 8 output rows by 4
// output columns, takes its 8 A values from a transposed shared-memory
// chunk (one broadcast read per value across the warp) and its 4 B
// values from one row of B (16 bytes where the columns allow), and does
// 32 FMAs per pair of reads.  All sums are f32 (or f64) FMAs, full
// precision as the TPU kernels' Precision.HIGHEST dots; the streamed
// band SpMM and the f32 BSR SpMM reach the same accuracy on the tensor
// cores instead (tf32_mma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace spmm_tile {

constexpr int kRows = 8;   // output rows per thread
constexpr int kCols = 4;   // output columns per thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// b[p] = row[col + p] for col + p < k, else 0.  VEC (float only, k a
// multiple of 4, row 16-byte aligned): one 16-byte load.
template <typename T, bool VEC>
__device__ __forceinline__ void load_b(const T* __restrict__ row,
                                       long long col, int k,
                                       T (&b)[kCols]) {
  if constexpr (VEC && std::is_same<T, float>::value) {
    if (col < k) {
      const float4 v = *reinterpret_cast<const float4*>(row + col);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    } else {
      b[0] = b[1] = b[2] = b[3] = T(0);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kCols; ++p) b[p] = col + p < k ? row[col + p] : T(0);
  }
}

// a[q] = s[q] for q < 8, s 16-byte aligned shared memory.
template <typename T>
__device__ __forceinline__ void load_a(const T* s, T (&a)[kRows]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 lo = *reinterpret_cast<const float4*>(s);
    const float4 hi = *reinterpret_cast<const float4*>(s + 4);
    a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
    a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
  } else {
#pragma unroll
    for (int q = 0; q < kRows; ++q) a[q] = s[q];
  }
}

template <typename T>
__device__ __forceinline__ void fma_tile(T (&acc)[kRows][kCols],
                                         const T (&a)[kRows],
                                         const T (&b)[kCols]) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int p = 0; p < kCols; ++p) acc[q][p] = fma(a[q], b[p], acc[q][p]);
  }
}

template <typename T>
__device__ __forceinline__ void zero_tile(T (&acc)[kRows][kCols]) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int p = 0; p < kCols; ++p) acc[q][p] = T(0);
  }
}

// c[(row0 + q) * k + col + p] = acc[q][p] for q < nrows, col + p < k.
template <typename T, bool VEC>
__device__ __forceinline__ void store_tile(T* __restrict__ c, long long row0,
                                           int nrows, long long col, int k,
                                           const T (&acc)[kRows][kCols]) {
  if (col >= k) return;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (q >= nrows) break;
    T* out = c + (row0 + q) * k + col;
    if constexpr (VEC && std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    } else {
#pragma unroll
      for (int p = 0; p < kCols; ++p) {
        if (col + p < k) out[p] = acc[q][p];
      }
    }
  }
}

}  // namespace spmm_tile

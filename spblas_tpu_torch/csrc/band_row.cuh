// The band-panel row kernel, shared by band_spmv.cu (one SpMV) and
// band_power.cu (y = A^iters x, one launch per iteration): warp per panel
// row, y[row] = sum_c panels[row, c] * xp[(row / 128) * 128 + c].
//
// Panel row r belongs to row block blk = r / 128, and panel column c
// holds A[r, blk*128 + c - pad_l]; x arrives pre-padded by pad_l as xp,
// so the row's window is xp[blk*128 .. blk*128 + W).  The 32 lanes stride
// over the W columns, so each load instruction of the warp reads
// consecutive panel and window addresses (coalesced); the f32 sum
// finishes with a __shfl_down_sync tree.  x is read straight from global
// memory (the window of one block is shared by its 128 rows, so L1/L2
// serve the re-reads), which lets any W work.  Every output row has
// exactly one writer: no atomics.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace band {

constexpr int kRowsPerBlock = 128;   // panel rows per row block
constexpr int kThreads = 256;        // 8 warps, 8 panel rows per CUDA block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void row_kernel(const T* __restrict__ panels,
                           const float* __restrict__ xp,
                           float* __restrict__ y, int rows, int w) {
  // 64-bit: blockIdx.x * kThreads overflows 32 bits past 2^27 rows
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* prow = panels + row * w;
  const float* xwin = xp + (row / kRowsPerBlock) * kRowsPerBlock;
  float acc = 0.f;
  for (int c = lane; c < w; c += 32) {
    acc += to_float(prow[c]) * xwin[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) y[row] = acc;
}

// One launch of row_kernel over `rows` panel rows on `stream`; returns
// cudaGetLastError().
template <typename T>
int launch_rows(const T* panels, const float* xp, float* y, int rows, int w,
                cudaStream_t stream) {
  const int warps_per_block = kThreads / 32;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  if (blocks > 0) {
    row_kernel<T><<<blocks, kThreads, 0, stream>>>(panels, xp, y, rows, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band

// Band-panel SpMV for Hopper: y = A·x over dense (128, W) band panels.
//
// Replaces the TPU kernel spblas_tpu/kernels/banded.py::_spmv_kernel
// (pl.pallas_call in band_spmv_padded).  Panel row r belongs to row block
// blk = r / 128, and panel column c holds A[r, blk*128 + c - pad_l]; x
// arrives pre-padded by pad_l as xp, so the row's window is
// xp[blk*128 .. blk*128 + W).
//
// What bounds it on the H100: bytes.  Every panel element is read once
// (2 flops each), so the kernel streams rows*W*sizeof(T) bytes of panels
// plus xp and y; at the headline shape (409,600 rows, W = 232, f32) that
// is 380 MB, about 114 us at 3.35 TB/s.
//
// Design: one warp per panel row.  The 32 lanes stride over the W
// columns, so each load instruction of the warp reads consecutive panel
// and window addresses (coalesced); the f32 sum finishes with a
// __shfl_down_sync tree.  x is read straight from global memory (the
// window of one block is shared by its 128 rows, so L1/L2 serve the
// re-reads), which lets any W work; staging the window in shared memory
// is later work.  Every output row has exactly one writer: no atomics,
// and no reliance on the TPU's in-order grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRowsPerBlock = 128;   // panel rows per row block
constexpr int kThreads = 256;        // 8 warps, 8 panel rows per CUDA block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void band_spmv_kernel(const T* __restrict__ panels,
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

template <typename T>
int launch(const void* panels, const void* xp, void* y, int rows, int w,
           void* stream) {
  const int warps_per_block = kThreads / 32;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  if (blocks > 0) {
    band_spmv_kernel<T><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(panels), static_cast<const float*>(xp),
        static_cast<float*>(y), rows, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// panels: (rows, w) f32 or bf16, row-major; xp: f32 of length
// >= rows - 128 + w; y: (rows,) f32.  rows is a multiple of 128.
extern "C" int band_spmv_f32(const void* panels, const void* xp, void* y,
                             int rows, int w, void* stream) {
  return launch<float>(panels, xp, y, rows, w, stream);
}

extern "C" int band_spmv_bf16(const void* panels, const void* xp, void* y,
                              int rows, int w, void* stream) {
  return launch<__nv_bfloat16>(panels, xp, y, rows, w, stream);
}

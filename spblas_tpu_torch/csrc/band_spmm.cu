// Band-panel SpMM for Hopper: C = A·B over dense (128, W) band panels.
//
// Two entry points with one result:
//   band_spmm_{f32,bf16}         replaces spblas_tpu/kernels/banded.py::
//                                _spmm_kernel (pl.pallas_call in
//                                band_spmm_padded; B resident in VMEM);
//   band_spmm_stream_{f32,bf16}  replaces banded.py::_spmm_stream_kernel
//                                (pl.pallas_call in band_spmm_stream; B
//                                super-windows streamed HBM->VMEM).
// Panel row r belongs to row block blk = r / 128, and panel column c
// holds A[r, blk*128 + c - pad_l]; B arrives pre-padded by pad_l as Bp
// (L = rows - 128 + W rows, k columns), so
//   C[r, j] = sum_c panels[r, c] * Bp[blk*128 + c, j].
// Each row block is a dense (128 x W) by (W x k) product.
//
// What bounds it on the H100: operations.  2*rows*W*k flops against
// rows*W panel values and (rows + W)*k values of B: at the bench's
// spmm_banded shape (409,600 rows, W = 232, k = 256) that is 48.7 GFLOP,
// 0.73 ms at the 67 TFLOP/s f32 peak, against 0.36 ms for the bytes.
// Both kernels compute in f32 FMAs (the TPU kernels' dots run at
// Precision.HIGHEST, so no TF32 tensor cores here).
//
// Design.  Each thread owns an 8-row by 4-column register tile
// (spmm_tile.cuh); 256 threads cover 128 rows by 64 columns.  The panel
// block is staged 32 columns at a time into shared memory, transposed,
// so a thread reads its 8 A values as two 16-byte broadcasts.
//   resident: one CTA per (row block, 64-column k-tile); B rows are read
//     straight from global memory and L2 (each B value is read by the 16
//     row groups of the CTA, which L1 serves).  The k-tile index varies
//     fastest over the grid, so the CTAs sharing a panel block run
//     together and share its reads in L2.
//   stream: one CTA per row block, looping over every k-tile; the B
//     window's 32-row chunks are copied into shared memory with cp.async,
//     double-buffered: the chunk after the current one is in flight while
//     the current one is multiplied.  No state passes between CTAs (the
//     TPU kernel's cross-program double buffer relies on its in-order
//     grid, which Hopper does not have).
// Every C element has exactly one writer: no atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "spmm_tile.cuh"

namespace {

using namespace spmm_tile;

constexpr int kBlockRows = 128;            // panel rows per row block
constexpr int kThreads = 256;
constexpr int kTileCols = 64;              // C columns per k-tile
constexpr int kChunk = 32;                 // panel columns per stage
constexpr int kStrideA = kBlockRows + 4;   // padded, 16-byte aligned rows
constexpr int kColGroups = kTileCols / kCols;   // 16

// sA[cc * kStrideA + r] = panels[r0 + r, c0 + cc] (0 past W)
template <typename T>
__device__ __forceinline__ void stage_panels(const T* __restrict__ panels,
                                             long long r0, int w, int c0,
                                             float* sA) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kBlockRows * kChunk; idx += kThreads) {
    const int r = idx / kChunk, cc = idx % kChunk;
    const int c = c0 + cc;
    sA[cc * kStrideA + r] =
        c < w ? to_float(panels[(r0 + r) * w + c]) : 0.f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
band_spmm_resident(const T* __restrict__ panels, const float* __restrict__ bp,
                   float* __restrict__ c, int w, int k, int ktiles) {
  __shared__ __align__(16) float sA[kChunk * kStrideA];
  const long long blk = blockIdx.x / ktiles;
  const int kt = blockIdx.x % ktiles;
  const int tx = threadIdx.x % kColGroups, ty = threadIdx.x / kColGroups;
  const long long r0 = blk * kBlockRows;
  const long long col = static_cast<long long>(kt) * kTileCols + tx * kCols;
  float acc[kRows][kCols];
  zero_tile(acc);
  for (int c0 = 0; c0 < w; c0 += kChunk) {
    __syncthreads();
    stage_panels(panels, r0, w, c0, sA);
    __syncthreads();
    const int n = min(kChunk, w - c0);
    const float* brow = bp + (r0 + c0) * k;
#pragma unroll 4
    for (int cc = 0; cc < n; ++cc) {
      float a[kRows], b[kCols];
      load_a(sA + cc * kStrideA + ty * kRows, a);
      load_b<float, VEC>(brow + static_cast<long long>(cc) * k, col, k, b);
      fma_tile(acc, a, b);
    }
  }
  store_tile<float, VEC>(c, r0 + ty * kRows, kRows, col, k, acc);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? bytes : 0;   // src-size 0: the copy fills zeros
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
  }
}

// sB[cc * 64 + j] = bp[(r0 + c0 + cc) * k + kt*64 + j] for cc < 32 rows
// of the window (0 past W or past k), in flight until the group is
// waited for
template <bool VEC>
__device__ __forceinline__ void fetch_b(const float* __restrict__ bp,
                                        long long r0, int w, int k, int c0,
                                        int kt, float* sB) {
  const long long col0 = static_cast<long long>(kt) * kTileCols;
  if constexpr (VEC) {
    for (int idx = threadIdx.x; idx < kChunk * kColGroups; idx += kThreads) {
      const int cc = idx / kColGroups, j = (idx % kColGroups) * 4;
      const bool in = c0 + cc < w && col0 + j < k;
      const float* src = in ? bp + (r0 + c0 + cc) * k + col0 + j : bp;
      cp_async(sB + cc * kTileCols + j, src, 16, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < kChunk * kTileCols; idx += kThreads) {
      const int cc = idx / kTileCols, j = idx % kTileCols;
      const bool in = c0 + cc < w && col0 + j < k;
      const float* src = in ? bp + (r0 + c0 + cc) * k + col0 + j : bp;
      cp_async(sB + cc * kTileCols + j, src, 4, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
band_spmm_stream(const T* __restrict__ panels, const float* __restrict__ bp,
                 float* __restrict__ c, int w, int k, int ktiles) {
  __shared__ __align__(16) float sA[kChunk * kStrideA];
  __shared__ __align__(16) float sB[2][kChunk * kTileCols];
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlockRows;
  const int tx = threadIdx.x % kColGroups, ty = threadIdx.x / kColGroups;
  const int nchunks = (w + kChunk - 1) / kChunk;
  const int stages = nchunks * ktiles;
  float acc[kRows][kCols];
  zero_tile(acc);
  fetch_b<VEC>(bp, r0, w, k, 0, 0, sB[0]);
  for (int s = 0; s < stages; ++s) {
    const int kt = s / nchunks, ch = s % nchunks, c0 = ch * kChunk;
    const int buf = s & 1;
    if (s + 1 < stages) {
      const int s1 = s + 1;
      fetch_b<VEC>(bp, r0, w, k, (s1 % nchunks) * kChunk, s1 / nchunks,
                   sB[buf ^ 1]);
    }
    stage_panels(panels, r0, w, c0, sA);
    if (s + 1 < stages) {
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int n = min(kChunk, w - c0);
    const float* sb = sB[buf];
#pragma unroll 4
    for (int cc = 0; cc < n; ++cc) {
      float a[kRows], b[kCols];
      load_a(sA + cc * kStrideA + ty * kRows, a);
      const float4 v = *reinterpret_cast<const float4*>(
          sb + cc * kTileCols + tx * kCols);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
      fma_tile(acc, a, b);
    }
    if (ch == nchunks - 1) {
      store_tile<float, VEC>(c, r0 + ty * kRows, kRows,
                             static_cast<long long>(kt) * kTileCols
                                 + tx * kCols, k, acc);
      zero_tile(acc);
    }
    __syncthreads();   // sA and sB[buf] are rewritten next
  }
}

template <typename T>
int launch(bool stream_b, const void* panels, const void* bp, void* c,
           int rows, int w, int k, int vec, void* stream) {
  const int nblk = rows / kBlockRows;
  const int ktiles = (k + kTileCols - 1) / kTileCols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(panels);
  const float* b = static_cast<const float*>(bp);
  float* out = static_cast<float*>(c);
  if (nblk > 0 && k > 0) {
    if (stream_b) {
      if (vec) {
        band_spmm_stream<T, true><<<nblk, kThreads, 0, st>>>(p, b, out, w, k,
                                                             ktiles);
      } else {
        band_spmm_stream<T, false><<<nblk, kThreads, 0, st>>>(p, b, out, w,
                                                              k, ktiles);
      }
    } else {
      const long long grid = static_cast<long long>(nblk) * ktiles;
      if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      if (vec) {
        band_spmm_resident<T, true><<<static_cast<unsigned>(grid), kThreads,
                                      0, st>>>(p, b, out, w, k, ktiles);
      } else {
        band_spmm_resident<T, false><<<static_cast<unsigned>(grid),
                                       kThreads, 0, st>>>(p, b, out, w, k,
                                                          ktiles);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// panels: (rows, w) f32 or bf16, row-major, rows a multiple of 128;
// bp: (>= rows - 128 + w, k) f32 row-major; c: (rows, k) f32.  vec != 0
// when k is a multiple of 4 and bp and c are 16-byte aligned.
extern "C" int band_spmm_f32(const void* panels, const void* bp, void* c,
                             int rows, int w, int k, int vec, void* stream) {
  return launch<float>(false, panels, bp, c, rows, w, k, vec, stream);
}

extern "C" int band_spmm_bf16(const void* panels, const void* bp, void* c,
                              int rows, int w, int k, int vec,
                              void* stream) {
  return launch<__nv_bfloat16>(false, panels, bp, c, rows, w, k, vec,
                               stream);
}

extern "C" int band_spmm_stream_f32(const void* panels, const void* bp,
                                    void* c, int rows, int w, int k, int vec,
                                    void* stream) {
  return launch<float>(true, panels, bp, c, rows, w, k, vec, stream);
}

extern "C" int band_spmm_stream_bf16(const void* panels, const void* bp,
                                     void* c, int rows, int w, int k,
                                     int vec, void* stream) {
  return launch<__nv_bfloat16>(true, panels, bp, c, rows, w, k, vec, stream);
}

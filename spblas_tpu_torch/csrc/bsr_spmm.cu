// BSR SpMM for Hopper: C = A·B with A stored as dense (bh, bw) blocks and
// B dense (n, k), row-major.
//
// Replaces the TPU kernel spblas_tpu/kernels/bsr_pallas.py::
// _bsr_spmm_kernel (pl.pallas_call in bsr_spmm):
//   C[i*bh + r, j] = sum_e sum_c values[e, r, c] * B[colind[e]*bw + c, j]
// over the blocks e in [rowptr[i], rowptr[i+1]) of block row i.  Blocks
// past the stored count (capacity padding) are never reached.
//
// What bounds it on the H100: at k = 256, operations (2*bh*bw*k flops a
// block against one block and a (bw, k) slice of B, which other block
// rows read again); the sums are f32 (or f64) FMAs, as the TPU kernel
// dots at Precision.HIGHEST, so no TF32 tensor cores.
//
// Design.  A CTA is (one block row, a chunk of 8*RG of its rows, a
// k-tile of 256 columns), with 64 x RG threads (RG = 1 at bh = 8, up to 4
// at bh >= 32); each thread owns an 8-row by 4-column register tile
// (spmm_tile.cuh).  For each block of the row, 32 of its columns at a
// time are staged in shared memory, transposed, so a thread reads its 8
// A values as broadcasts, and each thread reads its 4 B values of a row
// of the B slice (16 bytes, coalesced along k across the warp).  The
// k-tile varies fastest over the grid.  An empty block row writes zeros
// (the output comes from torch.empty).  Every C element has exactly one
// writer: no atomics.  Any bh, bw and k; f32 and f64 instantiations.

#include <cuda_runtime.h>

#include "spmm_tile.cuh"

namespace {

using namespace spmm_tile;

constexpr int kColThreads = 64;                  // threads along k
constexpr int kTileCols = kColThreads * kCols;   // 256 columns a CTA
constexpr int kChunk = 32;                       // block columns a stage
constexpr int kMaxRowGroups = 4;
constexpr int kStrideA = kRows * kMaxRowGroups + 4;   // 36, 16-byte rows

template <typename T, bool VEC>
__global__ void __launch_bounds__(kColThreads * kMaxRowGroups)
bsr_spmm_kernel(const T* __restrict__ values, const int* __restrict__ rowptr,
                const int* __restrict__ colind, const T* __restrict__ b,
                T* __restrict__ c, int bh, int bw, int k, int rchunks,
                int ktiles) {
  __shared__ __align__(16) T sA[kChunk * kStrideA];
  const int rg = blockDim.y;
  const int tile_rows = kRows * rg;
  const int nthreads = kColThreads * rg;
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  const int kt = blockIdx.x % ktiles;
  const long long rest = blockIdx.x / ktiles;
  const int rc = static_cast<int>(rest % rchunks);
  const long long i = rest / rchunks;
  const int r0 = rc * tile_rows;                 // first row in the block
  const int my_r = r0 + threadIdx.y * kRows;     // this thread's first row
  const long long col =
      static_cast<long long>(kt) * kTileCols + threadIdx.x * kCols;
  const int lo = rowptr[i], hi = rowptr[i + 1];
  T acc[kRows][kCols];
  zero_tile(acc);
  for (int e = lo; e < hi; ++e) {
    const T* blk = values + static_cast<long long>(e) * bh * bw;
    const T* bsl = b + static_cast<long long>(colind[e]) * bw * k;
    for (int c0 = 0; c0 < bw; c0 += kChunk) {
      __syncthreads();
      // sA[cc * kStrideA + rr] = blk[r0 + rr, c0 + cc] (0 outside)
      for (int idx = tid; idx < tile_rows * kChunk; idx += nthreads) {
        const int rr = idx / kChunk, cc = idx % kChunk;
        const int r = r0 + rr, cb = c0 + cc;
        sA[cc * kStrideA + rr] =
            (r < bh && cb < bw) ? blk[static_cast<long long>(r) * bw + cb]
                                : T(0);
      }
      __syncthreads();
      const int n = min(kChunk, bw - c0);
#pragma unroll 4
      for (int cc = 0; cc < n; ++cc) {
        T a[kRows], bv[kCols];
        load_a(sA + cc * kStrideA + threadIdx.y * kRows, a);
        load_b<T, VEC>(bsl + static_cast<long long>(c0 + cc) * k, col, k,
                       bv);
        fma_tile(acc, a, bv);
      }
    }
  }
  if (my_r < bh) {
    store_tile<T, VEC>(c, i * bh + my_r, min(kRows, bh - my_r), col, k,
                       acc);
  }
}

template <typename T>
int launch(const void* values, const void* rowptr, const void* colind,
           const void* b, void* c, int mb, int bh, int bw, int k, int vec,
           void* stream) {
  const int rg = min(kMaxRowGroups, (bh + kRows - 1) / kRows);
  const int rchunks = (bh + kRows * rg - 1) / (kRows * rg);
  const int ktiles = (k + kTileCols - 1) / kTileCols;
  const long long grid = static_cast<long long>(mb) * rchunks * ktiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    const dim3 threads(kColThreads, rg);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T* v = static_cast<const T*>(values);
    const int* rp = static_cast<const int*>(rowptr);
    const int* ci = static_cast<const int*>(colind);
    const T* bb = static_cast<const T*>(b);
    T* out = static_cast<T*>(c);
    if (vec) {
      bsr_spmm_kernel<T, true><<<static_cast<unsigned>(grid), threads, 0,
                                 st>>>(v, rp, ci, bb, out, bh, bw, k,
                                       rchunks, ktiles);
    } else {
      bsr_spmm_kernel<T, false><<<static_cast<unsigned>(grid), threads, 0,
                                  st>>>(v, rp, ci, bb, out, bh, bw, k,
                                        rchunks, ktiles);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: (capacity, bh, bw) row-major; rowptr: (mb + 1,) int32; colind:
// (capacity,) int32; b: (>= ncols * bw, k) row-major; c: (mb * bh, k).
// One dtype for values, b and c.  vec != 0 (f32 only) when k is a
// multiple of 4 and b and c are 16-byte aligned.
extern "C" int bsr_spmm_f32(const void* values, const void* rowptr,
                            const void* colind, const void* b, void* c,
                            int mb, int bh, int bw, int k, int vec,
                            void* stream) {
  return launch<float>(values, rowptr, colind, b, c, mb, bh, bw, k, vec,
                       stream);
}

extern "C" int bsr_spmm_f64(const void* values, const void* rowptr,
                            const void* colind, const void* b, void* c,
                            int mb, int bh, int bw, int k, int vec,
                            void* stream) {
  return launch<double>(values, rowptr, colind, b, c, mb, bh, bw, k, 0,
                        stream);
}

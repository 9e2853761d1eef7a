// Block SpGEMM numeric for Hopper: C = A·B with A, B and C stored as dense
// blocks (BSR), over the pair lists of the block-symbolic phase
// (spblas_tpu_torch/kernels/bsr_spgemm.py):
//   C[e] = sum over t in [pair_ptr[e], pair_ptr[e+1]) of
//          A[pair_a[t]] (bh, bk) @ B[pair_b[t]] (bk, bw).
//
// Replaces the TPU kernel spblas_tpu/kernels/bsr_spgemm.py::
// _numeric_kernel (pl.pallas_call in bsr_spgemm_numeric), which runs one
// grid program per C block and double-buffers the pair blocks through
// VMEM by DMA onto the MXU.
//
// What bounds it on the H100: operations, 2*bh*bk*bw flops a pair
// against two blocks read (each A and B block is read by every pair that
// names it, through L2).  The TPU dot runs at Precision.HIGHEST, so the
// sums are f32 (or f64) FMAs: no TF32 or 1xTF32 tensor-core path.
//
// Design.  A CTA is (one C block, a chunk of 8*RG of its rows, a tile of
// 128 of its columns), with 32 x RG threads (RG = 1 at bh = 8, up to 8
// at bh >= 64); each thread owns an 8-row by 4-column register tile
// (spmm_tile.cuh's FMA tile).  The pair loop and each pair's depth, KC
// at a time (16 in f32, 8 in f64), form one sequence of stages; stage
// s+1's A slice (rows by KC) and B slice (KC by 128) are copied into
// shared memory with cp.async while stage s is computed (two buffers).
// A thread reads its 8 A values as warp-wide broadcasts (a warp shares
// its rows) and its 4 B values from one shared row.  Rows, depths and
// columns past the block's edge are zero-filled by the copy (src-size
// 0), so any bh, bk and bw work; 16-byte copies are used where bk and bw
// allow (VEC), 4- or 8-byte ones elsewhere.  One CTA writes each C
// element once: no atomics.  f32 and f64 instantiations.

#include <cuda_runtime.h>

#include "spmm_tile.cuh"

namespace {

using namespace spmm_tile;

constexpr int kColThreads = 32;                  // threads along bw
constexpr int kTileCols = kColThreads * kCols;   // 128 columns a CTA
constexpr int kMaxRowGroups = 8;
constexpr int kTileRowsMax = kRows * kMaxRowGroups;   // 64 rows a CTA

template <typename T>
struct Stage;
template <>
struct Stage<float> {
  static constexpr int kDepth = 16;   // depth a stage
  static constexpr int kVec = 4;      // elements a 16-byte copy
};
template <>
struct Stage<double> {
  static constexpr int kDepth = 8;
  static constexpr int kVec = 2;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES), "r"(pred ? BYTES : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kColThreads * kMaxRowGroups)
bsr_spgemm_kernel(const int* __restrict__ pair_ptr,
                  const int* __restrict__ pair_a,
                  const int* __restrict__ pair_b, const T* __restrict__ A,
                  const T* __restrict__ B, T* __restrict__ C, int bh,
                  int bk, int bw, int rchunks, int ctiles) {
  constexpr int KC = Stage<T>::kDepth;
  constexpr int V = VEC ? Stage<T>::kVec : 1;
  __shared__ __align__(16) T sA[2][kTileRowsMax][KC];
  __shared__ __align__(16) T sB[2][KC][kTileCols];

  const int rg = blockDim.y;
  const int tile_rows = kRows * rg;
  const int nthreads = kColThreads * rg;
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  const int ct = blockIdx.x % ctiles;
  const long long rest = blockIdx.x / ctiles;
  const int rc = static_cast<int>(rest % rchunks);
  const long long e = rest / rchunks;
  const int r0 = rc * tile_rows;
  const int c0 = ct * kTileCols;
  const int lo = pair_ptr[e], hi = pair_ptr[e + 1];
  const int kstages = (bk + KC - 1) / KC;
  const long long nst = static_cast<long long>(hi - lo) * kstages;
  const long long a_blk = static_cast<long long>(bh) * bk;
  const long long b_blk = static_cast<long long>(bk) * bw;

  // stage st into buffer buf: A rows [r0, r0 + tile_rows) x depth
  // [k0, k0 + KC), B depth [k0, k0 + KC) x columns [c0, c0 + 128)
  auto load = [&](int buf, long long st) {
    const int t = lo + static_cast<int>(st / kstages);
    const int k0 = static_cast<int>(st % kstages) * KC;
    const T* a = A + pair_a[t] * a_blk;
    const T* b = B + pair_b[t] * b_blk;
    for (int idx = tid; idx < tile_rows * (KC / V); idx += nthreads) {
      const int rr = idx / (KC / V), kk = (idx % (KC / V)) * V;
      const int r = r0 + rr, k = k0 + kk;
      const bool ok = r < bh && k < bk;
      cp_async<static_cast<int>(V * sizeof(T))>(&sA[buf][rr][kk],
                              ok ? a + static_cast<long long>(r) * bk + k : a,
                              ok);
    }
    for (int idx = tid; idx < KC * (kTileCols / V); idx += nthreads) {
      const int kk = idx / (kTileCols / V), cc = (idx % (kTileCols / V)) * V;
      const int k = k0 + kk, c = c0 + cc;
      const bool ok = k < bk && c < bw;
      cp_async<static_cast<int>(V * sizeof(T))>(&sB[buf][kk][cc],
                              ok ? b + static_cast<long long>(k) * bw + c : b,
                              ok);
    }
    cp_commit();
  };

  T acc[kRows][kCols];
  zero_tile(acc);
  const int my_rr = threadIdx.y * kRows;         // first row in the tile
  if (nst > 0) load(0, 0);
  for (long long st = 0; st < nst; ++st) {
    const int buf = static_cast<int>(st & 1);
    if (st + 1 < nst) {
      load(buf ^ 1, st + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      T a[kRows], b[kCols];
#pragma unroll
      for (int q = 0; q < kRows; ++q) a[q] = sA[buf][my_rr + q][kk];
#pragma unroll
      for (int p = 0; p < kCols; ++p)
        b[p] = sB[buf][kk][threadIdx.x * kCols + p];
      fma_tile(acc, a, b);
    }
    __syncthreads();
  }
  const int row = r0 + my_rr;
  if (row < bh) {
    store_tile<T, VEC>(C + e * bh * static_cast<long long>(bw), row,
                       min(kRows, bh - row), c0 + threadIdx.x * kCols, bw,
                       acc);
  }
}

template <typename T>
int launch(const void* pair_ptr, const void* pair_a, const void* pair_b,
           const void* A, const void* B, void* C, int nnzb_c, int bh,
           int bk, int bw, int vec, void* stream) {
  const int rg = min(kMaxRowGroups, (bh + kRows - 1) / kRows);
  const int rchunks = (bh + kRows * rg - 1) / (kRows * rg);
  const int ctiles = (bw + kTileCols - 1) / kTileCols;
  const long long grid = static_cast<long long>(nnzb_c) * rchunks * ctiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    const dim3 threads(kColThreads, rg);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* pp = static_cast<const int*>(pair_ptr);
    const int* pa = static_cast<const int*>(pair_a);
    const int* pb = static_cast<const int*>(pair_b);
    const T* a = static_cast<const T*>(A);
    const T* b = static_cast<const T*>(B);
    T* c = static_cast<T*>(C);
    if (vec) {
      bsr_spgemm_kernel<T, true><<<static_cast<unsigned>(grid), threads, 0,
                                   st>>>(pp, pa, pb, a, b, c, bh, bk, bw,
                                         rchunks, ctiles);
    } else {
      bsr_spgemm_kernel<T, false><<<static_cast<unsigned>(grid), threads, 0,
                                    st>>>(pp, pa, pb, a, b, c, bh, bk, bw,
                                          rchunks, ctiles);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pair_ptr: (nnzb_c + 1,) int32; pair_a, pair_b: (npairs,) int32; A:
// (*, bh, bk), B: (*, bk, bw), C: (nnzb_c, bh, bw), row-major blocks of
// one dtype.  vec != 0 when bk and bw are multiples of the 16-byte
// vector (4 floats, 2 doubles) and A, B, C are 16-byte aligned.
extern "C" int bsr_spgemm_f32(const void* pair_ptr, const void* pair_a,
                              const void* pair_b, const void* A,
                              const void* B, void* C, int nnzb_c, int bh,
                              int bk, int bw, int vec, void* stream) {
  return launch<float>(pair_ptr, pair_a, pair_b, A, B, C, nnzb_c, bh, bk,
                       bw, vec, stream);
}

extern "C" int bsr_spgemm_f64(const void* pair_ptr, const void* pair_a,
                              const void* pair_b, const void* A,
                              const void* B, void* C, int nnzb_c, int bh,
                              int bk, int bw, int vec, void* stream) {
  return launch<double>(pair_ptr, pair_a, pair_b, A, B, C, nnzb_c, bh, bk,
                        bw, vec, stream);
}

// BSR SpMM for Hopper: C = A·B with A stored as dense (bh, bw) blocks and
// B dense (n, k), row-major.
//
// Replaces the TPU kernel spblas_tpu/kernels/bsr_pallas.py::
// _bsr_spmm_kernel (pl.pallas_call in bsr_spmm):
//   C[i*bh + r, j] = sum_e sum_c values[e, r, c] * B[colind[e]*bw + c, j]
// over the blocks e in [rowptr[i], rowptr[i+1]) of block row i.  Blocks
// past the stored count (capacity padding) are never reached, and an
// empty block row writes zeros (the output comes from torch.empty).
//
// What bounds it on the H100: at the block cell (131,072^2, 65,536
// blocks of 8x128, k = 256) 34.4 GFLOP against 0.54 GB of compulsory
// bytes (the blocks, B and C once): 0.51 ms in f32 FMAs at the 67
// TFLOP/s f32 peak, 0.21 ms as a full-f32 product on the TF32 tensor
// cores (three products, tf32_mma.cuh).  The schedule comes first: a
// block row that reads its own (bw, k) slice of B for each of its blocks
// pulls 8.6 GB a call through the L2 (the whole 134 MB of B is the
// working set, past the 50 MB L2), and a k-tile of 64 columns walked in
// order, which keeps one phase's slice of B in the L2, still leaves
// those 8.6 GB of L2 reads.
//
// f32 (tensor cores, two passes from one C call).  Pass 1
// (bsr_spmm_columns) groups the work by block column: one CTA per (block
// column j, k-tile of 64 columns) holds B's (bw, 64) slice of column j
// in shared memory, split once into its TF32 hi and lo parts, and applies
// it to every stored block of that column, in the order of the column
// list (the stored blocks sorted by block column, built once on the card
// and kept on the BSR: formats/bsr.py, BSR.column_order).  So B is read
// and split once a call.  The four k-tiles of a column run next to each
// other, so three of them read the blocks from the L2.  The blocks' rows
// are stacked into one (nj * bh, bw) operand; each of the 8 warps owns 32
// stacked rows by the 64 columns at a time and runs mma.sync.m16n8k8
// TF32 with the 3xTF32 split (tf32_mma.cuh: three products, each step
// folded by an f32 add; accuracy and limits there), the block values
// loaded one step ahead and split as they arrive, k slots t and t + 4 on
// block columns 2t and 2t + 1.  Each block's (bh, k) product goes to its
// own slot of a scratch buffer (a block wider than 128 columns adds its
// later slices to its slot, in order).  Pass 2 (bsr_row_sums) gives every
// C element one owner that sums its block row's slots in block order: an
// empty block row writes zeros.  Bytes a call at the block cell: the
// blocks once from device memory (and three times from the L2), B once,
// the 0.54 GB of slots written and read, C once: about 1.2 GB.  The
// wrapper bounds the slots (kernels/bsr_kernels.py, SPMM_SCRATCH_BYTES,
// 1 GiB): past it a call walks k in column phases of a multiple of the
// 64-column k-tile, each phase its own columns of B and C (ldb, ldc), and
// where one 64-column phase alone passes it, ranges of block rows too.
// A slot's product and a row's order of sums do not change with the
// cut, so a cut call gives the same bits.
// f64, and f32 blocks with values below 2^-112 (bsr_spmm_f32_fma; see
// tf32_mma.cuh, Limits) (bsr_spmm_kernel, FMAs, spmm_tile.cuh): a CTA is
// (one block
// row, a chunk of 8*RG of its rows, a k-tile of 256 columns), with 64 x
// RG threads (RG = 1 at bh = 8, up to 4 at bh >= 32); each thread owns an
// 8-row by 4-column register tile; each block's columns are staged 32 at
// a time in shared memory, transposed.
// Every C element has exactly one writer and a fixed order of sums: no
// atomics, the same bits every run.  Any bh, bw and k.

#include <cuda_runtime.h>

#include <cstdint>

#include "spmm_tile.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace spmm_tile;

constexpr int kColThreads = 64;                  // threads along k
constexpr int kTileCols = kColThreads * kCols;   // 256 columns a CTA
constexpr int kChunk = 32;                       // block columns a stage
constexpr int kMaxRowGroups = 4;
constexpr int kStrideA = kRows * kMaxRowGroups + 4;   // 36, 16-byte rows

template <typename T>
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
        load_b<T, false>(bsl + static_cast<long long>(c0 + cc) * k, col, k,
                         bv);
        fma_tile(acc, a, bv);
      }
    }
  }
  if (my_r < bh) {
    store_tile<T, false>(c, i * bh + my_r, min(kRows, bh - my_r), col, k,
                         acc);
  }
}

template <typename T>
int launch_fma(const void* values, const void* rowptr, const void* colind,
               const void* b, void* c, int mb, int bh, int bw, int k,
               void* stream) {
  const int rg = min(kMaxRowGroups, (bh + kRows - 1) / kRows);
  const int rchunks = (bh + kRows * rg - 1) / (kRows * rg);
  const int ktiles = (k + kTileCols - 1) / kTileCols;
  const long long grid = static_cast<long long>(mb) * rchunks * ktiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    bsr_spmm_kernel<T><<<static_cast<unsigned>(grid), dim3(kColThreads, rg),
                         0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(values), static_cast<const int*>(rowptr),
        static_cast<const int*>(colind), static_cast<const T*>(b),
        static_cast<T*>(c), bh, bw, k, rchunks, ktiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ //
// f32: the tensor-core kernels
// ------------------------------------------------------------------ //

namespace tc {

constexpr int kWarpsM = 8;                 // warps along the stacked rows
constexpr int kWarpsN = 1;                 // and along C's columns
constexpr int kWarpCols = 64;              // C columns a warp
constexpr int kMinBlocks = 2;              // CTAs an SM
constexpr int kNTiles = kWarpCols / 8;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kTileCols = kWarpCols * kWarpsN;   // C columns a CTA (k-tile)
constexpr int kWarpRows = 32;              // stacked rows a warp: two m-tiles
constexpr int kDepth = 128;                // rows of B's slice held at once
constexpr int kStrideB = kTileCols + 4;    // rows 2t, 2t + 1: no conflict
constexpr int kSmemBytes = 2 * kDepth * kStrideB * 4;   // hi and lo
constexpr int kSumThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // src-size 0: the copy fills zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

// B's slice, split once: sHi/sLo[c * kStrideB + jj] = the TF32 hi and lo
// of bsl[q0 + c, col0 + jj] for c < depth, 0 past k and on the rows from
// depth up to the next multiple of 8.  VEC: 16-byte copies (k a multiple
// of 4, B 16-byte aligned), each thread splitting the values it copied.
// Ends with a barrier.
template <bool VEC>
__device__ __forceinline__ void stage_b(const float* __restrict__ bsl,
                                        int q0, int depth, int k,
                                        long long ldb, long long col0,
                                        uint32_t* sHi, uint32_t* sLo) {
  const int rows = (depth + 7) & ~7;
  if constexpr (VEC) {
    constexpr int kPieces = kTileCols / 4;
    for (int idx = threadIdx.x; idx < rows * kPieces; idx += kThreads) {
      const int c = idx / kPieces, jj = (idx % kPieces) * 4;
      const bool in = c < depth && col0 + jj < k;
      cp_async16(sHi + c * kStrideB + jj,
                 in ? bsl + (q0 + c) * ldb + col0 + jj : bsl, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    for (int idx = threadIdx.x; idx < rows * kPieces; idx += kThreads) {
      const int o = (idx / kPieces) * kStrideB + (idx % kPieces) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        tf32::split(__uint_as_float(sHi[o + u]), sHi[o + u], sLo[o + u]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kTileCols; idx += kThreads) {
      const int c = idx / kTileCols, jj = idx % kTileCols;
      const bool in = c < depth && col0 + jj < k;
      const float x = in ? __ldg(bsl + (q0 + c) * ldb + col0 + jj) : 0.f;
      tf32::split(x, sHi[c * kStrideB + jj], sLo[c * kStrideB + jj]);
    }
  }
  __syncthreads();
}

// x[h][v] = row[ca], y[h][v] = row[ca + 1] of the thread's four stacked
// rows (0 past the slice or the stack)
__device__ __forceinline__ void load_step(const float* const (&arow)[2][2],
                                          int ca, int depth, float (&x)[2][2],
                                          float (&y)[2][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float* r = arow[h][v];
      x[h][v] = r != nullptr && ca < depth ? __ldg(r + ca) : 0.f;
      y[h][v] = r != nullptr && ca + 1 < depth ? __ldg(r + ca + 1) : 0.f;
    }
  }
}

// Pass 1, one CTA per (block column j, k-tile): B's slice of column j
// (its bw rows, kTileCols columns) sits in shared memory, split into its
// TF32 hi and lo parts once, and meets every
// stored block of that column, in the order of the column list.  The
// blocks' rows are stacked (nj * bh rows); a warp owns 32 stacked rows
// by kWarpCols columns and writes them into its blocks' partial products
// partial[e] (bh, k).  Fragments (thread g = lane / 4, t = lane % 4):
// the stacked rows m0 + 16h + g (+ 8) at block columns c0 + 2t, c0 + 2t
// + 1 are the mma's A fragment of tile h, B's slice rows c0 + 2t,
// c0 + 2t + 1 at column 8jn + g its B fragment; D comes back as rows g,
// g + 8 at columns 8jn + 2t, + 1.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bsr_spmm_columns(const float* __restrict__ values,
                 const int* __restrict__ col_ptr,
                 const int* __restrict__ col_order,
                 const float* __restrict__ b, float* __restrict__ partial,
                 int bh, int bw, int k, long long ldb, int ktiles) {
  extern __shared__ __align__(16) uint32_t sHi[];
  uint32_t* const sLo = sHi + kDepth * kStrideB;
  const int j = static_cast<int>(blockIdx.x / ktiles);
  const long long col0 =
      static_cast<long long>(blockIdx.x % ktiles) * kTileCols;
  const int first = col_ptr[j], nj = col_ptr[j + 1] - first;
  if (nj == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = lane >> 2, t = lane & 3;
  const long long stacked = static_cast<long long>(nj) * bh;
  const long long ccol = col0 + wn * kWarpCols + 2 * t;   // + 8jn
  const float* bsl = b + static_cast<long long>(j) * bw * ldb;
  for (int q0 = 0; q0 < bw; q0 += kDepth) {   // once for bw <= kDepth
    const int depth = min(kDepth, bw - q0);
    if (q0 > 0) __syncthreads();   // every warp is done with the slice
    stage_b<VEC>(bsl, q0, depth, k, ldb, col0, sHi, sLo);
    const int sb = 2 * t * kStrideB + wn * kWarpCols + g;   // + c0 rows
    for (long long m0 = wm * kWarpRows; m0 < stacked;
         m0 += kWarpsM * kWarpRows) {
      // the thread's stacked rows m0 + 16h + 8v + g: their values from
      // column q0 on (null past the stack)
      const float* arow[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const long long s = m0 + 16 * h + 8 * v + g;
          arow[h][v] = nullptr;
          if (s < stacked) {
            const long long e = col_order[first + s / bh];
            const int rr = static_cast<int>(s % bh);
            const float* blk = values + static_cast<long long>(e) * bh * bw;
            arow[h][v] = blk + static_cast<long long>(rr) * bw + q0;
          }
        }
      }
      float acc[2][kNTiles][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int jn = 0; jn < kNTiles; ++jn) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[h][jn][q] = 0.f;
        }
      }
      // a step's values (x at block column c0 + 2t, y at c0 + 2t + 1),
      // loaded one step ahead
      float x[2][2], y[2][2];
      load_step(arow, 2 * t, depth, x, y);
      for (int c0 = 0; c0 < depth; c0 += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            tf32::split(x[h][v], ahi[h][v], alo[h][v]);          // slot t
            tf32::split(y[h][v], ahi[h][2 + v], alo[h][2 + v]);  // t + 4
          }
        }
        load_step(arow, c0 + 8 + 2 * t, depth, x, y);
#pragma unroll
        for (int jn = 0; jn < kNTiles; ++jn) {
          const int o = sb + c0 * kStrideB + 8 * jn;
          const uint32_t bhi[2] = {sHi[o], sHi[o + kStrideB]};
          const uint32_t blo[2] = {sLo[o], sLo[o + kStrideB]};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tf32::step<true>(acc[h][jn], ahi[h], alo[h], bhi, blo);
          }
        }
      }
      // rows g (d0, d1) and g + 8 (d2, d3) at columns ccol + 8jn, + 1; a
      // later slice of a block wider than kDepth adds to the first
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (arow[h][v] == nullptr) continue;
          // the block row e * bh + rr that arow points into: its slot
          float* p = partial + (arow[h][v] - q0 - values) / bw * k;
#pragma unroll
          for (int jn = 0; jn < kNTiles; ++jn) {
            const long long col = ccol + 8 * jn;
            float d0 = acc[h][jn][2 * v], d1 = acc[h][jn][2 * v + 1];
            if constexpr (VEC) {
              if (col < k) {
                float2* o = reinterpret_cast<float2*>(p + col);
                if (q0 > 0) {
                  const float2 old = *o;
                  d0 = old.x + d0;
                  d1 = old.y + d1;
                }
                *o = make_float2(d0, d1);
              }
            } else {
              if (col < k) p[col] = q0 > 0 ? p[col] + d0 : d0;
              if (col + 1 < k) p[col + 1] = q0 > 0 ? p[col + 1] + d1 : d1;
            }
          }
        }
      }
    }
  }
}

// Pass 2: C[i*bh + r, col .. col + 3] = the sum of partial[e, r, ..] over
// the blocks e of block row i, in their order (0 for an empty row).
template <bool VEC>
__global__ void __launch_bounds__(kSumThreads)
bsr_row_sums(const float* __restrict__ partial,
             const int* __restrict__ rowptr, float* __restrict__ c, int bh,
             int k, long long ldc, long long rows) {
  const int kq = (k + 3) / 4;
  const long long q = static_cast<long long>(blockIdx.x) * kSumThreads
                      + threadIdx.x;
  if (q >= rows * kq) return;
  const long long row = q / kq, col = (q % kq) * 4;
  const long long i = row / bh;
  const int r = static_cast<int>(row % bh);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const int lo = rowptr[i], hi = rowptr[i + 1];
  for (int e = lo; e < hi; ++e) {
    const float* p = partial + (static_cast<long long>(e) * bh + r) * k + col;
    if constexpr (VEC) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
      s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (col + u < k) s[u] += __ldcs(p + u);
      }
    }
  }
  float* out = c + row * ldc + col;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(out) = make_float4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (col + u < k) out[u] = s[u];
    }
  }
}

template <bool VEC>
cudaError_t launch_vec(const float* v, const int* rp, const int* cp,
                       const int* co, const float* bb, float* part,
                       float* out, int mb, int ncb, int bh, int bw, int k,
                       long long ldb, long long ldc, cudaStream_t st) {
  const int ktiles = (k + kTileCols - 1) / kTileCols;
  const long long grid = static_cast<long long>(ncb) * ktiles;
  const long long rows = static_cast<long long>(mb) * bh;
  const long long sums = (rows * ((k + 3) / 4) + kSumThreads - 1)
                         / kSumThreads;
  if (grid > 0x7fffffffLL || sums > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (bw == 0) {   // every product is empty
    return cudaMemset2DAsync(out, ldc * sizeof(float), 0, k * sizeof(float),
                             rows, st);
  }
  if (grid > 0) {
    static bool raised = false;   // the shared-memory limit, once
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          bsr_spmm_columns<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemBytes);
      if (e != cudaSuccess) return e;
      raised = true;
    }
    bsr_spmm_columns<VEC><<<static_cast<unsigned>(grid), kThreads,
                            kSmemBytes, st>>>(v, cp, co, bb, part, bh, bw, k,
                                              ldb, ktiles);
  }
  if (sums > 0) {
    bsr_row_sums<VEC><<<static_cast<unsigned>(sums), kSumThreads, 0, st>>>(
        part, rp, out, bh, k, ldc, rows);
  }
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// values: (capacity, bh, bw) row-major; rowptr: (mb + 1,) int32; colind
// (f64): (capacity,) int32; b: (>= ncb * bw, k) row-major; c: (mb * bh,
// k).  One dtype for values, b and c.  f32 takes, in place of colind, the
// column list (col_ptr: (ncb + 1,) int32 offsets into col_order, the
// stored blocks' indices sorted by block column, stably) and partial:
// (stored blocks, bh, k) f32 scratch, each stored block's slot written by
// pass 1 and read by pass 2; its k columns are a column phase of B and C,
// whose rows are ldb and ldc floats apart (kernels/bsr_kernels.py walks
// the phases).  vec != 0 when k, ldb and ldc are multiples of 4 and b, c
// and partial are 16-byte aligned (f64 ignores it).
extern "C" int bsr_spmm_f32(const void* values, const void* rowptr,
                            const void* col_ptr, const void* col_order,
                            const void* b, void* partial, void* c, int mb,
                            int ncb, int bh, int bw, int k, long long ldb,
                            long long ldc, int vec, void* stream) {
  const float* v = static_cast<const float*>(values);
  const int* rp = static_cast<const int*>(rowptr);
  const int* cp = static_cast<const int*>(col_ptr);
  const int* co = static_cast<const int*>(col_order);
  const float* bb = static_cast<const float*>(b);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? tc::launch_vec<true>(v, rp, cp, co, bb, part, out, mb, ncb, bh,
                                 bw, k, ldb, ldc, st)
          : tc::launch_vec<false>(v, rp, cp, co, bb, part, out, mb, ncb, bh,
                                  bw, k, ldb, ldc, st));
}

// f32 on the FMA kernel (as f64): the route for blocks with nonzero
// values below 2^-112, where the 3xTF32 split keeps fewer bits than f32
// (kernels/bsr_kernels.py, BSR.tf32_exact; tf32_mma.cuh, Limits)
extern "C" int bsr_spmm_f32_fma(const void* values, const void* rowptr,
                                const void* colind, const void* b, void* c,
                                int mb, int bh, int bw, int k, int vec,
                                void* stream) {
  return launch_fma<float>(values, rowptr, colind, b, c, mb, bh, bw, k,
                           stream);
}

extern "C" int bsr_spmm_f64(const void* values, const void* rowptr,
                            const void* colind, const void* b, void* c,
                            int mb, int bh, int bw, int k, int vec,
                            void* stream) {
  return launch_fma<double>(values, rowptr, colind, b, c, mb, bh, bw, k,
                            stream);
}

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
// What bounds it on the H100: at the bench's spmm_banded shape (409,600
// rows, W = 232, k = 256) 48.7 GFLOP against 0.38 GB of panels, 0.42 GB
// of padded B and 0.42 GB of C.  In f32 FMAs that is 0.73 ms of
// operations at the 67 TFLOP/s f32 peak, twice the 0.36 ms of bytes; as
// a full-f32 product on the TF32 tensor cores (three products,
// tf32_mma.cuh) it is 0.30 ms, under the bytes.
//
// resident (band_spmm_*, f32 FMAs, spmm_tile.cuh): one CTA per (row
//   block, 64-column k-tile); each thread owns an 8-row by 4-column
//   register tile; the panel block is staged 32 columns at a time into
//   shared memory, transposed, and B rows are read straight from global
//   memory and L2.  The k-tile index varies fastest over the grid, so the
//   CTAs sharing a panel block run together and share its reads in L2.
// stream (band_spmm_stream_*, tensor cores): one CTA of 4 warps per
//   (row block, k-tile of kCols = 128 columns), the k-tile fastest over
//   the grid, so a panel block is read from device memory once and its
//   second read hits L2.  Panel and B chunks of 32 columns of W arrive
//   through a 3-stage cp.async ring in shared memory (zero-filled past W
//   and past k), one barrier a chunk.  Each warp owns 64 rows by 64
//   columns of C in registers for the whole W loop and runs
//   mma.sync.m16n8k8 TF32 on fragments it splits as it loads them
//   (tf32_mma.cuh: three products for f32 panels, two for bf16, each step
//   folded into the f32 sum by an f32 add).  Within a step, the
//   fragment's k slots t and t + 4 take columns 2t and 2t + 1, so a
//   thread reads its two panel values with one 8-byte load; the padded
//   shared-memory strides make the panel, B and C accesses free of bank
//   conflicts.  C leaves through shared memory in 16-byte stores along
//   its rows.  Accuracy and limits: tf32_mma.cuh.
// Every C element has exactly one writer and a fixed order of sums: no
// atomics, the same bits every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "spmm_tile.cuh"
#include "tf32_mma.cuh"

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

// ------------------------------------------------------------------ //
// stream: the tensor-core kernel
// ------------------------------------------------------------------ //

namespace tc {

constexpr int kWarpsN = 2;                  // warps along C's columns
constexpr int kWarps = 2 * kWarpsN;         // and two along its rows
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = kWarpsN == 2 ? 2 : 1;   // CTAs an SM
constexpr int kCols = 64 * kWarpsN;         // C columns a CTA (the k-tile)
constexpr int kChunk = 32;                  // columns of W a stage
constexpr int kStages = 3;
constexpr int kStrideA = kChunk + 8;        // panel row: 8-byte reads free
constexpr int kStrideB = kCols + 4;         // B row: rows 2t, 2t + 1 free
constexpr int kStrideC = kCols + 8;         // C row: 8-byte writes free
constexpr int kABytes = kBlockRows * kStrideA * 4;   // f32 panels (bf16: half)
constexpr int kBBytes = kChunk * kStrideB * 4;
constexpr int kSmemBytes = kStages * (kABytes + kBBytes);
static_assert(kBlockRows * kStrideC * 4 <= kSmemBytes, "C stage");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // src-size 0: the copy fills zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One stage: sA[r * kStrideA + cc] = panels[r0 + r, c0 + cc] (0 past W)
// and sB[cc * kStrideB + j] = bp[r0 + c0 + cc, col0 + j] (0 past W or
// k).  VA: 16-byte copies of the panels (W a multiple of 16 bytes, the
// panels 16-byte aligned); VB: of B (k a multiple of 4, bp aligned);
// otherwise plain loads and stores, done before the stage's barrier.
template <typename T, bool VA, bool VB>
__device__ __forceinline__ void fetch(const T* __restrict__ panels,
                                      const float* __restrict__ bp,
                                      long long r0, int w, int k,
                                      long long col0, int c0, T* sA,
                                      float* sB) {
  if constexpr (VA) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPieces = kChunk / kVec;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kBlockRows * kPieces;
         idx += kThreads) {
      const int r = idx / kPieces, cc = (idx % kPieces) * kVec;
      const int c = c0 + cc;
      const bool in = c < w;
      cp_async16(sA + r * kStrideA + cc,
                 in ? panels + (r0 + r) * w + c : panels, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBlockRows * kChunk; idx += kThreads) {
      const int r = idx / kChunk, cc = idx % kChunk;
      const int c = c0 + cc;
      sA[r * kStrideA + cc] = c < w ? panels[(r0 + r) * w + c] : T{};
    }
  }
  if constexpr (VB) {
    constexpr int kPieces = kCols / 4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kChunk * kPieces; idx += kThreads) {
      const int cc = idx / kPieces, j = (idx % kPieces) * 4;
      const bool in = c0 + cc < w && col0 + j < k;
      cp_async16(sB + cc * kStrideB + j,
                 in ? bp + (r0 + c0 + cc) * k + col0 + j : bp, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < kChunk * kCols; idx += kThreads) {
      const int cc = idx / kCols, j = idx % kCols;
      const bool in = c0 + cc < w && col0 + j < k;
      sB[cc * kStrideB + j] =
          in ? __ldg(bp + (r0 + c0 + cc) * k + col0 + j) : 0.f;
    }
  }
}

// panel values (x at column 2t, y at 2t + 1 of a step) as floats
__device__ __forceinline__ float2 load_pair(const float* s) {
  return *reinterpret_cast<const float2*>(s);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* s) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
}

template <typename T, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
band_spmm_tc(const T* __restrict__ panels, const float* __restrict__ bp,
             float* __restrict__ c, int w, int k, int ktiles) {
  constexpr bool kSplitA = std::is_same<T, float>::value;   // bf16: exact
  extern __shared__ __align__(16) unsigned char smem[];
  T* const sA0 = reinterpret_cast<T*>(smem);
  float* const sB0 = reinterpret_cast<float*>(smem + kStages * kABytes);
  constexpr int kAStage = kBlockRows * kStrideA;   // elements a stage
  constexpr int kBStage = kChunk * kStrideB;
  const long long r0 = static_cast<long long>(blockIdx.x / ktiles)
                       * kBlockRows;
  const long long col0 = static_cast<long long>(blockIdx.x % ktiles) * kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 1, wn = warp >> 1;   // 64-row, 64-column quarter
  const int g = lane >> 2, t = lane & 3;     // fragment group, slot
  const int nchunks = (w + kChunk - 1) / kChunk;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) {
      fetch<T, VA, VB>(panels, bp, r0, w, k, col0, s * kChunk,
                       sA0 + s * kAStage, sB0 + s * kBStage);
    }
    commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    wait_group<kStages - 2>();
    __syncthreads();   // chunk ch landed; chunk ch - 1's buffer is free
    const int nx = ch + kStages - 1;
    if (nx < nchunks) {
      const int nb = nx % kStages;
      fetch<T, VA, VB>(panels, bp, r0, w, k, col0, nx * kChunk,
                       sA0 + nb * kAStage, sB0 + nb * kBStage);
    }
    commit();
    const int buf = ch % kStages;
    // this thread's panel rows wm*64 + 16i + g (+ 8) at columns 2t, 2t+1
    // of each step; its B rows 2t, 2t + 1 at column wn*64 + 8j + g
    const T* sa = sA0 + buf * kAStage + (wm * 64 + g) * kStrideA + 2 * t;
    const float* sb = sB0 + buf * kBStage + 2 * t * kStrideB + wn * 64 + g;
    const int steps = min(kChunk, w - ch * kChunk + 7) / 8;
#pragma unroll
    for (int s = 0; s < kChunk / 8; ++s) {
      if (s >= steps) break;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 top = load_pair(sa + i * 16 * kStrideA + 8 * s);
        const float2 bot = load_pair(sa + (i * 16 + 8) * kStrideA + 8 * s);
        const float v[4] = {top.x, bot.x, top.y, bot.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (kSplitA) {
            tf32::split(v[q], ahi[i][q], alo[i][q]);
          } else {
            ahi[i][q] = __float_as_uint(v[q]);
            alo[i][q] = 0u;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bhi[2], blo[2];
        tf32::split(sb[8 * s * kStrideB + 8 * j], bhi[0], blo[0]);
        tf32::split(sb[(8 * s + 1) * kStrideB + 8 * j], bhi[1], blo[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tf32::step<kSplitA>(acc[i][j], ahi[i], alo[i], bhi, blo);
        }
      }
    }
  }
  wait_group<0>();
  __syncthreads();   // every warp is done with the ring: C reuses it
  float* const sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* o = sC + (wm * 64 + i * 16 + g) * kStrideC + wn * 64 + j * 8
                 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(o + 8 * kStrideC) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  __syncthreads();
  constexpr int kPieces = kCols / 4;
  for (int idx = threadIdx.x; idx < kBlockRows * kPieces; idx += kThreads) {
    const int r = idx / kPieces, j = (idx % kPieces) * 4;
    const long long col = col0 + j;
    if (col >= k) continue;
    const float4 v = *reinterpret_cast<const float4*>(sC + r * kStrideC + j);
    float* out = c + (r0 + r) * k + col;
    if constexpr (VB) {
      *reinterpret_cast<float4*>(out) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (col + p < k) out[p] = e[p];
      }
    }
  }
}

template <typename T, bool VA, bool VB>
cudaError_t launch_tc(unsigned grid, const T* p, const float* b, float* out,
                      int w, int k, int ktiles, cudaStream_t st) {
  static bool raised = false;   // the shared-memory limit, once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_spmm_tc<T, VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  band_spmm_tc<T, VA, VB><<<grid, kThreads, kSmemBytes, st>>>(p, b, out, w,
                                                              k, ktiles);
  return cudaSuccess;
}

}  // namespace tc

template <typename T>
int launch(bool stream_b, const void* panels, const void* bp, void* c,
           int rows, int w, int k, int vec, void* stream) {
  const int nblk = rows / kBlockRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(panels);
  const float* b = static_cast<const float*>(bp);
  float* out = static_cast<float*>(c);
  if (nblk <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (stream_b) {
    const int ktiles = (k + tc::kCols - 1) / tc::kCols;
    const long long grid = static_cast<long long>(nblk) * ktiles;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned g = static_cast<unsigned>(grid);
    // 16-byte panel copies need whole 16-byte rows from an aligned base
    const bool va = w % (16 / static_cast<int>(sizeof(T))) == 0
                    && reinterpret_cast<uintptr_t>(panels) % 16 == 0;
    cudaError_t e;
    if (va && vec) {
      e = tc::launch_tc<T, true, true>(g, p, b, out, w, k, ktiles, st);
    } else if (va) {
      e = tc::launch_tc<T, true, false>(g, p, b, out, w, k, ktiles, st);
    } else if (vec) {
      e = tc::launch_tc<T, false, true>(g, p, b, out, w, k, ktiles, st);
    } else {
      e = tc::launch_tc<T, false, false>(g, p, b, out, w, k, ktiles, st);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    const int ktiles = (k + kTileCols - 1) / kTileCols;
    const long long grid = static_cast<long long>(nblk) * ktiles;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (vec) {
      band_spmm_resident<T, true><<<static_cast<unsigned>(grid), kThreads,
                                    0, st>>>(p, b, out, w, k, ktiles);
    } else {
      band_spmm_resident<T, false><<<static_cast<unsigned>(grid), kThreads,
                                     0, st>>>(p, b, out, w, k, ktiles);
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

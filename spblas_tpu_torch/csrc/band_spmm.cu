// Band-panel SpMM for Hopper: C = A·B over dense (128, W) band panels.
//
// Entry points, one product:
//   band_spmm_{f32,bf16}         replaces spblas_tpu/kernels/banded.py::
//                                _spmm_kernel (pl.pallas_call in
//                                band_spmm_padded; B resident in VMEM);
//   band_spmm_cx                 the same kernel over the two panel planes
//                                of a complex band (kernels/plans.py::
//                                band_cx_spmm, four real _spmm_kernel
//                                products in the JAX package) in one pass;
//   band_spmm_stream_{f32,bf16}  replaces banded.py::_spmm_stream_kernel
//                                (pl.pallas_call in band_spmm_stream; B
//                                super-windows streamed HBM->VMEM).
// Panel row r belongs to row block blk = r / 128, and panel column c
// holds A[r, blk*128 + c - pad_l], so
//   C[r, j] = sum_c panels[r, c] * B[blk*128 + c - pad_l, j],
// a dense (128 x W) by (W x k) product per row block.  Every kernel reads
// B where it lies: window row q reads B row q - pad_l, zero outside
// [0, n) (the cp.async zero-fill), so no padded copy of B is made.  The
// resident kernels also take a row index (a permuted band): window row q
// reads B row idx[q - pad_l] (zero where that is >= n) and band row j
// goes to C row idx[j]; C rows at or past m are not written.
//
// resident (band_spmm_*, f32 FMAs, no tensor cores: it is also the exact
//   kernel that the tensor-core one falls back to, BandPlan.tf32_exact).
//   What bounds it on the H100 (67 TFLOP/s f32, 3.35 TB/s): on the
//   permuted headline band (409,600 rows, W 232) at k 64, 12.2 GFLOP
//   (0.182 ms) against 0.59 GB of panels, B and C (0.176 ms): both; at
//   k 256, 48.7 GFLOP (0.726 ms) against 1.22 GB (0.364 ms): the FMAs;
//   the complex band at k 32 (100,352 rows, W 144, 8 flops a complex
//   pair), 3.7 GFLOP (0.055 ms) against 0.17 GB (0.051 ms): both.  So
//   the FMA loop has to run near its peak, fed from shared memory only:
//   one CTA of 4 warps per (row block, k-tile of 64 B floats, or 32
//   where a B row holds no more), the k-tile fastest over the grid so
//   that a row block's panels come from device memory once.  Panel
//   chunks (128 rows x 16 columns of W, row-major as they lie, bf16 as
//   it lies) and the matching 16 B rows of the k-tile arrive through a
//   3-stage cp.async ring (16-byte copies where the rows allow, else
//   4-byte ones; zero-filled past W, past k and past B's rows), one
//   barrier a chunk.  The copy loops have trip counts fixed at compile
//   time and a thread's pieces lie at a fixed stride, and B's source
//   rows (through the row index, when there is one) are resolved a chunk
//   ahead, so the index loads are in flight while the FMAs run: the
//   copies' address arithmetic, not shared memory, was what held an
//   earlier form of the loop back.  A thread owns rows ty + 16 i (i < 8)
//   and two 4-column groups (4 tx and 32 + 4 tx) of C: 64 accumulators.
//   For four steps of W it reads one 16-byte float4 (8 bytes of bf16,
//   widened exactly) per row and two float4 of B per step, 16 shared
//   loads for 256 FMAs; the padded panel stride puts the four rows a
//   warp reads on distinct banks, and the 8 threads of a quarter-warp
//   read one 128-byte B row segment.  Whole chunks run (zeros past W
//   add nothing), so the step loop has no early exit and its loads
//   schedule freely.  C leaves from registers in 16-byte stores along
//   its rows.  The complex pass stages both planes side by side and runs
//   four FMAs a complex pair (re += ar br - ai bi, im += ar bi + ai br)
//   into the same 64 accumulators (32 complex entries: B and C
//   interleaved as complex64); with a real B, two products.  Measured
//   against this design (PERF.md): 2 or 4 CTAs an SM, 32-column chunks,
//   4 stages (the kRes* constants), and forms since dropped: 2-step
//   panel loads, the next step group's loads issued first, chunks cut
//   at W.
// stream (band_spmm_stream_*, tensor cores): one CTA of 4 warps per
//   (row block, k-tile of kCols = 128 columns), the k-tile fastest over
//   the grid, so a panel block is read from device memory once and its
//   second read hits L2.  Panel and B chunks of 32 columns of W arrive
//   through a 3-stage cp.async ring in shared memory (zero-filled past
//   W, past k and past B's rows), one barrier a chunk.  Each warp owns
//   64 rows by 64 columns of C in registers for the whole W loop and runs
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

#include "tf32_mma.cuh"

namespace {

constexpr int kBlockRows = 128;            // panel rows per row block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // src-size 0: the copy fills zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ------------------------------------------------------------------ //
// resident: f32 FMAs
// ------------------------------------------------------------------ //

namespace res {

constexpr int kThreads = 128;              // 4 warps
constexpr int kResBlocks = 3;              // CTAs an SM (170 registers)
constexpr int kRowGroups = 16;             // a thread's rows: ty + 16 i
constexpr int kRowsT = kBlockRows / kRowGroups;   // 8
constexpr int kResChunk = 16;              // columns of W a stage
constexpr int kResStages = 3;

// MODE: kReal, C = P B; kCx, C = (P0 + i P1)(B) with B complex64 (B and
// C rows of interleaved floats); kCxRealB, the same with a real B.
constexpr int kReal = 0, kCx = 1, kCxRealB = 2;

struct Args {
  const void* p0;        // panels (the real plane of a complex band)
  const void* p1;        // the imaginary plane (complex modes)
  const float* b;        // B, kf floats a row, n rows
  const int* idx;        // row index (nullptr: none), rows entries
  float* c;              // C, cf floats a row, m rows
  long long rows;
  int w, kf, cf, n, pad_l, m, ktiles;
  bool va, vb, vc;       // 16-byte panel copies, B copies, C stores
};

// one stage: NP panel planes of 128 x kStride, then kResChunk x KTF floats
// of B.  kStride pads a row by 16 bytes: the 4 rows a warp reads at once
// (ty, ty+1, ty+2, ty+3) land on distinct banks.
template <typename T, int KTF, int MODE>
struct Layout {
  static constexpr int kPlanes = MODE == kReal ? 1 : 2;
  static constexpr int kStride = kResChunk + 16 / static_cast<int>(sizeof(T));
  static constexpr int kPlane = kBlockRows * kStride;          // elements
  static constexpr int kABytes = kPlanes * kPlane * static_cast<int>(
      sizeof(T));
  static constexpr int kStageBytes = kABytes + kResChunk * KTF * 4;
  static constexpr int kSmemBytes = kResStages * kStageBytes;
};

// B row read by window row q (already less pad_l), or -1 for zeros
__device__ __forceinline__ long long b_row(const Args& a, long long q) {
  if (q < 0) return -1;
  if (a.idx != nullptr) {
    if (q >= a.rows) return -1;
    q = __ldg(a.idx + q);
  }
  return q >= 0 && q < a.n ? q : -1;
}

static_assert(kThreads % kResChunk == 0 && kResChunk % 8 == 0
              && kBlockRows % (kThreads / kResChunk) == 0,
              "the ring's copies: whole passes of the threads");

// The B rows a thread copies in 16-byte pieces: stage rows cc + t *
// kRowsPass (t < kCount) at floats j.
template <int KTF>
struct BPieces {
  static constexpr int kPieces = KTF / 4;
  static constexpr int kRowsPass = kThreads / kPieces;
  static constexpr int kCount = kResChunk / kRowsPass;
  static_assert(kCount >= 1 && kResChunk % kRowsPass == 0, "B pieces");
};

// B's source rows for the thread's pieces of the chunk at column c0 (-1:
// zeros), resolved a chunk ahead of its copy so that a row index's loads
// are in flight while the FMAs run
template <int KTF>
__device__ __forceinline__ void b_rows(const Args& a, long long r0, int c0,
                                       int (&src)[BPieces<KTF>::kCount]) {
  using P = BPieces<KTF>;
  const int cc = threadIdx.x / P::kPieces;
#pragma unroll
  for (int t = 0; t < P::kCount; ++t) {
    const int row = cc + t * P::kRowsPass;
    src[t] = c0 + row < a.w
                 ? static_cast<int>(b_row(a, r0 + c0 + row - a.pad_l)) : -1;
  }
}

// One stage.  Every loop has a trip count known at compile time and a
// thread's pieces lie at a fixed stride from its first, so the copies
// cost a few instructions each; src: the 16-byte pieces' B rows.
template <typename T, int KTF, int MODE>
__device__ __forceinline__ void fetch(const Args& a, long long r0,
                                      int col0, int c0,
                                      const int (&src)[BPieces<KTF>::kCount],
                                      unsigned char* stage) {
  using L = Layout<T, KTF, MODE>;
  const int tid = threadIdx.x;
  T* const sa = reinterpret_cast<T*>(stage);
#pragma unroll
  for (int pl = 0; pl < L::kPlanes; ++pl) {
    const T* p = static_cast<const T*>(pl ? a.p1 : a.p0);
    T* s = sa + pl * L::kPlane;
    if (a.va) {
      constexpr int kVec = 16 / static_cast<int>(sizeof(T));
      constexpr int kPieces = kResChunk / kVec;      // 16-byte pieces a row
      constexpr int kRowsPass = kThreads / kPieces;
      const int r = tid / kPieces, cc = (tid % kPieces) * kVec;
      const bool in = c0 + cc < a.w;
      const T* src = p + (r0 + r) * a.w + c0 + cc;
      const long long step = static_cast<long long>(kRowsPass) * a.w;
#pragma unroll
      for (int t = 0; t < kBlockRows / kRowsPass; ++t) {
        cp_async16(s + (r + t * kRowsPass) * L::kStride + cc,
                   in ? src + t * step : p, in);
      }
    } else {
      constexpr int kRowsPass = kThreads / kResChunk;
      const int r = tid / kResChunk, cc = tid % kResChunk;
      const bool in = c0 + cc < a.w;
#pragma unroll 4
      for (int t = 0; t < kBlockRows / kRowsPass; ++t) {
        const long long row = r0 + r + t * kRowsPass;
        s[(r + t * kRowsPass) * L::kStride + cc] =
            in ? p[row * a.w + c0 + cc] : T{};
      }
    }
  }
  float* const sb = reinterpret_cast<float*>(stage + L::kABytes);
  const long long q0 = r0 + c0 - a.pad_l;   // window row of stage row 0
  if (a.vb) {
    using P = BPieces<KTF>;
    const int cc = tid / P::kPieces, j = (tid % P::kPieces) * 4;
#pragma unroll
    for (int t = 0; t < P::kCount; ++t) {
      const bool in = src[t] >= 0 && col0 + j < a.kf;
      cp_async16(sb + (cc + t * P::kRowsPass) * KTF + j,
                 in ? a.b + static_cast<long long>(src[t]) * a.kf + col0 + j
                    : a.b, in);
    }
  } else {
    constexpr int kRowsPass = kThreads / KTF;
    const int cc = tid / KTF, j = tid % KTF;
#pragma unroll 4
    for (int t = 0; t < kResChunk / kRowsPass; ++t) {
      const int row = cc + t * kRowsPass;
      const long long r = c0 + row < a.w ? b_row(a, q0 + row) : -1;
      const bool in = r >= 0 && col0 + j < a.kf;
      cp_async4(sb + row * KTF + j, in ? a.b + r * a.kf + col0 + j : a.b,
                in);
    }
  }
}

// Four steps of one panel row as floats, one shared load (a bf16 value
// is the top half of its f32: the conversion is exact).
__device__ __forceinline__ void load4(const float* s, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* s,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(s);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// acc[i][4 g + p] is C float (goff(g) + p) of row i; KTF 32 real: one
// group; the complex modes: floats of interleaved complex64
template <int KTF, int MODE>
struct Tile {
  static constexpr int kGroups = (MODE == kReal && KTF == 32) ? 1 : 2;
  static __device__ __forceinline__ int goff(int col0, int tx, int g) {
    if constexpr (MODE == kCxRealB) return 2 * col0 + 8 * tx + 4 * g;
    return col0 + 4 * tx + 32 * g;
  }
};

// Four steps of W in registers: the thread's panel values (both planes
// in the complex modes) and B values, and their FMAs into the 8 x 4
// kGroups accumulators, in step order.
template <int KTF, int MODE>
struct Frag {
  static constexpr int kV = 4;
  static constexpr int kBF = KTF == 64 ? 8 : 4;   // B floats a step
  float ar[kRowsT][kV];
  float ai[MODE == kReal ? 1 : kRowsT][kV];
  float b[kV][kBF];

  template <typename T>
  __device__ __forceinline__ void load(const T* sa, const float* sb,
                                       int gw) {
    using L = Layout<T, KTF, MODE>;
#pragma unroll
    for (int i = 0; i < kRowsT; ++i) {
      load4(sa + i * kRowGroups * L::kStride + kV * gw, ar[i]);
      if constexpr (MODE != kReal) {
        load4(sa + L::kPlane + i * kRowGroups * L::kStride + kV * gw,
              ai[i]);
      }
    }
#pragma unroll
    for (int s = 0; s < kV; ++s) {
      const float* brow = sb + (kV * gw + s) * KTF;
#pragma unroll
      for (int h = 0; h < kBF / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(brow + 32 * h);
        b[s][4 * h] = v.x;
        b[s][4 * h + 1] = v.y;
        b[s][4 * h + 2] = v.z;
        b[s][4 * h + 3] = v.w;
      }
    }
  }

  __device__ __forceinline__ void fma(float (&acc)[kRowsT][8]) const {
#pragma unroll
    for (int s = 0; s < kV; ++s) {
#pragma unroll
      for (int i = 0; i < kRowsT; ++i) {
        const float x = ar[i][s];
        if constexpr (MODE == kReal) {
#pragma unroll
          for (int j = 0; j < kBF; ++j) {
            acc[i][j] = fmaf(x, b[s][j], acc[i][j]);
          }
        } else if constexpr (MODE == kCx) {
          const float y = ai[i][s];
#pragma unroll
          for (int q = 0; q < 4; ++q) {   // (re, im) pairs of B and C
            const float br = b[s][2 * q], bi = b[s][2 * q + 1];
            acc[i][2 * q] = fmaf(-y, bi, fmaf(x, br, acc[i][2 * q]));
            acc[i][2 * q + 1] = fmaf(y, br, fmaf(x, bi, acc[i][2 * q + 1]));
          }
        } else {
          const float y = ai[i][s];
#pragma unroll
          for (int q = 0; q < 4; ++q) {   // real B: two products
            acc[i][2 * q] = fmaf(x, b[s][q], acc[i][2 * q]);
            acc[i][2 * q + 1] = fmaf(y, b[s][q], acc[i][2 * q + 1]);
          }
        }
      }
    }
  }
};

template <typename T, int KTF, int MODE>
__global__ void __launch_bounds__(kThreads, kResBlocks)
band_spmm_res(const Args a) {
  using L = Layout<T, KTF, MODE>;
  using Tl = Tile<KTF, MODE>;
  constexpr int kG = Tl::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r0 = static_cast<long long>(blockIdx.x / a.ktiles)
                       * kBlockRows;
  const int col0 = (blockIdx.x % a.ktiles) * KTF;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 7;
  const int ty = (threadIdx.x >> 5) * 4 + (lane >> 3);
  const int nchunks = (a.w + kResChunk - 1) / kResChunk;
  float acc[kRowsT][8];   // the real k-tile of 32 uses the first 4
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  int src[BPieces<KTF>::kCount];
#pragma unroll
  for (int s = 0; s < kResStages - 1; ++s) {
    if (s < nchunks) {
      b_rows<KTF>(a, r0, s * kResChunk, src);
      fetch<T, KTF, MODE>(a, r0, col0, s * kResChunk, src,
                          smem + s * L::kStageBytes);
    }
    commit();
  }
  b_rows<KTF>(a, r0, (kResStages - 1) * kResChunk, src);
  for (int ch = 0; ch < nchunks; ++ch) {
    wait_group<kResStages - 2>();
    __syncthreads();   // chunk ch landed; chunk ch - 1's buffer is free
    const int nx = ch + kResStages - 1;
    if (nx < nchunks) {
      fetch<T, KTF, MODE>(a, r0, col0, nx * kResChunk, src,
                          smem + (nx % kResStages) * L::kStageBytes);
      b_rows<KTF>(a, r0, (nx + 1) * kResChunk, src);
    }
    commit();
    const unsigned char* stage = smem + (ch % kResStages) * L::kStageBytes;
    const T* sa = reinterpret_cast<const T*>(stage) + ty * L::kStride;
    const float* sb = reinterpret_cast<const float*>(stage + L::kABytes)
                      + 4 * tx;
    // whole chunks (zeros past W add nothing): no early exit, so the
    // step groups' shared loads schedule freely
#pragma unroll
    for (int gw = 0; gw < kResChunk / 4; ++gw) {
      Frag<KTF, MODE> f;
      f.load(sa, sb, gw);
      f.fma(acc);
    }
  }
  wait_group<0>();
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
    const long long r = r0 + ty + i * kRowGroups;
    const long long dst = a.idx != nullptr ? __ldg(a.idx + r) : r;
    if (dst < 0 || dst >= a.m) continue;
    float* out = a.c + dst * a.cf;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int off = Tl::goff(col0, tx, g);
      if (a.vc) {
        if (off < a.cf) {
          *reinterpret_cast<float4*>(out + off) = make_float4(
              acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
              acc[i][4 * g + 3]);
        }
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (off + p < a.cf) out[off + p] = acc[i][4 * g + p];
        }
      }
    }
  }
}

template <typename T, int KTF, int MODE>
cudaError_t launch(const Args& a, unsigned grid, cudaStream_t st) {
  constexpr int kSmem = Layout<T, KTF, MODE>::kSmemBytes;
  static bool raised = false;   // the shared-memory limit, once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_spmm_res<T, KTF, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  band_spmm_res<T, KTF, MODE><<<grid, kThreads, kSmem, st>>>(a);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// B and C as rows of floats: kf and cf floats a row.  The k-tile is 32 B
// floats where a B row holds no more (and always with a real B in the
// complex mode), else 64.
template <typename T, int MODE>
int run(const void* p0, const void* p1, const void* b, const void* idx,
        void* c, int rows, int w, int kf, int cf, int n, int pad_l, int m,
        void* stream) {
  const int nblk = rows / kBlockRows;
  if (nblk <= 0 || kf <= 0 || m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int ktf = (MODE == kCxRealB || (MODE == kReal && kf <= 32)) ? 32
                                                                    : 64;
  Args a;
  a.p0 = p0;
  a.p1 = p1 != nullptr ? p1 : p0;
  a.b = static_cast<const float*>(b);
  a.idx = static_cast<const int*>(idx);
  a.c = static_cast<float*>(c);
  a.rows = rows;
  a.w = w;
  a.kf = kf;
  a.cf = cf;
  a.n = n;
  a.pad_l = pad_l;
  a.m = m;
  a.ktiles = (kf + ktf - 1) / ktf;
  const int vec = 16 / static_cast<int>(sizeof(T));
  a.va = w % vec == 0 && aligned16(a.p0) && aligned16(a.p1);
  a.vb = kf % 4 == 0 && aligned16(b);
  a.vc = cf % 4 == 0 && aligned16(c);
  const long long grid = static_cast<long long>(nblk) * a.ktiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(grid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (MODE == kReal) {
    e = ktf == 32 ? launch<T, 32, kReal>(a, g, st)
                  : launch<T, 64, kReal>(a, g, st);
  } else if constexpr (MODE == kCx) {
    e = launch<T, 64, kCx>(a, g, st);
  } else {
    e = launch<T, 32, kCxRealB>(a, g, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace res

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

// B row q - pad_l where that is in [0, n) (the geometry of band_spmm_res)
struct Rows {
  int n, pad_l, m;
};

// One stage: sA[r * kStrideA + cc] = panels[r0 + r, c0 + cc] (0 past W)
// and sB[cc * kStrideB + j] = b[r0 + c0 + cc - pad_l, col0 + j] (0 past
// W, past k or outside B's rows).  VA: 16-byte copies of the panels (W a
// multiple of 16 bytes, the panels 16-byte aligned); VB: of B (k a
// multiple of 4, b aligned); otherwise plain loads and stores, done
// before the stage's barrier.
template <typename T, bool VA, bool VB>
__device__ __forceinline__ void fetch(const T* __restrict__ panels,
                                      const float* __restrict__ bp,
                                      long long r0, int w, int k,
                                      long long col0, int c0, Rows g, T* sA,
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
      const long long q = r0 + c0 + cc - g.pad_l;
      const bool in = c0 + cc < w && q >= 0 && q < g.n && col0 + j < k;
      cp_async16(sB + cc * kStrideB + j, in ? bp + q * k + col0 + j : bp,
                 in);
    }
  } else {
    for (int idx = threadIdx.x; idx < kChunk * kCols; idx += kThreads) {
      const int cc = idx / kCols, j = idx % kCols;
      const long long q = r0 + c0 + cc - g.pad_l;
      const bool in = c0 + cc < w && q >= 0 && q < g.n && col0 + j < k;
      sB[cc * kStrideB + j] = in ? __ldg(bp + q * k + col0 + j) : 0.f;
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
             float* __restrict__ c, int w, int k, int ktiles, Rows geo) {
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
      fetch<T, VA, VB>(panels, bp, r0, w, k, col0, s * kChunk, geo,
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
      fetch<T, VA, VB>(panels, bp, r0, w, k, col0, nx * kChunk, geo,
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
    if (col >= k || r0 + r >= geo.m) continue;
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
                      int w, int k, int ktiles, Rows geo, cudaStream_t st) {
  static bool raised = false;   // the shared-memory limit, once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_spmm_tc<T, VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  band_spmm_tc<T, VA, VB><<<grid, kThreads, kSmemBytes, st>>>(p, b, out, w,
                                                              k, ktiles, geo);
  return cudaSuccess;
}

template <typename T>
int run(const void* panels, const void* bp, void* c, int rows, int w, int k,
        int n, int pad_l, int m, void* stream) {
  const int nblk = rows / kBlockRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(panels);
  const float* b = static_cast<const float*>(bp);
  float* out = static_cast<float*>(c);
  if (nblk <= 0 || k <= 0 || m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int ktiles = (k + kCols - 1) / kCols;
  const long long grid = static_cast<long long>(nblk) * ktiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(grid);
  const Rows geo{n, pad_l, m};
  // 16-byte panel copies need whole 16-byte rows from an aligned base
  const bool va = w % (16 / static_cast<int>(sizeof(T))) == 0
                  && res::aligned16(panels);
  const bool vec = k % 4 == 0 && res::aligned16(bp) && res::aligned16(c);
  cudaError_t e;
  if (va && vec) {
    e = launch_tc<T, true, true>(g, p, b, out, w, k, ktiles, geo, st);
  } else if (va) {
    e = launch_tc<T, true, false>(g, p, b, out, w, k, ktiles, geo, st);
  } else if (vec) {
    e = launch_tc<T, false, true>(g, p, b, out, w, k, ktiles, geo, st);
  } else {
    e = launch_tc<T, false, false>(g, p, b, out, w, k, ktiles, geo, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// panels: (rows, w) f32 or bf16, row-major, rows a multiple of 128;
// b: (n, k) f32 row-major, read in place (window row q reads b row
// q - pad_l, or idx[q - pad_l]); idx: nullptr or (rows,) int32; c: (m, k)
// f32, band row j written to row j (idx[j]) when below m.
extern "C" int band_spmm_f32(const void* panels, const void* b,
                             const void* idx, void* c, int rows, int w,
                             int k, int n, int pad_l, int m, void* stream) {
  return res::run<float, res::kReal>(panels, nullptr, b, idx, c, rows, w,
                                     k, k, n, pad_l, m, stream);
}

extern "C" int band_spmm_bf16(const void* panels, const void* b,
                              const void* idx, void* c, int rows, int w,
                              int k, int n, int pad_l, int m, void* stream) {
  return res::run<__nv_bfloat16, res::kReal>(panels, nullptr, b, idx, c,
                                             rows, w, k, k, n, pad_l, m,
                                             stream);
}

// The complex pass: panels_re, panels_im (rows, w) f32, the two planes of
// one band; b (n, k) complex64 (b_complex != 0) or f32; c (m, k)
// complex64.
extern "C" int band_spmm_cx(const void* panels_re, const void* panels_im,
                            const void* b, void* c, int rows, int w, int k,
                            int n, int pad_l, int m, int b_complex,
                            void* stream) {
  if (b_complex) {
    return res::run<float, res::kCx>(panels_re, panels_im, b, nullptr, c,
                                     rows, w, 2 * k, 2 * k, n, pad_l, m,
                                     stream);
  }
  return res::run<float, res::kCxRealB>(panels_re, panels_im, b, nullptr, c,
                                        rows, w, k, 2 * k, n, pad_l, m,
                                        stream);
}

// the tensor-core kernel: b (n, k) f32 read in place as above (no
// index); c (m, k) f32
extern "C" int band_spmm_stream_f32(const void* panels, const void* b,
                                    void* c, int rows, int w, int k, int n,
                                    int pad_l, int m, void* stream) {
  return tc::run<float>(panels, b, c, rows, w, k, n, pad_l, m, stream);
}

extern "C" int band_spmm_stream_bf16(const void* panels, const void* b,
                                     void* c, int rows, int w, int k, int n,
                                     int pad_l, int m, void* stream) {
  return tc::run<__nv_bfloat16>(panels, b, c, rows, w, k, n, pad_l, m,
                                stream);
}

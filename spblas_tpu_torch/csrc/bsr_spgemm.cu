// Block SpGEMM numeric for Hopper: C = A·B with A, B and C stored as dense
// blocks (BSR), over the pair lists of the block-symbolic phase
// (spblas_tpu_torch/kernels/bsr_spgemm.py):
//   C[e] = sum over t in [pair_ptr[e], pair_ptr[e+1]) of
//          A[pair_a[t]] (bh, bk) @ B[pair_b[t]] (bk, bw).
//
// Replaces the TPU kernel spblas_tpu/kernels/bsr_spgemm.py::
// _numeric_kernel (pl.pallas_call in bsr_spgemm_numeric), which runs one
// grid program per C block and double-buffers the pair blocks through
// VMEM by DMA onto the MXU, dotting at Precision.HIGHEST.
//
// What bounds it on the H100: operations.  At the block cell (32,768^2,
// 128x128 blocks, 16,384 pairs) 68.7 GFLOP against 0.2 GB of blocks: 0.42
// ms as a full-f32 product on the TF32 tensor cores (three TF32 products,
// tf32_mma.cuh), 1.03 ms in f64 on the FP64 tensor cores (67 TFLOP/s,
// DMMA), 1.03 and 2.02 ms in f32 and f64 FMAs.  The first Hopper design
// ran FMAs (an 8x4 register tile a thread): 2.14 ms in f32, 6.72 in f64
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).
//
// Design.  A CTA owns a tile of one C block: 128 rows by 128 columns (f32;
// 4 warps of 64 x 64, as the streamed band SpMM) or by 64 (f64; 8 warps
// of 32 x 32), and for C blocks of 16 rows or fewer one m16 tile (16
// rows, half empty at bh = 8) by 128 or 64 columns with 4 warps.  It
// walks the pairs of its C block and each pair's depth in stages of 16,
// as one sequence, through a ring of cp.async copies in shared memory
// (no registers, zero-filled past the block's edges, so any bh, bk and
// bw work): A's slice (tile rows by 16), B's slice (16 by tile columns)
// row-major with a padded stride, one barrier a stage.  The fragment's k
// slots t and t + 4 take the depths 2t and 2t + 1, so a thread's A
// fragment of a row is one 8-byte (f32) or 16-byte (f64, in chunks
// swizzled by the parity of their row) load, and the pads and the
// swizzle keep the fragment loads free of bank conflicts.  f64 runs the
// FP64 tensor cores (mma.sync.m16n8k8 f64, measured at 67 TFLOP/s on the
// card; wgmma has no f64 form), whose sums are f64.  f32 runs
// mma.sync.m16n8k8 TF32 with the 3xTF32 split as the fragments load,
// each step from zero and folded by an f32 add (tf32_mma.cuh: accuracy,
// and the edges of the range).  Splitting each stage once into shared
// memory (fewer splits, a second barrier a stage) lost: 2.42 against
// 1.68 ms on 8 warps of 32 x 64 (NVIDIA H100 80GB HBM3, 700 W;
// scripts/route_profile.py --kernels bsr_spgemm).  One CTA writes each C
// element once: no atomics, the same bits every run.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kDepth = 16;          // depths a stage
constexpr int kPairs = kDepth / 2;  // two-depth chunks a row of a stage
constexpr int kRing = 3;            // stages of the copy ring
constexpr int kRingSmall = 3;       // and of the 16-row tiles'

// CTA shape: WM x WN warps, each MT m16 tiles by NT n8 tiles, at least
// MINB CTAs an SM (the register cap).  TR: C^T = B^T A^T for C blocks of
// 8 rows or fewer, B's columns on the mma's rows (MT m16 tiles a warp)
// and A's 8 rows on its columns, so no m16 tile runs half empty.  The
// 16-row tiles beat the 128-row ones 3.4-3.8x on C blocks of 8 to 16
// rows: f32 bh 16 0.074 against 0.252 ms, bh 12 0.160 against 0.519; f64
// bh 8 0.184 against 0.702, bh 16 0.101 against 0.358 (chip_smoke.py's
// kernel-only shapes; NVIDIA H100 80GB HBM3, 700 W; route_profile.py)
template <int WM_, int WN_, int MT_, int NT_, int MINB_, bool TR_ = false>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_;
  static constexpr int kMinBlocks = MINB_;
  static constexpr bool kTr = TR_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kTM = TR_ ? 8 : WM * MT * 16;         // C rows a CTA
  static constexpr int kTN = TR_ ? WN * MT * 16 : WN * NT * 8;   // columns
};
constexpr int kBigMinBlocks = 2;     // CTAs an SM of the 128-row tiles
constexpr int kSmallMinBlocks = 4;   // and of the 16-row ones
// f32: 128 x 128, warps of 64 x 64
using Big32 = Cfg<2, 2, 4, 8, kBigMinBlocks>;
// f32, bh <= 16: 16 x 128 (4 warps of 16 x 32)
using Small32 = Cfg<1, 4, 1, 4, kSmallMinBlocks>;
// f32, bh <= 8: 8 x 128 as C^T (4 warps of 32 B columns by 8 A rows)
using Tiny32 = Cfg<1, 4, 2, 1, kSmallMinBlocks, true>;
// f64: 128 x 64, warps of 32 x 32
using Big64 = Cfg<4, 2, 2, 4, kBigMinBlocks>;
// f64, bh <= 16: 16 x 64
using Small64 = Cfg<1, 4, 1, 2, kSmallMinBlocks>;

// the slot of chunk p in row r of an f64 A stage
__device__ __forceinline__ int slot(int r, int p) {
  return p ^ ((r & 1) << 2);
}

// The stage layouts, in elements of T.  A: f64 as swizzled 16-byte chunks
// (kPairs a row); f32 row-major with a stride of 24 (8-byte fragment
// loads of a half-warp on distinct banks).  B: row-major, the stride
// padded to 4 (mod 16) floats or 2 (mod 8) doubles, so the rows 2t and
// 2t + 1 that a fragment reads fall on distinct banks.
template <typename T, typename C>
struct Layout {
  static constexpr bool kF64 = sizeof(T) == 8;
  static constexpr int kVec = 16 / sizeof(T);        // elements a copy
  static constexpr int kSA = kF64 ? kDepth : 24;
  static constexpr int kSB = C::kTN + (kF64 ? 2 : 4);
  static constexpr int kAElems = C::kTM * kSA;
  static constexpr int kBElems = kDepth * kSB;
  static constexpr int kStage = kAElems + kBElems;   // elements a stage
  static constexpr int kSlots =
      C::kTr || C::WM * C::MT == 1 ? kRingSmall : kRing;
  static constexpr int kSmemBytes =
      kSlots * kStage * static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem,
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

// d += a*b for one m16n8k8 f64 step (PTX ISA fragment layouts: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1
// (t + 4, g); d as the f32 form)
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Copies of stage st (pair lo + st / kst, depths from (st % kst) * 16)
// into the ring slot sA / sB; VEC: 16-byte copies (bk and bw multiples of
// kVec, the blocks 16-byte aligned), else one element a copy.
template <typename T, typename C, bool VEC>
__device__ __forceinline__ void issue(T* sA, T* sB, const T* A, const T* B,
                                      const int* pair_a, const int* pair_b,
                                      int lo, int kst, long long st, int r0,
                                      int c0, int bh, int bk, int bw) {
  using L = Layout<T, C>;
  constexpr int V = L::kVec;
  const int pr = lo + static_cast<int>(st / kst);
  const int k0 = static_cast<int>(st % kst) * kDepth;
  const T* a = A + static_cast<long long>(pair_a[pr]) * bh * bk;
  const T* b = B + static_cast<long long>(pair_b[pr]) * bk * bw;
  const int tid = threadIdx.x;
  // A: kTM rows by kDepth / V copies a row
  for (int i = tid; i < C::kTM * (kDepth / V); i += C::kThreads) {
    const int row = i / (kDepth / V), q = i % (kDepth / V);
    const int r = r0 + row, k = k0 + q * V;
    // f64: the copy is chunk q of the row; f32: columns q*4 .. q*4 + 3
    T* d = L::kF64 ? sA + (row * kPairs + slot(row, q)) * 2
                   : sA + row * L::kSA + q * V;
    const T* src = a + static_cast<long long>(r) * bk + k;
    if constexpr (VEC) {
      cp_async16(d, r < bh && k < bk ? src : a, r < bh && k < bk);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const bool ok = r < bh && k + u < bk;
        cp_async_small<sizeof(T)>(d + u, ok ? src + u : a, ok);
      }
    }
  }
  // B: kDepth rows by kTN / V copies a row
  for (int i = tid; i < kDepth * (C::kTN / V); i += C::kThreads) {
    const int kk = i / (C::kTN / V), q = i % (C::kTN / V);
    const int k = k0 + kk, n = c0 + q * V;
    T* d = sB + kk * L::kSB + q * V;
    const T* src = b + static_cast<long long>(k) * bw + n;
    if constexpr (VEC) {
      cp_async16(d, k < bk && n < bw ? src : b, k < bk && n < bw);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const bool ok = k < bk && n + u < bw;
        cp_async_small<sizeof(T)>(d + u, ok ? src + u : b, ok);
      }
    }
  }
}

// One step (8 depths, s of the stage) of a warp's MT x NT tiles.
// f32 from the ring stage, split as the fragments load
template <typename C>
__device__ __forceinline__ void step_raw(float (&acc)[C::MT][C::NT][4],
                                         const float* sA, const float* sB,
                                         int s, int wm, int wn, int g,
                                         int t) {
  using L = Layout<float, C>;
  uint32_t ahi[C::MT][4], alo[C::MT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    const int r = wm * C::MT * 16 + mt * 16 + g;
    const float2 u =
        *reinterpret_cast<const float2*>(sA + r * L::kSA + 8 * s + 2 * t);
    const float2 v = *reinterpret_cast<const float2*>(
        sA + (r + 8) * L::kSA + 8 * s + 2 * t);
    tf32::split(u.x, ahi[mt][0], alo[mt][0]);
    tf32::split(v.x, ahi[mt][1], alo[mt][1]);
    tf32::split(u.y, ahi[mt][2], alo[mt][2]);
    tf32::split(v.y, ahi[mt][3], alo[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int n = wn * C::NT * 8 + nt * 8 + g;
    uint32_t bhi[2], blo[2];
    tf32::split(sB[(8 * s + 2 * t) * L::kSB + n], bhi[0], blo[0]);
    tf32::split(sB[(8 * s + 2 * t + 1) * L::kSB + n], bhi[1], blo[1]);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      tf32::step<true>(acc[mt][nt], ahi[mt], alo[mt], bhi, blo);
    }
  }
}

// f32 from the ring stage as C^T = B^T A^T: the mma's A fragment is B's
// columns n0 + g (+ 8) at depths 2t, 2t + 1, its B fragment A's row g at
// the same depths; acc[mt][0] holds C^T's rows (B columns) g, g + 8 by
// its columns (A rows) 2t, 2t + 1
template <typename C>
__device__ __forceinline__ void step_tr(float (&acc)[C::MT][C::NT][4],
                                        const float* sA, const float* sB,
                                        int s, int wn, int g, int t) {
  using L = Layout<float, C>;
  const float2 av =
      *reinterpret_cast<const float2*>(sA + g * L::kSA + 8 * s + 2 * t);
  uint32_t bhi[2], blo[2];
  tf32::split(av.x, bhi[0], blo[0]);
  tf32::split(av.y, bhi[1], blo[1]);
  const float* b0 = sB + (8 * s + 2 * t) * L::kSB;
  const float* b1 = b0 + L::kSB;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    const int n = wn * C::MT * 16 + mt * 16 + g;
    uint32_t ahi[4], alo[4];
    tf32::split(b0[n], ahi[0], alo[0]);
    tf32::split(b0[n + 8], ahi[1], alo[1]);
    tf32::split(b1[n], ahi[2], alo[2]);
    tf32::split(b1[n + 8], ahi[3], alo[3]);
    tf32::step<true>(acc[mt][0], ahi, alo, bhi, blo);
  }
}

// f64 from the ring stage
template <typename C>
__device__ __forceinline__ void step_f64(double (&acc)[C::MT][C::NT][4],
                                         const double* sA, const double* sB,
                                         int s, int wm, int wn, int g,
                                         int t) {
  using L = Layout<double, C>;
  const double2* cA = reinterpret_cast<const double2*>(sA);
  double a[C::MT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    const int r = wm * C::MT * 16 + mt * 16 + g;
    const double2 u = cA[r * kPairs + slot(r, 4 * s + t)];
    const double2 v = cA[(r + 8) * kPairs + slot(r + 8, 4 * s + t)];
    a[mt][0] = u.x; a[mt][1] = v.x; a[mt][2] = u.y; a[mt][3] = v.y;
  }
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int n = wn * C::NT * 8 + nt * 8 + g;
    const double b[2] = {sB[(8 * s + 2 * t) * L::kSB + n],
                         sB[(8 * s + 2 * t + 1) * L::kSB + n]};
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) dmma(acc[mt][nt], a[mt], b);
  }
}

// A CTA: one (C block e, row tile, column tile).  Ring slot st % kSlots
// holds stage st; stage st + kSlots - 1 is copied while st runs.
template <typename T, typename C, bool VEC>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
bsr_spgemm_tc(const int* __restrict__ pair_ptr,
              const int* __restrict__ pair_a,
              const int* __restrict__ pair_b, const T* __restrict__ A,
              const T* __restrict__ B, T* __restrict__ Cm, int bh, int bk,
              int bw, int rtiles, int ctiles) {
  using L = Layout<T, C>;
  constexpr int kSlots = L::kSlots;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);

  const int ct = blockIdx.x % ctiles;
  const long long rest = blockIdx.x / ctiles;
  const int rt = static_cast<int>(rest % rtiles);
  const long long e = rest / rtiles;
  const int r0 = rt * C::kTM, c0 = ct * C::kTN;
  const int lo = pair_ptr[e], hi = pair_ptr[e + 1];
  const int kst = (bk + kDepth - 1) / kDepth;
  const long long nst = static_cast<long long>(hi - lo) * kst;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t = lane & 3;

  auto stage_a = [&](long long st) { return ring + (st % kSlots) * L::kStage; };
  auto copy = [&](long long st) {
    if (st < nst) {
      T* sa = stage_a(st);
      issue<T, C, VEC>(sa, sa + L::kAElems, A, B, pair_a, pair_b, lo, kst,
                       st, r0, c0, bh, bk, bw);
    }
    cp_commit();   // an empty group past the end keeps the count
  };

  T acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = T(0);
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots - 1; ++s) copy(s);
  for (long long st = 0; st < nst; ++st) {
    cp_wait<kSlots - 2>();
    // stage st landed for every thread; its slot's last reader (stage
    // st - 1) is done
    __syncthreads();
    copy(st + kSlots - 1);
    const T* sa = stage_a(st);
    const T* sb = sa + L::kAElems;
    if constexpr (L::kF64) {
      // not unrolled: 2.235 against 2.329 ms on the f64 block cell; the
      // f32 loops stay unrolled (1.442 against 1.463 ms not unrolled;
      // scripts/route_profile.py, NVIDIA H100 80GB HBM3, 700 W)
#pragma unroll 1
      for (int s = 0; s < kDepth / 8; ++s) {
        step_f64<C>(acc, sa, sb, s, wm, wn, g, t);
      }
    } else if constexpr (C::kTr) {
#pragma unroll
      for (int s = 0; s < kDepth / 8; ++s) {
        step_tr<C>(acc, sa, sb, s, wn, g, t);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kDepth / 8; ++s) {
        step_raw<C>(acc, sa, sb, s, wm, wn, g, t);
      }
    }
  }
  cp_wait<0>();

  T* out = Cm + e * static_cast<long long>(bh) * bw;
  if constexpr (C::kTr) {
    // C^T's rows g, g + 8 (C's columns) by its columns 2t, 2t + 1 (C's
    // rows) of each m16 tile
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 2 * t + (q & 1);
        const int col = c0 + wn * C::MT * 16 + mt * 16 + g + 8 * (q >> 1);
        if (r < bh && col < bw) {
          out[static_cast<long long>(r) * bw + col] = acc[mt][0][q];
        }
      }
    }
    return;
  }

  // rows g and g + 8 of each m16 tile at columns 2t, 2t + 1 of each n8
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm * C::MT * 16 + mt * 16 + 8 * h + g;
      if (r >= bh) continue;
      T* row = out + static_cast<long long>(r) * bw;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int col = c0 + wn * C::NT * 8 + nt * 8 + 2 * t;
        const T d0 = acc[mt][nt][2 * h], d1 = acc[mt][nt][2 * h + 1];
        if (VEC && col + 1 < bw) {   // bw even: a two-element store
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float2*>(row + col) = make_float2(d0, d1);
          } else {
            *reinterpret_cast<double2*>(row + col) = make_double2(d0, d1);
          }
        } else {
          if (col < bw) row[col] = d0;
          if (col + 1 < bw) row[col + 1] = d1;
        }
      }
    }
  }
}

template <typename T, typename C, bool VEC>
cudaError_t launch_cfg(const int* pp, const int* pa, const int* pb,
                       const T* a, const T* b, T* c, int nnzb_c, int bh,
                       int bk, int bw, cudaStream_t st) {
  const int rtiles = (bh + C::kTM - 1) / C::kTM;
  const int ctiles = (bw + C::kTN - 1) / C::kTN;
  const long long grid = static_cast<long long>(nnzb_c) * rtiles * ctiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  constexpr int smem = Layout<T, C>::kSmemBytes;
  static bool raised = false;   // the shared-memory limit, once
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_spgemm_tc<T, C, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  bsr_spgemm_tc<T, C, VEC><<<static_cast<unsigned>(grid), C::kThreads, smem,
                             st>>>(pp, pa, pb, a, b, c, bh, bk, bw, rtiles,
                                   ctiles);
  return cudaGetLastError();
}

template <typename T, typename CBig, typename CSmall, typename CTiny>
int launch(const void* pair_ptr, const void* pair_a, const void* pair_b,
           const void* A, const void* B, void* C, int nnzb_c, int bh,
           int bk, int bw, int vec, void* stream) {
  const int* pp = static_cast<const int*>(pair_ptr);
  const int* pa = static_cast<const int*>(pair_a);
  const int* pb = static_cast<const int*>(pair_b);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  T* c = static_cast<T*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec) {
    err = bh <= 8    ? launch_cfg<T, CTiny, true>(pp, pa, pb, a, b, c,
                                                 nnzb_c, bh, bk, bw, st)
          : bh <= 16 ? launch_cfg<T, CSmall, true>(pp, pa, pb, a, b, c,
                                                   nnzb_c, bh, bk, bw, st)
                     : launch_cfg<T, CBig, true>(pp, pa, pb, a, b, c, nnzb_c,
                                                 bh, bk, bw, st);
  } else {
    err = bh <= 8    ? launch_cfg<T, CTiny, false>(pp, pa, pb, a, b, c,
                                                  nnzb_c, bh, bk, bw, st)
          : bh <= 16 ? launch_cfg<T, CSmall, false>(pp, pa, pb, a, b, c,
                                                    nnzb_c, bh, bk, bw, st)
                     : launch_cfg<T, CBig, false>(pp, pa, pb, a, b, c,
                                                  nnzb_c, bh, bk, bw, st);
  }
  return static_cast<int>(err);
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
  return launch<float, Big32, Small32, Tiny32>(pair_ptr, pair_a, pair_b, A,
                                               B, C, nnzb_c, bh, bk, bw, vec,
                                               stream);
}

extern "C" int bsr_spgemm_f64(const void* pair_ptr, const void* pair_a,
                              const void* pair_b, const void* A,
                              const void* B, void* C, int nnzb_c, int bh,
                              int bk, int bw, int vec, void* stream) {
  return launch<double, Big64, Small64, Small64>(pair_ptr, pair_a, pair_b,
                                                 A, B, C, nnzb_c, bh, bk, bw,
                                                 vec, stream);
}

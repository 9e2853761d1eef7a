// BSR SpMV for Hopper: y = A·x with A stored as dense (bh, bw) blocks.
//
// Replaces the TPU kernel spblas_tpu/kernels/bsr_pallas.py::
// _bsr_spmv_kernel (pl.pallas_call in bsr_spmv).  Block row i holds the
// blocks e in [rowptr[i], rowptr[i+1]); block e covers columns
// [colind[e]*bw, colind[e]*bw + bw), so
//   y[i*bh + r] = sum_e sum_c values[e, r, c] * x[colind[e]*bw + c],
// with x read in place: entries at or past n read as 0 (the chooser's
// BSR pads its columns to whole blocks, and x is not copied to match).
// Blocks past the stored count (capacity padding) are never reached:
// only rowptr bounds a row's loop.
//
// What bounds it on the H100: bytes.  Every stored block value is read
// once (2 flops each), x comes through L2 and y is written once, so the
// kernel must stream the values at the card's memory rate.  A block
// row's values are one contiguous span of (hi - lo)*bh*bw elements.
//
// Design: three mappings, picked by the host from (bh, bw, dtype) and
// the operands' alignment (kernels/bsr_kernels.py spmv_mapping); every
// one keeps one writer an output row, no atomics and a fixed order of
// sums, so a run gives the same bits every time.
//  - cols (any shape; wide blocks such as the chooser's 8x128): a warp
//    an output row, its lanes on the block's columns in V-element pieces
//    (16-byte loads where bw and the pointers allow), the block row's
//    colind loaded once (lane t loads colind[lo + t], a shuffle hands it
//    out) and the value loads of a group of kGroup blocks issued before
//    the colind shuffles, so values are in flight with the indices and
//    x is read as soon as they land.
//  - span (power-of-two blocks whose size divides 32·V elements, such as
//    8x8): a warp a block row walks its span, 32·V elements a step, in
//    V-element pieces; each lane's (row, column) in a block is the same
//    in every step, so a lane keeps one partial sum, and a fixed
//    butterfly over the lanes of one row folds them.
//  - small (other blocks of at most 32 elements, such as the 3x3 block of
//    3-D elasticity: 36 bytes, no whole 16-byte piece): a warp a block
//    row, a step takes 32 / (bh*bw) whole blocks, an element a lane (27
//    of 32 lanes at 3x3), so each lane's (row, column) stays fixed and
//    it keeps one partial sum; shuffles fold a row's columns, then its
//    blocks of the step, in a fixed order.  3x3 rows are short (27
//    blocks, 972 bytes), so a warp a row is bound by each row's chain of
//    dependent loads (rowptr, then colind and values, then x), not by
//    bytes: persistent CTAs of 4 warps walk the rows grid-stride, each
//    warp with a ring of row stages in shared memory that cp.async fills
//    kRing - 1 rows ahead (the value span in 16-byte pieces, its colind,
//    nothing held in registers while they land), and the rowptr pairs of
//    its next 32 rows in lane registers.
// An empty block row writes 0.  f32 and f64 instantiations: the BSR
// base path takes any BSR, and the TPU kernel computes in
// result_type(A, x).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;       // blocks a cols lane loads before its FMAs
constexpr int kSteps = 4;       // span steps in flight
constexpr int kStepsSmall = 10;  // small steps in flight (30 3x3 blocks)
// CTAs an SM each mapping's register cap leaves room for (small: CTAs of
// 128 threads, f32 and f64)
constexpr int kMinCols = 4;
constexpr int kMinSpan = 4;
constexpr int kMinSmall = 6;
constexpr int kMinSmall64 = 5;
// small: persistent CTAs of 4 warps walking block rows grid-stride, each
// warp with a ring of row stages in shared memory (kRing - 1 rows'
// values and colind in flight while a row's x is gathered; f32, f64)
constexpr int kSmallWarps = 4;
constexpr int kRing = 4;
constexpr int kRing64 = 3;

// streaming (evict-first) loads of V values, read-only loads of V x
__device__ __forceinline__ void ld_cs(const float* p, float (&v)[1]) {
  v[0] = __ldcs(p);
}
__device__ __forceinline__ void ld_cs(const float* p, float (&v)[2]) {
  const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void ld_cs(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld_cs(const double* p, double (&v)[1]) {
  v[0] = __ldcs(p);
}
__device__ __forceinline__ void ld_cs(const double* p, double (&v)[2]) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void ld_x(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void ld_x(const float* p, float (&v)[2]) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void ld_x(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld_x(const double* p, double (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void ld_x(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}

// x[at .. at + V), zeros at and past n
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* __restrict__ x, long long at,
                                       long long n, T (&v)[V]) {
  if (at + V <= n) {
    ld_x(x + at, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = at + k < n ? __ldg(x + at + k) : T(0);
  }
}

template <typename T, int V>
__device__ __forceinline__ void zero(T (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = T(0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(~0u, v, off);
  return v;
}

// cols: a warp an output row; a lane takes the pieces lane*V + 32*V*t
// (t < NC) of each block's row r, then the next 32*V*NC columns
template <typename T, int V, int NC>
__global__ void __launch_bounds__(kThreads, kMinCols)
bsr_cols(const T* __restrict__ values, const int* __restrict__ rowptr,
         const int* __restrict__ colind, const T* __restrict__ x,
         T* __restrict__ y, long long rows, int bh, int bw, long long n) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const long long i = row / bh;
  const int r = static_cast<int>(row - i * bh);
  const int lo = rowptr[i], hi = rowptr[i + 1];
  const long long blk = static_cast<long long>(bh) * bw;
  const T* vrow = values + static_cast<long long>(r) * bw;
  T acc = T(0);
  for (int cb = 0; cb < bw; cb += 32 * V * NC) {
    for (int b0 = lo; b0 < hi; b0 += 32) {
      const int cnt = min(32, hi - b0);
      const int mycol = lane < cnt ? __ldg(colind + b0 + lane) : 0;
      for (int g = 0; g < cnt; g += kGroup) {
        T a[kGroup][NC][V], xv[kGroup][NC][V];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int t = 0; t < NC; ++t) {
            const int c = cb + lane * V + 32 * V * t;
            if (g + u < cnt && c < bw) {
              ld_cs(vrow + (b0 + g + u) * blk + c, a[u][t]);
            } else {
              zero(a[u][t]);
            }
          }
        }
        int col[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          col[u] = __shfl_sync(~0u, mycol, (g + u) & 31);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int t = 0; t < NC; ++t) {
            const int c = cb + lane * V + 32 * V * t;
            if (g + u < cnt && c < bw) {
              load_x(x, static_cast<long long>(col[u]) * bw + c, n,
                     xv[u][t]);
            } else {
              zero(xv[u][t]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
#pragma unroll
          for (int t = 0; t < NC; ++t)
#pragma unroll
            for (int k = 0; k < V; ++k) acc = fma(a[u][t][k], xv[u][t][k], acc);
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) y[row] = acc;
}

// span: a warp a block row; bh*bw a power of two dividing 32*V and V
// dividing bw.  A step covers 32*V elements: 32*V/(bh*bw) blocks, lane l
// on element (l*V) mod (bh*bw) of block (l*V) / (bh*bw) of the step.
// lb_shift = log2(bh*bw / V), c_shift = log2(bw / V).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinSpan)
bsr_span(const T* __restrict__ values, const int* __restrict__ rowptr,
         const int* __restrict__ colind, const T* __restrict__ x,
         T* __restrict__ y, long long mb, int bh, int bw, long long n,
         int lb_shift, int c_shift) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= mb) return;  // uniform across the warp
  const int size = bh * bw;
  const int per_step = 32 >> lb_shift;        // blocks a step
  const int lb = lane >> lb_shift;            // this lane's block in a step
  const int q = lane & ((1 << lb_shift) - 1);
  const int pos = q * V;                      // element in the block
  const int c = (q & ((1 << c_shift) - 1)) * V;
  const int r = q >> c_shift;
  const int lo = rowptr[i], hi = rowptr[i + 1];
  T acc = T(0);
  for (int b0 = lo; b0 < hi; b0 += 32) {
    const int cnt = min(32, hi - b0);
    const int mycol = lane < cnt ? __ldg(colind + b0 + lane) : 0;
    const T* base = values + static_cast<long long>(b0) * size + pos;
    const int steps = (cnt + per_step - 1) / per_step;
    for (int j0 = 0; j0 < steps; j0 += kSteps) {
      T a[kSteps][V], xv[kSteps][V];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int e = (j0 + u) * per_step + lb;
        if (e < cnt) {
          ld_cs(base + static_cast<long long>(e) * size, a[u]);
        } else {
          zero(a[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int e = (j0 + u) * per_step + lb;
        const int col = __shfl_sync(~0u, mycol, e & 31);
        if (e < cnt) {
          load_x(x, static_cast<long long>(col) * bw + c, n, xv[u]);
        } else {
          zero(xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k) acc = fma(a[u][k], xv[u][k], acc);
    }
  }
  // fold the lanes of one row: those that differ in their column piece
  // (the low c_shift bits) or in their block of the step (bits lb_shift
  // and up)
  for (int off = 1; off < (1 << c_shift); off <<= 1)
    acc += __shfl_xor_sync(~0u, acc, off);
  for (int off = 1 << lb_shift; off < 32; off <<= 1)
    acc += __shfl_xor_sync(~0u, acc, off);
  if (lb == 0 && c == 0) y[i * bh + r] = acc;
}

// small: bh*bw <= 32.  A step covers per = 32 / (bh*bw) blocks, lane
// l < per*bh*bw on element l % (bh*bw) of block l / (bh*bw) of the step,
// so the lane's (row, column) in a block never changes; colind comes a
// batch of whole steps (at most 32 blocks) at a time.  A row's head is
// the first kStepsSmall steps of its first batch (all of a row of up to
// 30 3x3 blocks); the rest of a longer row is walked after it.
struct SmallLanes {
  int bh, bw, size, per, used, batch, head, g, c, r;
  bool on;
};

// one stage: a block row's head (its first `head` blocks, head =
// min(batch, kStepsSmall steps)) as the bytes of its value span, placed
// at the same address mod 16 as in memory (`skip` elements in), the
// blocks' colind, and the row's rowptr pair
template <typename T>
struct __align__(16) Stage {
  T v[32 * kStepsSmall + 16 / sizeof(T)];
  int col[32];
  int lo, hi, skip;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

// row [lo, hi)'s head into stage st by cp.async (nothing held in
// registers while it lands), one commit group: its value span in 16-byte
// pieces (an element at a time before the first 16-byte boundary and
// after the last), its colind an entry a lane
template <typename T>
__device__ __forceinline__ void stage_row(const T* __restrict__ values,
                                          const int* __restrict__ colind,
                                          const SmallLanes& L, int lane,
                                          int lo, int hi, Stage<T>& st) {
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  const int cnt = min(L.head, hi - lo);
  const T* g0 = values + static_cast<long long>(lo) * L.size;
  const int elems = cnt * L.size;
  const int skip = static_cast<int>(
      (reinterpret_cast<unsigned long long>(g0) & 15) / sizeof(T));
  // g0[k] lands in st.v[skip + k]; elements [head, head + whole) move in
  // 16-byte pieces
  const int head = min(elems, (kPer16 - skip) % kPer16);
  const int whole = (elems - head) / kPer16 * kPer16;
  for (int k = lane; k < head; k += 32)
    copy_async<sizeof(T)>(&st.v[skip + k], g0 + k);
  for (int k = head + kPer16 * lane; k < head + whole; k += 32 * kPer16)
    copy_async<16>(&st.v[skip + k], g0 + k);
  for (int k = head + whole + lane; k < elems; k += 32)
    copy_async<sizeof(T)>(&st.v[skip + k], g0 + k);
  if (lane < cnt) copy_async<4>(&st.col[lane], colind + lo + lane);
  if (lane == 0) {
    st.lo = lo;
    st.hi = hi;
    st.skip = skip;
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// blocks [b0, hi) of one row, from memory, into acc (a row's blocks past
// its stage)
template <typename T>
__device__ __forceinline__ void row_rest(const T* __restrict__ values,
                                         const int* __restrict__ colind,
                                         const T* __restrict__ x, long long n,
                                         const SmallLanes& L, int lane,
                                         int b0, int hi, T& acc) {
  for (; b0 < hi; b0 += L.batch) {
    const int cnt = min(L.batch, hi - b0);
    const int steps = (cnt + L.per - 1) / L.per;
    const int mycol = lane < cnt ? __ldg(colind + b0 + lane) : 0;
    const T* base = values + static_cast<long long>(b0) * L.size + lane;
    for (int j0 = 0; j0 < steps; j0 += kStepsSmall) {
      T a[kStepsSmall], xv[kStepsSmall];
#pragma unroll
      for (int u = 0; u < kStepsSmall; ++u) {
        const int e = (j0 + u) * L.per + L.g;
        a[u] = L.on && e < cnt
                   ? __ldcs(base + static_cast<long long>(j0 + u) * L.used)
                   : T(0);
      }
#pragma unroll
      for (int u = 0; u < kStepsSmall; ++u) {
        const int e = (j0 + u) * L.per + L.g;
        const int col = __shfl_sync(~0u, mycol, e & 31);
        const long long at = static_cast<long long>(col) * L.bw + L.c;
        xv[u] = L.on && e < cnt && at < n ? __ldg(x + at) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kStepsSmall; ++u) acc = fma(a[u], xv[u], acc);
    }
  }
}

// row i from its stage: the staged blocks' x gathers, all issued before
// their FMAs, then the row's blocks past the stage, then the fold (lanes
// of column 0 add their row's columns in order, then lanes of block 0
// their row's blocks of the step) and y
template <typename T>
__device__ __forceinline__ void row_finish(const T* __restrict__ values,
                                           const int* __restrict__ colind,
                                           const T* __restrict__ x,
                                           T* __restrict__ y, long long n,
                                           const SmallLanes& L, int lane,
                                           long long i, const Stage<T>& st) {
  const int lo = st.lo, hi = st.hi;
  const T* v = st.v + st.skip + lane;
  const int cnt = min(L.head, hi - lo);
  T xv[kStepsSmall];
#pragma unroll
  for (int u = 0; u < kStepsSmall; ++u) {
    const int e = u * L.per + L.g;
    const bool ok = L.on && e < cnt;
    const long long at =
        static_cast<long long>(ok ? st.col[e] : 0) * L.bw + L.c;
    xv[u] = ok && at < n ? __ldg(x + at) : T(0);
  }
  T acc = T(0);
#pragma unroll
  for (int u = 0; u < kStepsSmall; ++u) {
    const int e = u * L.per + L.g;
    acc = fma(L.on && e < cnt ? v[u * L.used] : T(0), xv[u], acc);
  }
  row_rest(values, colind, x, n, L, lane, lo + cnt, hi, acc);
  T row = acc;
  for (int k = 1; k < L.bw; ++k) row += __shfl_down_sync(~0u, acc, k);
  T sum = row;
  for (int k = 1; k < L.per; ++k)
    sum += __shfl_down_sync(~0u, row, k * L.size);
  if (L.on && L.g == 0 && L.c == 0) y[i * L.bh + L.r] = sum;
}

// warp w of W walks block rows w, w + W, ...: the row K - 1 on is staged
// while a row is summed (K: the ring's stages), all warps in one window
// of rows, so the values stream in order; the rowptr pairs of the warp's
// next 32 rows sit in lane registers (lane t: row 32b + t's), the
// following batch loaded 16 rows before it is needed
template <typename T>
__global__ void __launch_bounds__(32 * kSmallWarps,
                                  sizeof(T) == 4 ? kMinSmall : kMinSmall64)
bsr_small(const T* __restrict__ values, const int* __restrict__ rowptr,
          const int* __restrict__ colind, const T* __restrict__ x,
          T* __restrict__ y, long long mb, int bh, int bw, long long n) {
  constexpr int kStages = sizeof(T) == 4 ? kRing : kRing64;
  __shared__ Stage<T> ring[kSmallWarps][kStages];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kSmallWarps;
  const long long first =
      static_cast<long long>(blockIdx.x) * kSmallWarps + warp;
  if (first >= mb) return;  // uniform across the warp
  SmallLanes L;
  L.bh = bh;
  L.bw = bw;
  L.size = bh * bw;
  L.per = 32 / L.size;
  L.used = L.per * L.size;
  L.batch = L.per * (32 / L.per);
  L.head = min(L.batch, kStepsSmall * L.per);
  L.g = lane / L.size;
  const int pos = lane - L.g * L.size;
  L.r = pos / bw;
  L.c = pos - L.r * bw;
  L.on = lane < L.used;
  Stage<T>* st = ring[warp];
  // rowptr pair of this warp's row m (row first + m * stride)
  const auto pair = [&](int m, int& lo, int& hi) {
    const long long j = first + static_cast<long long>(m) * stride;
    lo = hi = 0;
    if (j < mb) {
      lo = rowptr[j];
      hi = rowptr[j + 1];
    }
  };
  int blo, bhi, nlo = 0, nhi = 0;
  pair(lane, blo, bhi);
  // stage row m (rows are staged in order of m)
  const auto stage_at = [&](int m) {
    if ((m & 31) == 16) pair(((m >> 5) + 1) * 32 + lane, nlo, nhi);
    if ((m & 31) == 0 && m > 0) {
      blo = nlo;
      bhi = nhi;
    }
    const int lo = __shfl_sync(~0u, blo, m & 31);
    const int hi = __shfl_sync(~0u, bhi, m & 31);
    if (first + static_cast<long long>(m) * stride < mb) {
      stage_row(values, colind, L, lane, lo, hi, st[m % kStages]);
    } else {
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  };
  for (int m = 0; m < kStages - 1; ++m) stage_at(m);
  int k = 0;
  for (long long j = first; j < mb; j += stride, ++k) {
    stage_at(k + kStages - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    row_finish(values, colind, x, y, n, L, lane, j, st[k % kStages]);
    __syncwarp();
  }
}

constexpr int kCols = 0, kSpan = 1, kSmall = 2;

unsigned grid_of(long long warps) {
  return static_cast<unsigned>((warps + kThreads / 32 - 1) / (kThreads / 32));
}

template <typename T, int V>
void launch_cols(const T* v, const int* rp, const int* ci, const T* x, T* y,
                 long long rows, int bh, int bw, long long n,
                 cudaStream_t s) {
  // at most 16 bytes a piece set (NC*V values), so a group of kGroup
  // blocks holds 32 registers of values and x in f32 and f64 alike (at
  // 64 registers, f64 with 32 bytes spilled 184-252 bytes)
  constexpr int kNc = 16 / (V * static_cast<int>(sizeof(T))) > 1
                          ? 16 / (V * static_cast<int>(sizeof(T)))
                          : 1;
  bsr_cols<T, V, kNc><<<grid_of(rows), kThreads, 0, s>>>(
      v, rp, ci, x, y, rows, bh, bw, n);
}

int log2_exact(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return (1 << k) == v ? k : -1;
}

template <typename T>
int launch(const void* values, const void* rowptr, const void* colind,
           const void* x, void* y, int mb, int bh, int bw, long long n,
           int mapping, int vec, void* stream) {
  const T* v = static_cast<const T*>(values);
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(colind);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(mb) * bh;
  const int vmax = 16 / static_cast<int>(sizeof(T));
  if (bh <= 0 || bw <= 0 || n < 0 || vec <= 0 || vec > vmax ||
      bw % vec != 0 || log2_exact(vec) < 0 ||
      (rows * 32 + kThreads - 1) / kThreads > 0x7fffffffLL ||
      (static_cast<long long>(mb) * 32 + kThreads - 1) / kThreads >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mb == 0) return static_cast<int>(cudaGetLastError());
  if (mapping == kCols) {
    if (vec == 1)
      launch_cols<T, 1>(v, rp, ci, xx, yy, rows, bh, bw, n, s);
    else if (vec == 2)
      launch_cols<T, 2>(v, rp, ci, xx, yy, rows, bh, bw, n, s);
    else
      launch_cols<T, (sizeof(T) == 4 ? 4 : 2)>(v, rp, ci, xx, yy, rows, bh,
                                               bw, n, s);
  } else if (mapping == kSpan) {
    const int size = bh * bw;
    const int lb_shift = log2_exact(size / vec);
    const int c_shift = log2_exact(bw / vec);
    if (log2_exact(size) < 0 || size > 32 * vec || lb_shift < 0 ||
        c_shift < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec == 1)
      bsr_span<T, 1><<<grid_of(mb), kThreads, 0, s>>>(
          v, rp, ci, xx, yy, mb, bh, bw, n, lb_shift, c_shift);
    else if (vec == 2)
      bsr_span<T, 2><<<grid_of(mb), kThreads, 0, s>>>(
          v, rp, ci, xx, yy, mb, bh, bw, n, lb_shift, c_shift);
    else
      bsr_span<T, (sizeof(T) == 4 ? 4 : 2)><<<grid_of(mb), kThreads, 0, s>>>(
          v, rp, ci, xx, yy, mb, bh, bw, n, lb_shift, c_shift);
  } else if (mapping == kSmall) {
    if (bh * bw > 32) return static_cast<int>(cudaErrorInvalidValue);
    // persistent: as many CTAs as the card holds at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bsr_small<T>,
                                                  32 * kSmallWarps, 0);
    long long grid = (mb + kSmallWarps - 1) / kSmallWarps;
    const long long full = static_cast<long long>(sms) * per_sm;
    if (full > 0 && full < grid) grid = full;
    bsr_small<T><<<static_cast<unsigned>(grid), 32 * kSmallWarps, 0, s>>>(
        v, rp, ci, xx, yy, mb, bh, bw, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: (capacity, bh, bw) row-major; rowptr: (mb + 1,) int32; colind:
// (capacity,) int32; x: (n,), read as zeros past n; y: (mb * bh,).  One
// dtype for values, x and y.  mapping: 0 cols, 1 span, 2 small; vec: the
// elements of one load (1, 2 or 16 bytes' worth), dividing bw, with
// values and x aligned to it.
extern "C" int bsr_spmv_f32(const void* values, const void* rowptr,
                            const void* colind, const void* x, void* y,
                            int mb, int bh, int bw, long long n,
                            int mapping, int vec, void* stream) {
  return launch<float>(values, rowptr, colind, x, y, mb, bh, bw, n, mapping,
                       vec, stream);
}

extern "C" int bsr_spmv_f64(const void* values, const void* rowptr,
                            const void* colind, const void* x, void* y,
                            int mb, int bh, int bw, long long n,
                            int mapping, int vec, void* stream) {
  return launch<double>(values, rowptr, colind, x, y, mb, bh, bw, n,
                        mapping, vec, stream);
}

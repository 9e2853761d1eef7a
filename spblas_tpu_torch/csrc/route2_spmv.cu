// ROUTE2 chunk SpMV for Hopper: one launch runs the chunks [lo, hi) of a
// ROUTE2 plan (spblas_tpu_torch/kernels/route2.py), reading the source
// pane `src` and publishing into the destination pane `dst` with atomic
// adds.
//
// Replaces the TPU kernel spblas_tpu/kernels/route2_kernel.py::
// _route2_kernel (pl.pallas_call in route2_dispatch).  Per (8, 128) chunk
// (one int32 tile of routing fields plus one f32 value tile, 8 KB):
//   t1[a,l]  = src[(sb + r2[a,l]) * 128 + l]    slab-row route
//   t2[a,jd] = t1[a, lf[a,jd]]                  lane gather
//   t3[d,jd] = t2[sd2[d,jd], jd]                depth drop
//   c        = t3 * val; P = segmented prefix of c down the 8 depths,
//              steps 1, 2, 4 up to dist_max, where dist >= step
//   RS[s,j]  = P[pend[s,j], j], then with any_lane RS[s, lsrc[s,j]];
//              masked by vA
//   dst[(yb + 8*subw + i) * 128 + j] += RS[s,j], with i = s, or
//              (s - rho_sel) & 7 on a rotated plan
// Flag-2 (hub) chunks sum the whole t1 * val tile to one scalar and
// publish it at their vA slots.  Which pane a chunk reads is the
// caller's choice per launch: x for the first launch (flag-0 and flag-2
// chunks), the output pane itself for each aux level after it.
//
// Differences from the TPU kernel, and why:
// - The TPU grid runs chunks in order, so aux chunks there read pane
//   slots that earlier chunks of the same dispatch wrote.  CUDA blocks
//   run in no order; the wrapper launches once per aux level instead,
//   and no chunk of a launch reads a pane row another chunk of the same
//   launch writes.  That is why src and dst may alias and are not
//   __restrict__.
// - Many chunks publish into one y window (up to 132 on the spill
//   fixtures), so the publish is an atomicAdd per published slot; the
//   order of the sums into one row then differs from run to run.
// - Every slab row is bounded by src_rows and reads 0 past it, as the
//   numpy oracle zero-fills; chunk and pane offsets are 64-bit.
// - Bit fields that reach bit 31 (lsrc, subw) are read from the unsigned
//   tile word, shifted then masked.
//
// What bounds it on the H100: bytes, 8 KB of plan stream per chunk plus
// the x pane and the output pane (about 40 MB, 12 us at 3.35 TB/s, for
// the uniform 300k degree-10 plan).  This first design does not reach
// it: the slab gather reads one 4-byte word per thread from scattered
// rows of x (x stays in L2, but each warp-wide load touches up to 32
// sectors), and the publish is atomic.
//
// Design: one 128-thread block per chunk, thread j owning lane column j.
// The tile and value columns are read coalesced (one 512-byte row per
// depth).  t1, and with any_lane the publish values, are staged in 4 KB
// of shared memory for the two lane gathers; the depth drop, the prefix
// and the pend select are thread-local.

#include <cuda_runtime.h>

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;

// v[idx] for idx in 0..7 without dynamic register indexing
__device__ __forceinline__ float pick8(const float (&v)[kSubs], int idx) {
  float out = v[0];
#pragma unroll
  for (int a = 1; a < kSubs; ++a) out = (idx == a) ? v[a] : out;
  return out;
}

__device__ __forceinline__ int bits(unsigned t, int shift, unsigned mask) {
  return static_cast<int>((t >> shift) & mask);
}

__global__ void route2_spmv_kernel(
    const int* __restrict__ tile, const float* __restrict__ val,
    const int* __restrict__ slab_base, const int* __restrict__ y_base,
    const int* __restrict__ src_flag, const int* __restrict__ rho,
    long long lo, const float* src, long long src_rows, float* dst,
    long long dst_rows, int g, int dist_max, int any_lane, int ww,
    int rotated) {
  __shared__ float s_t1[kSubs][kLanes];
  __shared__ float s_rs[kSubs][kLanes];
  __shared__ float s_red[kLanes / 32];

  const long long k = lo + blockIdx.x;
  const int j = threadIdx.x;
  const long long base = k * (kSubs * kLanes);
  const long long sb = slab_base[k];
  const int flag = src_flag[k];

  unsigned t[kSubs];
  float v[kSubs];
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    t[a] = static_cast<unsigned>(tile[base + a * kLanes + j]);
    v[a] = val[base + a * kLanes + j];
  }

  // slab-row route: t1[a, j] = src[(sb + r2[a, j]) * 128 + j]
  const int r2_max = kSubs * g - 1;
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    const long long row = sb + min(bits(t[a], 0, 255), r2_max);
    s_t1[a][j] = row < src_rows ? src[row * kLanes + j] : 0.f;
  }
  __syncthreads();

  float rs[kSubs];
  if (flag == 2) {
    // hub chunk: identity lanes, the whole tile sums to one scalar
    float part = 0.f;
#pragma unroll
    for (int a = 0; a < kSubs; ++a) part += s_t1[a][j] * v[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if ((j & 31) == 0) s_red[j >> 5] = part;
    __syncthreads();
    const float sum = s_red[0] + s_red[1] + s_red[2] + s_red[3];
#pragma unroll
    for (int s = 0; s < kSubs; ++s) rs[s] = sum;
  } else {
    // lane gather, then depth drop and multiply
    float t2[kSubs];
#pragma unroll
    for (int a = 0; a < kSubs; ++a) t2[a] = s_t1[a][bits(t[a], 8, 127)];
    float p[kSubs];
#pragma unroll
    for (int d = 0; d < kSubs; ++d) p[d] = pick8(t2, bits(t[d], 15, 7)) * v[d];
    // segmented prefix with the simultaneous semantics of a roll: run
    // i downward so P[i - step] is still the previous step's value (the
    // loops unroll fully, so p stays in registers)
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int step = 1 << e;
      if (step > dist_max) break;
#pragma unroll
      for (int i = kSubs - 1; i >= step; --i) {
        if (bits(t[i], 18, 7) >= step) p[i] += p[i - step];
      }
    }
#pragma unroll
    for (int s = 0; s < kSubs; ++s) rs[s] = pick8(p, bits(t[s], 21, 7));
    if (any_lane) {
      // the publish reads its segment sum from lane lsrc
#pragma unroll
      for (int s = 0; s < kSubs; ++s) s_rs[s][j] = rs[s];
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSubs; ++s) rs[s] = s_rs[s][bits(t[s], 25, 127)];
    }
  }

  // publish every vA slot
  const long long yb = y_base[k];
  const int rk = (rotated && flag != 2) ? rho[k] : 0;
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    if (!bits(t[s], 24, 1)) continue;
    int i = s;
    if (rotated && flag != 2) {
      const int r = bits(t[s], 28, 1) ? ((rk >> 17) & 7) : ((rk >> 7) & 7);
      i = (s - r) & 7;
    }
    int sw = 0;
    if (ww > 1) {
      sw = bits(t[s], 29, 7);
      if (sw >= ww) continue;
    }
    const long long row = yb + sw * kSubs + i;
    if (row < dst_rows) atomicAdd(dst + row * kLanes + j, rs[s]);
  }
}

}  // namespace

// tile, val: (nchunks, 8, 128) int32 / f32; slab_base, y_base, src_flag,
// rho: (nchunks,) int32 (rho may be null unless rotated); src:
// (src_rows, 128) f32; dst: (dst_rows, 128) f32, accumulated into.
extern "C" int route2_spmv_f32(const void* tile, const void* val,
                               const void* slab_base, const void* y_base,
                               const void* src_flag, const void* rho,
                               long long lo, long long hi, const void* src,
                               long long src_rows, void* dst,
                               long long dst_rows, int g, int dist_max,
                               int any_lane, int ww, int rotated,
                               void* stream) {
  if (hi > lo) {
    route2_spmv_kernel<<<static_cast<unsigned>(hi - lo), kLanes, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile), static_cast<const float*>(val),
        static_cast<const int*>(slab_base), static_cast<const int*>(y_base),
        static_cast<const int*>(src_flag), static_cast<const int*>(rho), lo,
        static_cast<const float*>(src), src_rows, static_cast<float*>(dst),
        dst_rows, g, dist_max, any_lane, ww, rotated);
  }
  return static_cast<int>(cudaGetLastError());
}

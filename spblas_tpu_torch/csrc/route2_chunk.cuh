// The ROUTE2 chunk body, shared by route2_spmv.cu (resident plans) and
// route_paned_spmv.cu (paned plans), and its slab-row route, which the
// SpGEMM chunk body (route2_mul_chunk.cuh) shares too: one (8, 128) chunk of a ROUTE2
// layout (spblas_tpu_torch/kernels/route2.py), run by a 128-thread block
// whose thread j owns lane column j.  It is the Hopper form of
// spblas_tpu/kernels/route2_kernel.py::_chunk_body.
//
// Per chunk (one int32 tile of routing fields plus one f32 value tile):
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
// publish it at their vA slots.
//
// Every slab row is bounded by src_rows and reads 0 past it, as the
// numpy oracle zero-fills; chunk and pane offsets are 64-bit.  Bit
// fields that reach bit 31 (lsrc, subw) are read from the unsigned tile
// word, shifted then masked.  src and dst may alias (aux chunks read the
// pane they publish into), so neither is __restrict__.  The publish is
// an atomicAdd per published slot: many chunks publish into one window.
//
// t1 and, with any_lane, the publish values pass through 4 KB of shared
// memory each for the two lane gathers; the depth drop, the prefix and
// the pend select are thread-local.

#pragma once

#include <cuda_runtime.h>

namespace route2 {

constexpr int kSubs = 8;
constexpr int kLanes = 128;

struct Shared {
  float t1[kSubs][kLanes];
  float rs[kSubs][kLanes];
  float red[kLanes / 32];
};

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

// The slab-row route of thread j's lane column: dst[a][j] = src[(sb +
// r2[a, j]) * 128 + j], r2 the 8-bit field at bit `shift` of t[a],
// bounded by the slab's 8g rows; rows at or past src_rows read 0.  The
// caller synchronises the block before reading dst across lanes.
__device__ __forceinline__ void slab_route(float (&dst)[kSubs][kLanes],
                                           const unsigned (&t)[kSubs],
                                           int shift, long long sb,
                                           const float* src,
                                           long long src_rows, int g) {
  const int j = threadIdx.x;
  const int r2_max = kSubs * g - 1;
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    const long long row = sb + min(bits(t[a], shift, 255), r2_max);
    dst[a][j] = row < src_rows ? src[row * kLanes + j] : 0.f;
  }
}

// Chunk k: slab base row sb of src, flag 0/1 (the chunk body) or 2 (hub
// sum), publish window yb of dst.  rho (rotated plans only) holds
// rho0 | rho1 << 10 per chunk.  With `stream` the tile and values are
// loaded evict-first (ld.cs): a plan streamed once past the L2 then does
// not push x and the output out of it.  All 128 threads of the block must call
// it (it synchronises the block).
__device__ __forceinline__ void chunk(
    Shared& sh, const int* __restrict__ tile, const float* __restrict__ val,
    const int* __restrict__ rho, long long k, long long sb, int flag,
    long long yb, const float* src, long long src_rows, float* dst,
    long long dst_rows, int g, int dist_max, int any_lane, int ww,
    int rotated, bool stream = false) {
  const int j = threadIdx.x;
  const long long base = k * (kSubs * kLanes);

  unsigned t[kSubs];
  float v[kSubs];
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    const long long q = base + a * kLanes + j;
    t[a] = static_cast<unsigned>(stream ? __ldcs(tile + q) : tile[q]);
    v[a] = stream ? __ldcs(val + q) : val[q];
  }

  slab_route(sh.t1, t, 0, sb, src, src_rows, g);
  __syncthreads();

  float rs[kSubs];
  if (flag == 2) {
    // hub chunk: identity lanes, the whole tile sums to one scalar
    float part = 0.f;
#pragma unroll
    for (int a = 0; a < kSubs; ++a) part += sh.t1[a][j] * v[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if ((j & 31) == 0) sh.red[j >> 5] = part;
    __syncthreads();
    const float sum = sh.red[0] + sh.red[1] + sh.red[2] + sh.red[3];
#pragma unroll
    for (int s = 0; s < kSubs; ++s) rs[s] = sum;
  } else {
    // lane gather, then depth drop and multiply
    float t2[kSubs];
#pragma unroll
    for (int a = 0; a < kSubs; ++a) t2[a] = sh.t1[a][bits(t[a], 8, 127)];
    float p[kSubs];
#pragma unroll
    for (int d = 0; d < kSubs; ++d)
      p[d] = pick8(t2, bits(t[d], 15, 7)) * v[d];
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
      for (int s = 0; s < kSubs; ++s) sh.rs[s][j] = rs[s];
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSubs; ++s) rs[s] = sh.rs[s][bits(t[s], 25, 127)];
    }
  }

  // publish every vA slot
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

}  // namespace route2

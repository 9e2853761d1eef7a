// The ROUTE2-mul chunk body, shared by route2_mul.cu (resident plans) and
// route_mul_paned.cu (paned plans): one (8, 128) chunk of a fused SpGEMM
// numeric plan (spblas_tpu_torch/kernels/route2.py Route2MulPlan), run by
// a 128-thread block whose thread j owns lane column j.  It is the Hopper
// form of spblas_tpu/kernels/route2_kernel.py::_mul_chunk_body.
//
// Per chunk (two int32 tiles: t1 carries the B chain and the common
// fields, t2 the A chain; no value tile, the values are gathered fresh
// from the panes):
//   uX[a,l]  = paneX[(baseX + r2X[a,l]) * 128 + l]   slab-row route
//   vX[a,jd] = uX[a, lfX[a,jd]]                       lane gather
//   wX[d,jd] = vX[sd2X[d,jd], jd]                     depth drop
//   c        = wA * wB; P = segmented prefix of c down the 8 depths,
//              steps 1, 2, 4 up to dist_max, where dist >= step
//   out[(yb + s) * 128 + j] += P[pend[s,j], j] where vA[s,j]
// The prefix adds P[i - step] only for i >= step: rows that a roll would
// wrap add nothing, as in the numpy simulator (route2_mul_numpy); the
// packer never sets dist >= d on a sublane below d, so the TPU kernel's
// wrapping roll agrees.
//
// The slab route is route2_chunk.cuh's (bounded slab rows, 0 past the
// source's rows).  src and out may alias (aux chunks read the pane they
// publish into), so neither is __restrict__.  The publish is an atomicAdd
// per published slot: many chunks share one out window.

#pragma once

#include "route2_chunk.cuh"

namespace route2_mul {

using route2::bits;
using route2::kLanes;
using route2::kSubs;
using route2::pick8;

struct Shared {
  float a[kSubs][kLanes];
  float b[kSubs][kLanes];
};

// lane gather then depth drop of one chain: w[d] = u[sd2[d]][lf[sd2[d]]]
// for thread j's column, u the routed slab in shared memory
__device__ __forceinline__ void gather_chain(float (&w)[kSubs],
                                             const float (&u)[kSubs][kLanes],
                                             const unsigned (&t)[kSubs]) {
  float v[kSubs];
#pragma unroll
  for (int a = 0; a < kSubs; ++a) v[a] = u[a][bits(t[a], 8, 127)];
#pragma unroll
  for (int d = 0; d < kSubs; ++d) w[d] = pick8(v, bits(t[d], 15, 7));
}

// Chunk k: A slab at row ab of A (a_rows rows), B-side slab at row bb of
// src (src_rows rows: the B pane, or the out pane for aux chunks),
// publish window yb of out.  All 128 threads of the block must call it.
__device__ __forceinline__ void chunk(
    Shared& sh, const int* __restrict__ tile1, const int* __restrict__ tile2,
    long long k, long long ab, long long bb, long long yb,
    const float* __restrict__ A, long long a_rows, const float* src,
    long long src_rows, float* out, long long out_rows, int g_a, int g_b,
    int dist_max) {
  const int j = threadIdx.x;
  const long long base = k * (kSubs * kLanes);
  unsigned t1[kSubs], t2[kSubs];
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    t1[a] = static_cast<unsigned>(tile1[base + a * kLanes + j]);
    t2[a] = static_cast<unsigned>(tile2[base + a * kLanes + j]);
  }
  route2::slab_route(sh.a, t2, 0, ab, A, a_rows, g_a);
  route2::slab_route(sh.b, t1, 0, bb, src, src_rows, g_b);
  __syncthreads();

  float wa[kSubs], wb[kSubs], p[kSubs];
  gather_chain(wa, sh.a, t2);
  gather_chain(wb, sh.b, t1);
#pragma unroll
  for (int d = 0; d < kSubs; ++d) p[d] = wa[d] * wb[d];
  // segmented prefix with the simultaneous semantics of a roll (i runs
  // downward so P[i - step] is still the previous step's value)
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int step = 1 << e;
    if (step > dist_max) break;
#pragma unroll
    for (int i = kSubs - 1; i >= step; --i) {
      if (bits(t1[i], 18, 7) >= step) p[i] += p[i - step];
    }
  }
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    if (!bits(t1[s], 24, 1)) continue;
    const long long row = yb + s;
    if (row < out_rows)
      atomicAdd(out + row * kLanes + j, pick8(p, bits(t1[s], 21, 7)));
  }
}

}  // namespace route2_mul

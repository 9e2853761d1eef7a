// The ROUTE2 chunk body, shared by route2_spmv.cu (resident plans and
// the solve) and route_paned_spmv.cu (paned plans), and its slab-row
// route: one (8, 128) chunk of a ROUTE2 layout (spblas_tpu_torch/kernels/
// route2.py), run by 128 threads, thread j owning lane column j.  It is
// the Hopper form of spblas_tpu/kernels/route2_kernel.py::_chunk_body.
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
// t1 passes through 4 KB of shared memory for the lane gather.  The two
// sublane selects (the depth drop and the pend select) go through the
// thread's own column of a second 4 KB tile (one store and one load a
// value, as route_spmv.cu's pulls), which replaced two register select
// ladders of 7 selects a value: fewer instructions in a body that issue
// bounds.  With any_lane the publish values cross lanes through the same
// tile.  The SpMV kernels load the tile and values evict-first (ld.cs,
// the `stream` flag): a plan streamed once past the L2 then does not push
// x and the output out of it.  The solve loads them plainly: its plan is
// read again at every call and a factor's stays in the L2 (evict-first
// loads cost the 20k factor's solve 16 % of its device time; NVIDIA H100
// 80GB HBM3, 700 W; scripts/route_profile.py).  The body after the slab
// route (finish) is separate so that the slab-staged kernel of
// route2_spmv.cu, whose groups of 128 threads meet at named barriers,
// runs the same arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace route2 {

constexpr int kSubs = 8;
constexpr int kLanes = 128;

// the slab rows a chunk's threads gather (t1), each thread's column for
// the sublane selects and the any_lane pull (col), the hub sums; V is
// float, or float2 (re, im) for the complex body
template <class V>
struct SharedT {
  V t1[kSubs][kLanes];
  V col[kSubs][kLanes];
  V red[kLanes / 32];
};
using Shared = SharedT<float>;
using SharedCx = SharedT<float2>;

// the body's arithmetic on a value: f32, or complex64 as float2
__device__ __forceinline__ float vmul(float a, float b) { return a * b; }
__device__ __forceinline__ float2 vmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float vfma(float a, float b, float c) {
  return c + a * b;
}
__device__ __forceinline__ float2 vfma(float2 a, float2 b, float2 c) {
  return vadd(c, vmul(a, b));
}
__device__ __forceinline__ float vshfl_down(float v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float2 vshfl_down(float2 v, int off) {
  return make_float2(__shfl_down_sync(0xffffffffu, v.x, off),
                     __shfl_down_sync(0xffffffffu, v.y, off));
}
template <class V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 vzero<float2>() {
  return make_float2(0.f, 0.f);
}
// a gathered source value as the body's type: a real x in a complex
// product is (x, 0)
template <class V>
__device__ __forceinline__ V widen(float x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float2 widen<float2>(float x) {
  return make_float2(x, 0.f);
}
template <class V>
__device__ __forceinline__ V widen(float2 x) { return x; }

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
// bounded by the slab's 8g rows; rows at or past src_rows read 0.  With
// `l2` the rows are read through L2 (ld.cg): other blocks write src
// during the launch (the persistent solve), and L1 is not coherent.  The
// caller synchronises the block before reading dst across lanes.
// The complex body gathers float2 rows, or float rows of a real x
// (widened to (x, 0)).
template <class V, class X>
__device__ __forceinline__ void slab_route(V (&dst)[kSubs][kLanes],
                                           const unsigned (&t)[kSubs],
                                           int shift, long long sb,
                                           const X* src,
                                           long long src_rows, int g,
                                           bool l2 = false) {
  const int j = threadIdx.x;
  const int r2_max = kSubs * g - 1;
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    const long long row = sb + min(bits(t[a], shift, 255), r2_max);
    dst[a][j] = row >= src_rows ? vzero<V>()
                : l2            ? widen<V>(__ldcg(src + row * kLanes + j))
                                : widen<V>(src[row * kLanes + j]);
  }
}

// thread j's lane column of chunk k's routing tile and values, loaded
// evict-first (ld.cs) with `stream`
__device__ __forceinline__ void load_lanes(unsigned (&t)[kSubs],
                                           float (&v)[kSubs],
                                           const int* __restrict__ tile,
                                           const float* __restrict__ val,
                                           long long k, int j, bool stream) {
  const long long q = k * (kSubs * kLanes) + j;
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    const long long i = q + a * kLanes;
    t[a] = static_cast<unsigned>(stream ? __ldcs(tile + i) : tile[i]);
    v[a] = stream ? __ldcs(val + i) : val[i];
  }
}

// thread j's lane column of chunk k's routing tile and complex values
// (the real plane val, the imaginary plane val_im), loaded evict-first
__device__ __forceinline__ void load_lanes_cx(
    unsigned (&t)[kSubs], float2 (&v)[kSubs], const int* __restrict__ tile,
    const float* __restrict__ val, const float* __restrict__ val_im,
    long long k, int j) {
  const long long q = k * (kSubs * kLanes) + j;
#pragma unroll
  for (int a = 0; a < kSubs; ++a) {
    const long long i = q + a * kLanes;
    t[a] = static_cast<unsigned>(__ldcs(tile + i));
    v[a] = make_float2(__ldcs(val + i), __ldcs(val_im + i));
  }
}

// out[i] = in[field(t[i])] through the thread's own column of `col`
template <class V>
__device__ __forceinline__ void pull(V (&out)[kSubs], const V (&in)[kSubs],
                                     const unsigned (&t)[kSubs], int shift,
                                     V (&col)[kSubs][kLanes], int j) {
#pragma unroll
  for (int i = 0; i < kSubs; ++i) col[i][j] = in[i];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) out[i] = col[bits(t[i], shift, 7)][j];
}

// the barrier of a chunk's 128 threads: the whole block (a block a
// chunk), or a named barrier of its own (route2_spmv.cu's slab kernel)
struct BlockBarrier {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct GroupBarrier {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kLanes) : "memory");
  }
};

// One chunk after its slab rows are in sh.t1 and past the barrier: lane
// gather, depth drop and multiply, segmented prefix, pend select,
// any_lane pull, publish into the window yb of dst.  rk is the chunk's
// rho (rotated plans only).  Every thread of the 128 must call it (it
// meets `bar` on hub and any_lane chunks).  V = float2 is the complex
// body (route2_spmv.cu's route2_cx_kernel): complex values, panes of
// (re, im) pairs, one float2 atomicAdd a published slot.
template <class Bar, class V>
__device__ __forceinline__ void finish(
    SharedT<V>& sh, const unsigned (&t)[kSubs], const V (&v)[kSubs],
    int flag, long long yb, int rk, V* dst, long long dst_rows,
    int dist_max, int any_lane, int ww, int rotated, int j, Bar bar) {
  V rs[kSubs];
  if (flag == 2) {
    // hub chunk: identity lanes, the whole tile sums to one scalar
    V part = vzero<V>();
#pragma unroll
    for (int a = 0; a < kSubs; ++a) part = vfma(sh.t1[a][j], v[a], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part = vadd(part, vshfl_down(part, off));
    if ((j & 31) == 0) sh.red[j >> 5] = part;
    bar();
    const V sum =
        vadd(vadd(vadd(sh.red[0], sh.red[1]), sh.red[2]), sh.red[3]);
#pragma unroll
    for (int s = 0; s < kSubs; ++s) rs[s] = sum;
  } else {
    // lane gather, then depth drop and multiply
    V t2[kSubs], p[kSubs];
#pragma unroll
    for (int a = 0; a < kSubs; ++a) t2[a] = sh.t1[a][bits(t[a], 8, 127)];
    pull(p, t2, t, 15, sh.col, j);
#pragma unroll
    for (int d = 0; d < kSubs; ++d) p[d] = vmul(p[d], v[d]);
    // segmented prefix with the simultaneous semantics of a roll: run
    // i downward so P[i - step] is still the previous step's value (the
    // loops unroll fully, so p stays in registers)
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int step = 1 << e;
      if (step > dist_max) break;
#pragma unroll
      for (int i = kSubs - 1; i >= step; --i) {
        if (bits(t[i], 18, 7) >= step) p[i] = vadd(p[i], p[i - step]);
      }
    }
    pull(rs, p, t, 21, sh.col, j);
    if (any_lane) {
      // the publish reads its segment sum from lane lsrc
#pragma unroll
      for (int s = 0; s < kSubs; ++s) sh.col[s][j] = rs[s];
      bar();
#pragma unroll
      for (int s = 0; s < kSubs; ++s) rs[s] = sh.col[s][bits(t[s], 25, 127)];
    }
  }

  // publish every vA slot
  const bool rot = rotated && flag != 2;
  V* out = dst + yb * kLanes + j;
  const long long lim = dst_rows - yb;   // window rows in bounds
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    if (!bits(t[s], 24, 1)) continue;
    int i = s;
    if (rot) {
      const int r = bits(t[s], 28, 1) ? ((rk >> 17) & 7) : ((rk >> 7) & 7);
      i = (s - r) & 7;
    }
    int sw = 0;
    if (ww > 1) {
      sw = bits(t[s], 29, 7);
      if (sw >= ww) continue;
    }
    const int row = sw * kSubs + i;
    if (row < lim) atomicAdd(out + row * kLanes, rs[s]);
  }
}

// Chunk k, run by a 128-thread block: slab base row sb of src, flag 0/1
// (the chunk body) or 2 (hub sum), publish window yb of dst.  rho
// (rotated plans only) holds rho0 | rho1 << 10 per chunk; `stream` loads
// the plan evict-first.  All 128 threads of the block must call it (it
// synchronises the block).
__device__ __forceinline__ void chunk(
    Shared& sh, const int* __restrict__ tile, const float* __restrict__ val,
    const int* __restrict__ rho, long long k, long long sb, int flag,
    long long yb, const float* src, long long src_rows, float* dst,
    long long dst_rows, int g, int dist_max, int any_lane, int ww,
    int rotated, bool stream) {
  const int j = threadIdx.x;
  unsigned t[kSubs];
  float v[kSubs];
  load_lanes(t, v, tile, val, k, j, stream);
  const int rk = (rotated && flag != 2) ? __ldg(rho + k) : 0;
  slab_route(sh.t1, t, 0, sb, src, src_rows, g);
  __syncthreads();
  finish(sh, t, v, flag, yb, rk, dst, dst_rows, dist_max, any_lane, ww,
         rotated, j, BlockBarrier{});
}

}  // namespace route2

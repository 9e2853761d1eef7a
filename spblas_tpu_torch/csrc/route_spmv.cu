// ROUTE v1 chunk SpMV for Hopper: one launch runs every chunk of one
// level of a ROUTE v1 plan (spblas_tpu_torch/kernels/route_plan.py),
// reading the packed x pane and publishing into that level's output pane
// (y, then the aux region) with atomic adds.
//
// Replaces the TPU kernel spblas_tpu/kernels/route_spmv.py::_route_kernel
// (pl.pallas_call in route_spmv).  Per (8, 128) chunk (two int32 tiles of
// routing fields and one f32 value tile, 12 KB):
//   vx[i,j] = x2[(sb + 8*oct[i,j] + i) * 128 + l[i,j]]   for oct < g, else 0
//   c       = vx * val
//   c       = c[q1[i,j], j]; c = c[i, q2[i,j]]; c = c[q3[i,j], j]    permute 1
//   P       = segmented prefix of c down the 8 sublanes, steps 1, 2, 4,
//             where dist >= step
//   RS      = P[p1[i,j], j]; RS = RS[i, p2[i,j]]; RS = RS[p3[i,j], j]  permute 2
//   pane[(yb + i) * 128 + j] += RS[i,j]                   where vA[i,j]
// with l, oct, q1, q2, q3 the tile1 fields at bits 3, 10, 13, 16, 23 and
// dist, vA, p1, p2, p3 the tile3 fields at bits 0, 3, 4, 7, 14.
//
// Differences from the TPU kernel, and why:
// - The gather is one load per slot from x in device memory (through L2),
//   not the TPU's g-way select of lane gathers over a VMEM-resident slab.
//   Slab rows are bounded by x_rows and read 0 past it (x_rows already
//   pads by 8g rows).
// - The TPU kernel's y += upd is safe only on its sequential grid: every
//   chunk of a stripe, across all its column windows, adds into the same
//   y window, and aux chunks into the same aux windows.  Here the publish
//   is an atomicAdd per vA slot, so sums into one row are taken in an
//   order that changes from run to run.
// - The recursive aux plan (aux slots of level d are the x of level
//   d + 1) is one launch per level, in stream order, each into a zeroed
//   pane: the wrapper's recursion, not this kernel.
// - The prefix runs i downward so P[i - step] is still the previous
//   step's value, the simultaneous semantics of the TPU's roll; wrapped
//   sublanes (i < step) add nothing, as the numpy simulator masks them.
// - tile1's fields end at bit 25 and tile3's at bit 16, so no field
//   reaches the sign bit; chunk offsets are 64-bit (1024 slots a chunk
//   overflow int32 past 2M chunks).
//
// What bounds it on the H100: bytes, 12 KB of plan stream per chunk
// (tile1, tile3, val) plus 8 B of per-chunk scalars, the x pane and the
// output pane written twice (zeroed, then accumulated): about 50 MB,
// 15 us at 3.35 TB/s, for the 4,029-chunk R-MAT 131k plan.
//
// Design: one 128-thread block per chunk, thread j owning lane column j
// and keeping its 8 sublanes in registers.  The tiles and values are
// read coalesced (one 512-byte row per sublane).  The four sublane pulls
// and the prefix are thread-local (select ladders, no dynamic register
// indexing); each of the two lane pulls passes through a 4 KB shared
// tile.

#include <cuda_runtime.h>

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;

__device__ __forceinline__ float pick8(const float (&v)[kSubs], int idx) {
  float out = v[0];
#pragma unroll
  for (int a = 1; a < kSubs; ++a) out = (idx == a) ? v[a] : out;
  return out;
}

__device__ __forceinline__ int bits(int t, int shift, int mask) {
  return (t >> shift) & mask;
}

__global__ void route_spmv_kernel(
    const int* __restrict__ tile1, const int* __restrict__ tile3,
    const float* __restrict__ val, const int* __restrict__ slab_base,
    const int* __restrict__ y_base, const float* __restrict__ x2,
    long long x_rows, float* __restrict__ pane, long long pane_rows,
    int g) {
  __shared__ float s[kSubs][kLanes];

  const long long k = blockIdx.x;
  const int j = threadIdx.x;
  const long long base = k * (kSubs * kLanes);
  const long long sb = slab_base[k];

  int a[kSubs], b[kSubs];
  float c[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    a[i] = tile1[base + i * kLanes + j];
    b[i] = tile3[base + i * kLanes + j];
  }

  // gather: vx[i, j] = x2[sb + 8*oct + i, l] for oct < g
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    const int oct = bits(a[i], 10, 7);
    const long long row = sb + kSubs * oct + i;
    float vx = 0.f;
    if (oct < g && row < x_rows) vx = x2[row * kLanes + bits(a[i], 3, 127)];
    c[i] = vx * val[base + i * kLanes + j];
  }

  // permute 1: sublane pull q1, lane pull q2 (shared), sublane pull q3
  float t[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) t[i] = pick8(c, bits(a[i], 13, 7));
#pragma unroll
  for (int i = 0; i < kSubs; ++i) s[i][j] = t[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSubs; ++i) c[i] = s[i][bits(a[i], 16, 127)];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) t[i] = pick8(c, bits(a[i], 23, 7));

  // segmented prefix down the sublanes, masked by the distance field
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int step = 1 << e;
#pragma unroll
    for (int i = kSubs - 1; i >= step; --i) {
      if (bits(b[i], 0, 7) >= step) t[i] += t[i - step];
    }
  }

  // permute 2: sublane pull p1, lane pull p2 (shared), sublane pull p3
#pragma unroll
  for (int i = 0; i < kSubs; ++i) c[i] = pick8(t, bits(b[i], 4, 7));
  __syncthreads();                 // every lane pull of permute 1 is done
#pragma unroll
  for (int i = 0; i < kSubs; ++i) s[i][j] = c[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSubs; ++i) t[i] = s[i][bits(b[i], 7, 127)];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) c[i] = pick8(t, bits(b[i], 14, 7));

  // publish every vA slot into the (8, 128) window at y_base
  const long long yb = y_base[k];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    const long long row = yb + i;
    if (bits(b[i], 3, 1) && row < pane_rows)
      atomicAdd(pane + row * kLanes + j, c[i]);
  }
}

}  // namespace

// tile1, tile3, val: (nchunks, 8, 128) int32 / int32 / f32; slab_base,
// y_base: (nchunks,) int32; x2: (x_rows, 128) f32; pane: (pane_rows, 128)
// f32, accumulated into.
extern "C" int route_spmv_f32(const void* tile1, const void* tile3,
                              const void* val, const void* slab_base,
                              const void* y_base, long long nchunks,
                              const void* x2, long long x_rows, void* pane,
                              long long pane_rows, int g, void* stream) {
  if (nchunks > 0) {
    route_spmv_kernel<<<static_cast<unsigned>(nchunks), kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile1), static_cast<const int*>(tile3),
        static_cast<const float*>(val), static_cast<const int*>(slab_base),
        static_cast<const int*>(y_base), static_cast<const float*>(x2),
        x_rows, static_cast<float*>(pane), pane_rows, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// ROUTE2-mul fused SpGEMM numeric for Hopper: one launch runs the chunks
// [lo, hi) of a resident plan (spblas_tpu_torch/kernels/route2.py
// Route2MulPlan), gathering A values from the A pane and B values from
// `src`, and publishing into the out pane with atomic adds.  The chunk
// body is route2_mul_chunk.cuh's.
//
// Replaces the TPU kernel spblas_tpu/kernels/route2_kernel.py::
// _route2_mul_kernel (pl.pallas_call in route2_mul):
//   c[slot] = sum of A[sa] * B[sb] over the expansion entries of slot.
//
// Differences from the TPU kernel, and why:
// - The TPU grid runs chunks in order, so its aux chunks (src_flag 1)
//   read out-pane slots that earlier chunks of the same dispatch wrote.
//   CUDA blocks run in no order: the wrapper launches once over the
//   flag-0 chunks with src = the B pane, then once per aux level with
//   src = the out pane (Route2MulPlan.launch_starts).  No chunk of a
//   launch reads a pane row another chunk of it writes.
// - Chunks that share a y_base exist; the TPU's y[yb] += upd was safe on
//   its sequential grid.  Here the publish is an atomicAdd per published
//   slot, so the sums into one slot are taken in an order that changes
//   from run to run.
//
// What bounds it on the H100: bytes, the two 4 KB tiles of every chunk
// plus 12 B of per-chunk scalars, the A and B panes once and the out
// pane twice (zeroed, then accumulated).  This first design does not
// reach it: each slab-row route reads one 4-byte word per thread from
// scattered pane rows (the panes stay in L2), and the publish is atomic.
//
// Design: one 128-thread block per chunk, thread j owning lane column j;
// the two tiles are read coalesced (one 512-byte row per depth), the two
// routed slabs pass through 8 KB of shared memory for the lane gathers.

#include "route2_mul_chunk.cuh"

namespace {

__global__ void route2_mul_kernel(
    const int* __restrict__ tile1, const int* __restrict__ tile2,
    const int* __restrict__ a_base, const int* __restrict__ b_base,
    const int* __restrict__ y_base, long long lo,
    const float* __restrict__ A, long long a_rows, const float* src,
    long long src_rows, float* out, long long out_rows, int g_a, int g_b,
    int dist_max) {
  __shared__ route2_mul::Shared sh;
  const long long k = lo + blockIdx.x;
  route2_mul::chunk(sh, tile1, tile2, k, a_base[k], b_base[k], y_base[k],
                    A, a_rows, src, src_rows, out, out_rows, g_a, g_b,
                    dist_max);
}

}  // namespace

// tile1, tile2: (nchunks, 8, 128) int32; a_base, b_base, y_base:
// (nchunks,) int32; A: (a_rows, 128) f32; src: (src_rows, 128) f32, the
// B pane or the out pane itself; out: (out_rows, 128) f32, accumulated
// into.
extern "C" int route2_mul_f32(const void* tile1, const void* tile2,
                              const void* a_base, const void* b_base,
                              const void* y_base, long long lo,
                              long long hi, const void* A, long long a_rows,
                              const void* src, long long src_rows,
                              void* out, long long out_rows, int g_a,
                              int g_b, int dist_max, void* stream) {
  if (hi > lo) {
    route2_mul_kernel<<<static_cast<unsigned>(hi - lo), route2::kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile1), static_cast<const int*>(tile2),
        static_cast<const int*>(a_base), static_cast<const int*>(b_base),
        static_cast<const int*>(y_base), lo, static_cast<const float*>(A),
        a_rows, static_cast<const float*>(src), src_rows,
        static_cast<float*>(out), out_rows, g_a, g_b, dist_max);
  }
  return static_cast<int>(cudaGetLastError());
}

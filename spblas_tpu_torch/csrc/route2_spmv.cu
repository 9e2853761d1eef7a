// ROUTE2 chunk SpMV for Hopper: one launch runs the chunks [lo, hi) of a
// ROUTE2 plan (spblas_tpu_torch/kernels/route2.py), reading the source
// pane `src` and publishing into the destination pane `dst` with atomic
// adds.  The chunk body is route2_chunk.cuh's, shared with
// route_paned_spmv.cu.
//
// Replaces the TPU kernel spblas_tpu/kernels/route2_kernel.py::
// _route2_kernel (pl.pallas_call in route2_dispatch).  Which pane a
// chunk reads is the caller's choice per launch: x for the first launch
// (flag-0 and flag-2 chunks), the output pane itself for each aux level
// after it.
//
// Differences from the TPU kernel, and why:
// - The TPU grid runs chunks in order, so aux chunks there read pane
//   slots that earlier chunks of the same dispatch wrote.  CUDA blocks
//   run in no order; the wrapper launches once per aux level instead,
//   and no chunk of a launch reads a pane row another chunk of the same
//   launch writes.  That is why src and dst may alias.
// - Many chunks publish into one y window (up to 132 on the spill
//   fixtures), so the publish is an atomicAdd per published slot; the
//   order of the sums into one row then differs from run to run.
//
// What bounds it on the H100: bytes, 8 KB of plan stream per chunk plus
// the x pane and the output pane (about 40 MB, 12 us at 3.35 TB/s, for
// the uniform 300k degree-10 plan).  This first design does not reach
// it: the slab gather reads one 4-byte word per thread from scattered
// rows of x (x stays in L2, but each warp-wide load touches up to 32
// sectors), and the publish is atomic.
//
// Design: one 128-thread block per chunk, thread j owning lane column j
// (route2_chunk.cuh); the tile and value columns are read coalesced (one
// 512-byte row per depth).

#include "route2_chunk.cuh"

namespace {

__global__ void route2_spmv_kernel(
    const int* __restrict__ tile, const float* __restrict__ val,
    const int* __restrict__ slab_base, const int* __restrict__ y_base,
    const int* __restrict__ src_flag, const int* __restrict__ rho,
    long long lo, const float* src, long long src_rows, float* dst,
    long long dst_rows, int g, int dist_max, int any_lane, int ww,
    int rotated) {
  __shared__ route2::Shared sh;
  const long long k = lo + blockIdx.x;
  route2::chunk(sh, tile, val, rho, k, slab_base[k], src_flag[k],
                y_base[k], src, src_rows, dst, dst_rows, g, dist_max,
                any_lane, ww, rotated);
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
    route2_spmv_kernel<<<static_cast<unsigned>(hi - lo), route2::kLanes, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile), static_cast<const float*>(val),
        static_cast<const int*>(slab_base), static_cast<const int*>(y_base),
        static_cast<const int*>(src_flag), static_cast<const int*>(rho), lo,
        static_cast<const float*>(src), src_rows, static_cast<float*>(dst),
        dst_rows, g, dist_max, any_lane, ww, rotated);
  }
  return static_cast<int>(cudaGetLastError());
}

// Paned ROUTE2-mul fused SpGEMM numeric for Hopper: one launch runs the
// chunks [lo, hi) of one output-slot panel of a paned plan
// (spblas_tpu_torch/kernels/route_mul_paned.py), publishing into the
// panel's out pane with atomic adds.  Flag-0 chunks gather their B slab
// at row pane * pane_rows + bb of B; flag-1 (aux) chunks gather it from
// the panel pane itself at row bb.  A stays whole (absolute slab rows).
// The chunk body is route2_mul_chunk.cuh's, shared with route2_mul.cu.
//
// Replaces the TPU kernel spblas_tpu/kernels/route_mul_paned.py::
// _paned_mul_kernel (pl.pallas_call in _paned_mul_dispatch).
//
// Differences from the TPU kernel, and why:
// - The TPU kernel streams B panes through a VMEM double buffer, started
//   and waited on by the per-group event streams eva/evb/evw/evs.  On
//   Hopper B stays in device memory and is read through L2: the event
//   streams are host metadata, and the wrapper hands the kernel each
//   chunk's pane index, from which it computes the absolute slab row.
// - The TPU grid runs a panel's groups in order, so its aux chunks run
//   after every feeder.  CUDA blocks run in no order: the wrapper zeroes
//   the panel pane and launches once over the flag-0 run, then once per
//   aux level (PanelMul.launch_starts), in stream order.
// - The publish is an atomicAdd per published slot (route2_mul_chunk.cuh).
//
// What bounds it on the H100: bytes, the two 4 KB tiles of every chunk
// plus 16 B of per-chunk scalars (ab, bb, yb, fl, pane read as 20 B), A
// and B once and each panel pane twice (zeroed, then accumulated).
//
// Design: one 128-thread block per chunk, thread j owning lane column j;
// one launch per launch range of a panel.

#include "route2_mul_chunk.cuh"

namespace {

__global__ void route_mul_paned_kernel(
    const int* __restrict__ tile1, const int* __restrict__ tile2,
    const int* __restrict__ ab, const int* __restrict__ bb,
    const int* __restrict__ yb, const int* __restrict__ fl,
    const int* __restrict__ pane, long long lo,
    const float* __restrict__ A, long long a_rows,
    const float* __restrict__ B, long long b_rows, long long pane_rows,
    float* out, long long out_rows, int g_a, int g_b, int dist_max) {
  __shared__ route2_mul::Shared sh;
  const long long k = lo + blockIdx.x;
  const int flag = fl[k];
  const long long base =
      flag ? static_cast<long long>(bb[k])
           : static_cast<long long>(pane[k]) * pane_rows + bb[k];
  route2_mul::chunk(sh, tile1, tile2, k, ab[k], base, yb[k], A, a_rows,
                    flag ? out : B, flag ? out_rows : b_rows, out, out_rows,
                    g_a, g_b, dist_max);
}

}  // namespace

// tile1, tile2: (nchunks, 8, 128) int32; ab, bb, yb, fl, pane:
// (nchunks,) int32; A: (a_rows, 128) f32; B: (b_rows, 128) f32 in panes
// of pane_rows rows; out: (out_rows, 128) f32, the panel pane,
// accumulated into.
extern "C" int route_mul_paned_f32(
    const void* tile1, const void* tile2, const void* ab, const void* bb,
    const void* yb, const void* fl, const void* pane, long long lo,
    long long hi, const void* A, long long a_rows, const void* B,
    long long b_rows, long long pane_rows, void* out, long long out_rows,
    int g_a, int g_b, int dist_max, void* stream) {
  if (hi > lo) {
    route_mul_paned_kernel<<<static_cast<unsigned>(hi - lo),
                             route2::kLanes, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile1), static_cast<const int*>(tile2),
        static_cast<const int*>(ab), static_cast<const int*>(bb),
        static_cast<const int*>(yb), static_cast<const int*>(fl),
        static_cast<const int*>(pane), lo, static_cast<const float*>(A),
        a_rows, static_cast<const float*>(B), b_rows, pane_rows,
        static_cast<float*>(out), out_rows, g_a, g_b, dist_max);
  }
  return static_cast<int>(cudaGetLastError());
}

// Paned ROUTE2 chunk SpMV for Hopper: one launch runs the chunks [lo, hi)
// of one row panel of a paned plan (spblas_tpu_torch/kernels/
// route_paned.py), publishing into the panel's output pane `out` with
// atomic adds.  Flag-0 chunks gather their slab from x at row
// pane * pane_rows + sb; flag-1 (aux) chunks gather from the panel pane
// itself at row sb.  The chunk body is route2_chunk.cuh's, shared with
// route2_spmv.cu.
//
// Replaces the TPU kernel spblas_tpu/kernels/route_paned.py::
// _paned_kernel (pl.pallas_call in _paned_dispatch).
//
// Differences from the TPU kernel, and why:
// - The TPU kernel exists to stream x panes through a VMEM double buffer
//   (two pane slots, DMAs started and waited on by the per-group event
//   streams eva/evb/evw/evs).  On Hopper x stays in device memory and is
//   read through L2, so there is no pane buffer: the event streams are
//   host metadata, and the wrapper hands the kernel each chunk's pane
//   index, from which it computes the absolute slab row.
// - The TPU grid runs a panel's groups in order, so its aux chunks run
//   after every feeder (route_paned.py:14-15).  CUDA blocks run in no
//   order: the wrapper zeroes the panel pane and launches once over the
//   flag-0 chunks, then once per aux level, in stream order.  No chunk
//   of a launch reads a pane row another chunk of it writes, so out may
//   be read and written by one launch and is not __restrict__.
// - The TPU's y_ref[yb] += upd is safe only on its sequential grid: the
//   publish is an atomicAdd per published slot (route2_chunk.cuh), so
//   sums into one row are taken in an order that changes from run to
//   run.
// - Pad chunks (zero tiles, vA = 0) publish nothing wherever they read;
//   an all-empty panel's pad group is flagged 1 and reads the zeroed
//   panel pane, as on the TPU.  Slab rows are bounded by their source's
//   rows and read 0 past them.
//
// What bounds it on the H100: bytes, 8 KB of plan stream per chunk plus
// 16 B of per-chunk scalars (sb, yb, fl, pane), x once and each panel
// pane twice (zeroed, then accumulated): 1.39 GB, 0.41 ms at 3.35 TB/s,
// on uniform 4M degree 10 (162,832 chunks at fill 0.24; its CSR is
// 0.34 GB, so even at this bound the plan stays slower than a CSR
// kernel).  Measured there (NVIDIA H100 80GB HBM3, 700 W;
// scripts/route_profile.py): 0.82 ms, 0.78 with the publish off, 0.70
// with the gather a constant, 0.69 with both: the stream of the plan and
// the chunk body, not the gather or the atomics, hold it.
//
// Design: one 128-thread block per chunk, thread j owning lane column j,
// many blocks resident on each SM, so that their loads overlap; one
// launch per launch range of a panel.  The tile and values are loaded
// evict-first (route2_chunk.cuh's `stream`), so x and the pane stay in
// L2 while the plan passes: 2.7 % off the time.  One persistent launch
// over every panel (the chunks claimed in order from one counter, aux
// levels ordered by done counters, the next chunks' tiles streamed into
// a shared-memory ring by cp.async.bulk) measured 0.99-1.27 ms, and one
// launch of one block a chunk 0.94-1.04 ms, whichever chunk body they ran:
// fewer blocks fit on an SM beside a ring, and each block's range lookup
// put a dependent load ahead of its first tile load, so fewer chunks
// were in flight.

#include "route2_chunk.cuh"

namespace {

__global__ void route_paned_spmv_kernel(
    const int* __restrict__ tile, const float* __restrict__ val,
    const int* __restrict__ sb, const int* __restrict__ yb,
    const int* __restrict__ fl, const int* __restrict__ pane,
    const int* __restrict__ rho, long long lo,
    const float* __restrict__ x2, long long x_rows, long long pane_rows,
    float* out, long long out_rows, int g, int dist_max, int any_lane,
    int ww, int rotated) {
  __shared__ route2::Shared sh;
  const long long k = lo + blockIdx.x;
  const int flag = fl[k];
  const long long base =
      flag ? static_cast<long long>(sb[k])
           : static_cast<long long>(pane[k]) * pane_rows + sb[k];
  route2::chunk(sh, tile, val, rho, k, base, flag, yb[k],
                flag ? out : x2, flag ? out_rows : x_rows, out, out_rows, g,
                dist_max, any_lane, ww, rotated, true);
}

}  // namespace

// tile, val: (nchunks, 8, 128) int32 / f32; sb, yb, fl, pane, rho:
// (nchunks,) int32; x2: (x_rows, 128) f32, with x panes of pane_rows
// rows; out: (out_rows, 128) f32, the panel pane, accumulated into.
extern "C" int route_paned_spmv_f32(
    const void* tile, const void* val, const void* sb, const void* yb,
    const void* fl, const void* pane, const void* rho, long long lo,
    long long hi, const void* x2, long long x_rows, long long pane_rows,
    void* out, long long out_rows, int g, int dist_max, int any_lane, int ww,
    int rotated, void* stream) {
  if (hi > lo) {
    route_paned_spmv_kernel<<<static_cast<unsigned>(hi - lo),
                              route2::kLanes, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile), static_cast<const float*>(val),
        static_cast<const int*>(sb), static_cast<const int*>(yb),
        static_cast<const int*>(fl), static_cast<const int*>(pane),
        static_cast<const int*>(rho), lo, static_cast<const float*>(x2),
        x_rows, pane_rows, static_cast<float*>(out), out_rows, g, dist_max,
        any_lane, ww, rotated);
  }
  return static_cast<int>(cudaGetLastError());
}

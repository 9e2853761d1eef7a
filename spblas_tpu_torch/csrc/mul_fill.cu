// Slot fill for Hopper: the fused SpGEMM numeric of a paned mul plan as one
// gather-and-segmented-sum launch over the plan's slot-sorted expansion
// stream (spblas_tpu_torch/kernels/mul_fill.py SlotStream):
//   c[s] = sum over e in [run_start[s], run_start[s + 1]) of
//          A[sa[e]] * B[sb[e]]                 for s < nslots
//   c[s] = 0                                   for nslots <= s < capacity
//
// Replaces the TPU kernel spblas_tpu/kernels/route_mul_paned.py::
// _paned_mul_kernel (pl.pallas_call in _paned_mul_dispatch), whose
// function its docstring states as the slot sums of A_arr[sa] *
// B_arr[sb].  It keeps that function and drops the TPU's structure: the
// TPU has no hardware gather, so its plan routes every product through
// (8, 128) int32 tiles of slab rows, lane gathers and depth drops, and
// each 1024-slot output stripe meets each B window in a chunk of its
// own.  The 100k A.A plan is 3.3 % full: 294,520 chunks, 2.41 GB of
// tiles for 10.0M products, so any kernel that reads the tiles is held
// at 0.72 ms by that stream alone (NVIDIA H100 80GB HBM3, 700 W), above
// cuSPARSE's whole SpGEMM.  Hopper gathers in hardware: this kernel reads
// the stream the tiles were packed from (12 B a product, 4 B a slot),
// gathers A and B through L2 (4 MB each at 100k, resident there), and
// writes c once.
//
// What bounds it on the H100: bytes, the index stream, A and B once and c
// once (its capacity, 16.8M slots): 195 MB, 0.058 ms at 3.35 TB/s, on the
// 100k A.A plan; the gathers add 32-byte L2 sectors for each 4-byte
// value.
//
// Design: one owner a slot, no atomics.  Thread s of a 256-thread block
// owns slot s: it sums its run in stream order and stores the sum once,
// so the fill gives the same bits on every run.  Longer runs are summed
// by more threads, each in a fixed order, and the owner still stores:
//  - kLong < length <= kMid (a middle run): by the owner's warp.  A
//    ballot lists the warp's middle runs; the warp takes them two at a
//    time in lane order (two runs' gathers in flight), lane t summing
//    products t, t + 32, ..., and a butterfly of shuffles adding the
//    lanes.  No shared memory: the barrier the block takes anyway
//    (__syncthreads_or) tells it whether any of its slots has a middle
//    run, and a block without one skips the tier.  A stream whose
//    longest run is at most kLong (the host keeps it with the stream)
//    runs the kernel without the tier, where runs past kLong take the
//    block, as they did before the tier: the tier's code alone cost the
//    100k A.A paned fill 2.5 % (NVIDIA H100 80GB HBM3, 700 W).  Runs of about 41
//    products (the ROUTE v1 engine's dup-40 stream, 32,768 slots) summed
//    a block a run left 215 of its 256 threads idle and queued 256 runs
//    on each block, one after another.
//  - length > kMid (a hub slot): by the owner's whole block, thread t
//    taking products t, t + 256, ..., a butterfly in each warp, then
//    the 8 warp sums in warp order.  A hub of 30k products summed by one
//    warp took 0.25 ms on the paned hub fixture (NVIDIA H100 80GB HBM3,
//    700 W), a latency chain of 940 dependent gathers a lane.
// Slots past the stream's last one, up to the capacity, are written 0:
// no separate zeroing pass, no panel panes, no concatenation.  The same
// launch runs the paned ROUTE2-mul plan's fill (route_mul_paned.py) and
// the ROUTE v1 SpGEMM numeric (route_mul_kernel.py, which replaces the
// TPU kernel spblas_tpu/kernels/route_mul_kernel.py::_mul_kernel the same
// way: both plans keep the stream their tiles were packed from).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLong = 32;    // runs longer than this leave their owner
constexpr int kMid = 1024;   // ... for its warp up to this, else its block


__device__ __forceinline__ float product(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         const int* __restrict__ sa,
                                         const int* __restrict__ sb,
                                         int e) {
  return A[sa[e]] * B[sb[e]];
}

__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Mid: the stream has middle runs (its longest run, kept with the
// stream, passes kLong); without them the tier is not compiled in
template <bool Mid>
__global__ void __launch_bounds__(kThreads)
    mul_fill_kernel(const int* __restrict__ run_start,
                    const int* __restrict__ sa, const int* __restrict__ sb,
                    const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ c, long long nslots,
                    long long capacity) {
  __shared__ int hub_owner[kThreads];
  __shared__ int nhubs;
  __shared__ float warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + tid;
  int lo = 0, hi = 0;
  if (s < nslots) {
    lo = run_start[s];
    hi = run_start[s + 1];
  }
  if (tid == 0) nhubs = 0;
  __syncthreads();
  float acc = 0.f;
  if (hi - lo > (Mid ? kMid : kLong)) {
    hub_owner[atomicAdd(&nhubs, 1)] = tid;
  } else if (hi - lo <= kLong) {
#pragma unroll 4
    for (int e = lo; e < hi; ++e) acc += product(A, B, sa, sb, e);
  }
  // the warp's middle runs, two at a time in lane order, each by all 32
  // lanes; the owner keeps the sum (a block without one skips this)
  const bool mid = Mid && hi - lo > kLong && hi - lo <= kMid;
  if (!Mid) {
    __syncthreads();
  } else if (__syncthreads_or(mid)) {
    unsigned todo = __ballot_sync(0xffffffffu, mid);
    while (todo) {
      const int m1 = __ffs(todo) - 1;
      todo &= todo - 1;
      const int m2 = todo ? __ffs(todo) - 1 : m1;
      todo &= todo - 1;
      const int l1 = __shfl_sync(0xffffffffu, lo, m1);
      const int h1 = __shfl_sync(0xffffffffu, hi, m1);
      const int l2 = __shfl_sync(0xffffffffu, lo, m2);
      const int h2 = m2 != m1 ? __shfl_sync(0xffffffffu, hi, m2) : l2;
      float p1 = 0.f, p2 = 0.f;
      for (int e = lane; l1 + e < h1 || l2 + e < h2; e += 32) {
        if (l1 + e < h1) p1 += product(A, B, sa, sb, l1 + e);
        if (l2 + e < h2) p2 += product(A, B, sa, sb, l2 + e);
      }
      p1 = lanes_sum(p1);
      p2 = lanes_sum(p2);
      if (lane == m1) acc = p1;
      if (lane == m2 && m2 != m1) acc = p2;
    }
  }
  // the block's hub slots, one at a time, by all its threads (the order
  // of the list does not change any slot's sum)
  const int n = nhubs;
  for (int h = 0; h < n; ++h) {
    const int owner = hub_owner[h];
    const long long hs = static_cast<long long>(blockIdx.x) * kThreads +
                         owner;
    const int l0 = run_start[hs], h0 = run_start[hs + 1];
    float part = 0.f;
#pragma unroll 4
    for (int e = l0 + tid; e < h0; e += kThreads)
      part += product(A, B, sa, sb, e);
    part = lanes_sum(part);
    if (lane == 0) warp_sum[tid >> 5] = part;
    __syncthreads();
    if (tid == owner) {
      acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += warp_sum[w];
    }
    __syncthreads();
  }
  if (s < capacity) c[s] = acc;
}

}  // namespace

// run_start: (nslots + 1,) int32; sa, sb: (run_start[nslots],) int32; A,
// B: f32 value arrays that every sa, sb indexes; c: (capacity,) f32,
// written whole (capacity >= nslots); longest: the stream's longest run,
// which picks the kernel with the middle tier or without it.  Launches
// nothing when capacity is 0.
extern "C" int mul_fill_f32(const void* run_start, const void* sa,
                            const void* sb, const void* A, const void* B,
                            void* c, long long nslots, long long capacity,
                            int longest, void* stream) {
  if (capacity > 0) {
    const long long blocks = (capacity + kThreads - 1) / kThreads;
    auto kernel = longest > kLong ? mul_fill_kernel<true>
                                  : mul_fill_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(run_start), static_cast<const int*>(sa),
        static_cast<const int*>(sb), static_cast<const float*>(A),
        static_cast<const float*>(B), static_cast<float*>(c), nslots,
        capacity);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// so the fill gives the same bits on every run.  A run longer than kLong
// products (a hub slot) is summed by the owner's whole block instead:
// thread t takes products t, t + 256, ... of the run, and a fixed tree
// (a butterfly of shuffles in each warp, then the 8 warp sums in warp
// order) adds the partial sums, so those bits repeat too.  A hub of 30k
// products summed by one warp took 0.25 ms on the paned hub fixture
// (NVIDIA H100 80GB HBM3, 700 W), a latency chain of 940 dependent
// gathers a lane.  Slots past the stream's last one, up to the
// capacity, are written 0: no separate zeroing pass, no panel panes, no
// concatenation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLong = 32;   // runs longer than this take the whole block

__device__ __forceinline__ float product(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         const int* __restrict__ sa,
                                         const int* __restrict__ sb,
                                         int e) {
  return A[sa[e]] * B[sb[e]];
}

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
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + tid;
  int lo = 0, hi = 0;
  if (s < nslots) {
    lo = run_start[s];
    hi = run_start[s + 1];
  }
  if (tid == 0) nhubs = 0;
  __syncthreads();
  float acc = 0.f;
  if (hi - lo > kLong) {
    hub_owner[atomicAdd(&nhubs, 1)] = tid;
  } else {
#pragma unroll 4
    for (int e = lo; e < hi; ++e) acc += product(A, B, sa, sb, e);
  }
  __syncthreads();
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = part;
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
// written whole (capacity >= nslots).  Launches nothing when capacity is
// 0.
extern "C" int mul_fill_f32(const void* run_start, const void* sa,
                            const void* sb, const void* A, const void* B,
                            void* c, long long nslots, long long capacity,
                            void* stream) {
  if (capacity > 0) {
    const long long blocks = (capacity + kThreads - 1) / kThreads;
    mul_fill_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(run_start), static_cast<const int*>(sa),
        static_cast<const int*>(sb), static_cast<const float*>(A),
        static_cast<const float*>(B), static_cast<float*>(c), nslots,
        capacity);
  }
  return static_cast<int>(cudaGetLastError());
}

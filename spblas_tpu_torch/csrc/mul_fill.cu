// Slot fill for Hopper: the fused SpGEMM numeric of a mul plan as one
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
// Design: one writer a slot, no atomics on values, and one fixed order of
// sums, so the fill gives the same bits on every run.  The host picks the
// kernel from what it knows of the stream when it builds it (the longest
// run the slots' blocks keep, its hub segments), mul_fill_kernel<Tiers,
// Hub>:
//  - Tiers false, for streams whose kept runs are all at most kLong (the
//    resident and paned A.A products: about 1.1 products a slot; the hub
//    fixtures' runs beside their hubs).  Each thread owns kSlots slots,
//    kThreads apart, and sums each run in stream order; it loads every
//    slot's bounds, then each round's kRound products of all its slots,
//    before any sum, so kSlots chains of dependent loads (bounds, then
//    indices and gathers a round) are in flight a thread where a slot a
//    thread had one, and a run of n products takes about n / kRound
//    rounds.  Measured on the 2k and 100k A.A streams and the hub
//    fixtures (NVIDIA H100 80GB HBM3, 700 W): one slot a thread cost the
//    100k fill 20 %, 4 slots the 2k one 4 %; rounds of one product cost
//    the 2k fill 10 %, of 4 the 100k fill 7 %, of 8 it 61 %.
//  - Tiers true, for streams with kept runs past kLong: thread s of a
//    block owns slot s.  Runs of kLong < length <= kMid (middle runs) are
//    summed by the owner's warp: a ballot lists them, the warp takes them
//    two at a time in lane order, lane t summing products t, t + 32, ...,
//    and a butterfly of shuffles adding the lanes (the barrier the block
//    takes anyway, __syncthreads_or, lets a block without one skip the
//    tier).  Runs of about 41 products (the ROUTE v1 engine's dup-40
//    stream) summed a block a run left 215 of its 256 threads idle.
//    Longer kept runs are summed by the owner's whole block, thread t
//    taking products t, t + 256, ..., a butterfly in each warp, then the 8
//    warp sums in warp order.
//  - Hub true, for streams that have hub runs (longer than kMid, which
//    the host knows as mul_fill.HUB_MIN).  The host cuts each hub run
//    into segments of a fixed length and lists them (the segment table,
//    built with the stream); the grid's first blocks take one segment
//    each, the rest are the slots' blocks, whose owners leave hub slots
//    alone.  A segment block sums its segment as the block tier sums a
//    run and writes one partial; its thread 0 then counts the segment in
//    (__threadfence, then an atomicAdd on the hub's arrival counter), and
//    the block that brings the count to the hub's segment count adds the
//    hub's partials in segment order, writes the slot and resets the
//    counter to 0 for the next fill.  One block summed a hub run before (a lane of it
//    walking about 200 products of a 50k hub as a chain of index loads
//    and gathers; the paned hub fixture's fill read 0.0407 ms against a
//    0.0026 ms bound, NVIDIA H100 80GB HBM3, 700 W).  The counters and
//    partials belong to the stream (kernels/mul_fill.py SlotStream), so
//    two fills over one stream must not run at once on two CUDA streams:
//    their blocks would count into each other's hubs.  Fills on one CUDA
//    stream run one after another, and each leaves every counter at 0.
// The tiers' code costs the streams that do not need it: the middle
// tier's alone cost the 100k A.A paned fill 2.5 % (NVIDIA H100 80GB HBM3,
// 700 W), so each kernel holds only the tiers its streams use.  Slots
// past the stream's last one, up to the capacity, are written 0: no
// separate zeroing pass, no panel panes, no concatenation.  The same
// launch runs the paned ROUTE2-mul plan's fill (route_mul_paned.py), the
// resident ROUTE2-mul numeric (route2_kernel.py, which replaces the TPU
// kernel spblas_tpu/kernels/route2_kernel.py::_route2_mul_kernel the
// same way) and the ROUTE v1 SpGEMM numeric (route_mul_kernel.py, which
// replaces spblas_tpu/kernels/route_mul_kernel.py::_mul_kernel): each
// plan keeps the stream its tiles were packed from.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLong = 32;    // runs longer than this leave their owner
constexpr int kMid = 1024;   // ... for its warp up to this, else its block
constexpr int kSlots = 2;    // slots a thread of the short kernel
constexpr int kRound = 2;    // ... and products a slot a round


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

// products [lo, hi) summed by the whole block: thread t takes t, t + 256,
// ..., a butterfly in each warp, then the warp sums in warp order (the
// result in thread 0; warp_sum is free again when it returns)
__device__ __forceinline__ float block_sum(const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           const int* __restrict__ sa,
                                           const int* __restrict__ sb,
                                           int lo, int hi,
                                           float* warp_sum) {
  const int tid = threadIdx.x;
  float part = 0.f;
#pragma unroll 4
  for (int e = lo + tid; e < hi; e += kThreads)
    part += product(A, B, sa, sb, e);
  part = lanes_sum(part);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = part;
  __syncthreads();
  float total = 0.f;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
  }
  __syncthreads();
  return total;
}

// the hub tier's tables: seg[2 * i], seg[2 * i + 1] = (lo, hi, hub, slot),
// (first segment of the hub, segments of the hub, 0, 0) of segment i;
// count: an arrival counter a hub (0 between fills); part: a partial a
// segment
struct HubTier {
  const int4* seg;
  int* count;
  float* part;
  int nseg;
};

// hub segment i: its partial, and the hub's slot from the last to arrive
// (its warp 0 loads the hub's partials 32 at a time and every lane adds
// them in segment order, lane 0 storing the sum)
__device__ __forceinline__ void hub_segment(
    int i, HubTier hub, const float* __restrict__ A,
    const float* __restrict__ B, const int* __restrict__ sa,
    const int* __restrict__ sb, float* __restrict__ c, float* warp_sum,
    int* last) {
  const int4 r = hub.seg[2 * i];
  const int4 q = hub.seg[2 * i + 1];
  const float part = block_sum(A, B, sa, sb, r.x, r.y, warp_sum);
  if (threadIdx.x == 0) {
    hub.part[i] = part;
    __threadfence();
    *last = atomicAdd(hub.count + r.z, 1) == q.y - 1;
  }
  __syncthreads();
  if (*last && threadIdx.x < 32) {
    // every other segment's partial was fenced before its count
    __threadfence();
    const int lane = threadIdx.x;
    float v = 0.f;
    for (int j0 = 0; j0 < q.y; j0 += 32) {
      const float p = j0 + lane < q.y ? __ldcg(hub.part + q.x + j0 + lane)
                                      : 0.f;
      const int n = min(32, q.y - j0);
      for (int t = 0; t < n; ++t) v += __shfl_sync(0xffffffffu, p, t);
    }
    if (lane == 0) {
      c[r.w] = v;
      hub.count[r.z] = 0;
    }
  }
}

// the slots of block blk when every run it keeps is at most kLong: each
// thread owns kSlots slots, kThreads apart, summing each run in stream
// order, kRound products a slot a round: the round's index loads of all
// its slots, then their gathers, then the sums, so a run of n products
// is a chain of about n / kRound dependent loads, not n; with Hub, a run
// past kMid is its segments': its owner writes nothing
template <bool Hub>
__device__ __forceinline__ void short_slots(
    long long blk, const int* __restrict__ run_start,
    const int* __restrict__ sa, const int* __restrict__ sb,
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ c, long long nslots, long long capacity) {
  const long long s0 = blk * kThreads * kSlots + threadIdx.x;
  int lo[kSlots], hi[kSlots];
  bool keep[kSlots];
  float acc[kSlots];
  int most = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long s = s0 + k * kThreads;
    lo[k] = hi[k] = 0;
    if (s < nslots) {
      lo[k] = run_start[s];
      hi[k] = run_start[s + 1];
    }
    keep[k] = !(Hub && hi[k] - lo[k] > kMid);
    if (!keep[k]) hi[k] = lo[k];
    acc[k] = 0.f;
    most = max(most, hi[k] - lo[k]);
  }
#pragma unroll 1
  for (int j = 0; j < most; j += kRound) {
    int ia[kSlots][kRound], ib[kSlots][kRound];
    float pa[kSlots][kRound], pb[kSlots][kRound];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int e = lo[k] + j + u;
        ia[k][u] = e < hi[k] ? sa[e] : 0;
        ib[k][u] = e < hi[k] ? sb[e] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const bool in = lo[k] + j + u < hi[k];
        pa[k][u] = in ? A[ia[k][u]] : 0.f;
        pb[k][u] = in ? B[ib[k][u]] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int u = 0; u < kRound; ++u)
        if (lo[k] + j + u < hi[k]) acc[k] += pa[k][u] * pb[k][u];
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long s = s0 + k * kThreads;
    if (s < capacity && keep[k]) c[s] = acc[k];
  }
}

// the slots of block blk with the middle and block tiers: thread s owns
// slot s; with Hub, a run past kMid is its segments', else the block's
template <bool Hub>
__device__ __forceinline__ void tiered_slots(
    long long blk, const int* __restrict__ run_start,
    const int* __restrict__ sa, const int* __restrict__ sb,
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ c, long long nslots, long long capacity) {
  __shared__ int hub_owner[kThreads];
  __shared__ int nhubs;
  __shared__ float warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long s = blk * kThreads + tid;
  int lo = 0, hi = 0;
  if (s < nslots) {
    lo = run_start[s];
    hi = run_start[s + 1];
  }
  if (tid == 0) nhubs = 0;
  __syncthreads();
  float acc = 0.f;
  const bool seg = Hub && hi - lo > kMid;
  if (!seg && hi - lo > kMid) {
    hub_owner[atomicAdd(&nhubs, 1)] = tid;
  } else if (hi - lo <= kLong) {
#pragma unroll 4
    for (int e = lo; e < hi; ++e) acc += product(A, B, sa, sb, e);
  }
  // the warp's middle runs, two at a time in lane order, each by all 32
  // lanes; the owner keeps the sum (a block without one skips this)
  const bool mid = hi - lo > kLong && hi - lo <= kMid;
  if (__syncthreads_or(mid)) {
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
  // the block's long runs below the hub cut, one at a time, by all its
  // threads (the order of the list does not change any slot's sum)
  const int n = nhubs;
  for (int h = 0; h < n; ++h) {
    const int owner = hub_owner[h];
    const long long hs = blk * kThreads + owner;
    const float total = block_sum(A, B, sa, sb, run_start[hs],
                                  run_start[hs + 1], warp_sum);
    if (tid == 0) warp_sum[0] = total;
    __syncthreads();
    if (tid == owner) acc = warp_sum[0];
    __syncthreads();
  }
  if (s < capacity && !seg) c[s] = acc;
}

// Tiers: a run the slots' blocks keep passes kLong (the middle and block
// tiers, a slot a thread), else kSlots slots a thread; Hub: the stream
// has hub segments, the grid's first hub.nseg blocks
template <bool Tiers, bool Hub>
__global__ void __launch_bounds__(kThreads)
    mul_fill_kernel(const int* __restrict__ run_start,
                    const int* __restrict__ sa, const int* __restrict__ sb,
                    const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ c, long long nslots,
                    long long capacity, HubTier hub) {
  long long blk = blockIdx.x;
  if constexpr (Hub) {
    __shared__ float seg_sum[kWarps];
    __shared__ int last;
    if (blockIdx.x < static_cast<unsigned>(hub.nseg)) {
      hub_segment(blockIdx.x, hub, A, B, sa, sb, c, seg_sum, &last);
      return;
    }
    blk -= hub.nseg;
  }
  if constexpr (Tiers)
    tiered_slots<Hub>(blk, run_start, sa, sb, A, B, c, nslots, capacity);
  else
    short_slots<Hub>(blk, run_start, sa, sb, A, B, c, nslots, capacity);
}

}  // namespace

// run_start: (nslots + 1,) int32; sa, sb: (run_start[nslots],) int32; A,
// B: f32 value arrays that every sa, sb indexes; c: (capacity,) f32,
// written whole (capacity >= nslots); longest_kept: the longest run the
// slots' blocks sum (the hub runs left out), which picks kSlots slots a
// thread (at most kLong) or the tiers.  The hub tier: hub_seg (nseg, 8)
// int32 (see HubTier) listing every run longer than kMid, hub_count
// (hubs,) int32 zeros, hub_part (nseg,) f32; nseg 0 leaves it out.
// Launches nothing when capacity is 0.
extern "C" int mul_fill_f32(const void* run_start, const void* sa,
                            const void* sb, const void* A, const void* B,
                            void* c, long long nslots, long long capacity,
                            int longest_kept, const void* hub_seg,
                            void* hub_count, void* hub_part, int nseg,
                            void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaGetLastError());
  const HubTier hub{static_cast<const int4*>(hub_seg),
                    static_cast<int*>(hub_count),
                    static_cast<float*>(hub_part), nseg};
  const bool tiers = longest_kept > kLong;
  const long long per_block = tiers ? kThreads : kThreads * kSlots;
  const long long blocks = (capacity + per_block - 1) / per_block + nseg;
  auto kernel = tiers ? (nseg > 0 ? mul_fill_kernel<true, true>
                                  : mul_fill_kernel<true, false>)
                      : (nseg > 0 ? mul_fill_kernel<false, true>
                                  : mul_fill_kernel<false, false>);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(run_start), static_cast<const int*>(sa),
      static_cast<const int*>(sb), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<float*>(c), nslots,
      capacity, hub);
  return static_cast<int>(cudaGetLastError());
}

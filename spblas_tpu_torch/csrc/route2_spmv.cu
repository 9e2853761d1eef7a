// ROUTE2 chunk SpMV for Hopper: one launch runs the chunks [lo, hi) of a
// ROUTE2 plan (spblas_tpu_torch/kernels/route2.py), reading the source
// pane `src` and publishing into the destination pane `dst` with atomic
// adds.  Both kernels below run route2_chunk.cuh's chunk body, shared
// with the solve mode and route_paned_spmv.cu.
//
// Replaces the TPU kernel spblas_tpu/kernels/route2_kernel.py::
// _route2_kernel (pl.pallas_call in route2_dispatch); route2_cx_spmv_f32
// replaces the four dispatches of it that JAX's route_cx_spmv
// (spblas_tpu/kernels/plans.py) runs for a complex64 matrix.  Which pane a
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
// the uniform 300k degree-10 plan; 173 MB, 52 us, for the rotated 1M
// plan).  The first design, one 128-thread block a chunk, took 41 us and
// 143 us there (NVIDIA H100 80GB HBM3, 700 W; scripts/route_profile.py).
// Three things held it above the bytes: the slab gather, where each warp
// load reads its 32 lanes from scattered x rows (L1 work, not bytes:
// 34 us at 1M); the publish, 8.5M atomics at 1M, one per published slot
// (43 us); and the body's instructions (its register select ladders).
//
// Design.  Launch ranges of SLAB_MIN_CHUNKS chunks or more
// (kernels/route2.py) run route2_slab_kernel: one 1024-thread block an
// SM, kGroups groups of 128 threads, each group running a chunk with
// thread j owning lane column j and a named barrier of its own.  The
// wrapper hands it the range's chunks sorted by the slab they read and
// cut into items of one slab (Route2Plan.slab_work, made on the host
// when the plan is built); a block runs a contiguous share of the items,
// copies each new slab (8g rows of x, 128 KB at g = 32) into shared
// memory once, and the slab route then reads shared memory,
// conflict-free (lane j reads bank j % 32).  Small ranges (aux levels)
// run route2_apply_kernel, one block a chunk, kMinBlocks or more blocks
// an SM.  The chains then take 37 us at 300k and 120 us at 1M, against
// cuSPARSE's 37 and 98.  What bounds the slab kernel now is the
// publish: with it off the 1M chain takes 72 us of 120.  One owner per
// y window would remove those atomics, but a window's chunks read every
// slab, so it and the slab copy pull the chunk order apart.
//
// Solve mode (route2_solve_f32) replaces the same TPU kernel run with
// init_from_x (route2_kernel.py::route2_solve): level-scheduled
// triangular substitution over one pane that starts at y0 = b/(alpha*d),
// every chunk gathering from the pane and publishing into it, with
// values baked as -a_ij/d_i.  The TPU grid makes each level's publishes
// visible to the next level's gathers.  The first Hopper design ran each
// dependency level (and each aux level of a hub level) as its own
// launch: 15,624 launches on the 1M-row chain, 3.1-6.0 us a level for
// 2.1-2.6 us of kernel (NVIDIA H100 80GB HBM3, 700 W;
// scripts/route_profile.py), so the solve was bound by launches.
//
// route2_solve_kernel is one persistent launch a solve, after one memset
// of its counters, over a work list made on the host with the plan
// (kernels/route2.py build_solve_work): the launch ranges become steps,
// a range wider than SOLVE_STRETCH_CHUNKS a step of one item a chunk,
// and a stretch of consecutive narrower ranges (on the chain, every
// level: one chunk each) a step of one item that one block runs alone.
// - Claims.  Thread 0 claims items in stream order (levels in order)
//   from one counter, one claim ahead of the item the block runs, and
//   loads the next item's range while this one runs.
// - Done counters.  When a block has run an item, it synchronises and
//   one thread adds 1 to the item's step counter with a release
//   (cumulative over the barrier).  An item of step t first has one
//   thread spin, with an acquiring load at gpu scope, until step t - 1's
//   counter holds all its items; then the block synchronises.  The grid
//   is the widest step's item count (at most the blocks the card
//   holds), so few blocks poll one counter.
// - Inside a stretch one block runs the levels in order, with a
//   block-scope fence and __syncthreads between chunks in place of the
//   counters' round trip through L2: about 1 us a level on the chain,
//   against 2 us with every level spread over the blocks.
// - Reads of the pane go through L2 (ld.cg): other blocks publish into
//   it during the launch, and L1 is not coherent.
// - Forward progress.  Items are claimed in step order and a block runs
//   its claims in order, counting each as it ends, so before it waits
//   it has run and counted every item of an earlier step it claimed.
//   Step 0 waits on nothing, so its items finish and are counted, which
//   ends every wait on it, and so on step by step; a block claims only
//   while it runs, so the grid may be any size.
// - Prefetch.  The plan does not depend on the solution: the next
//   chunk's tile and values are loaded into registers while a block
//   waits or runs the chunk before it (two chunks ahead measured no
//   faster and spilled).
// The chain's solve took 16.4 ms against 49-50 ms for the launches (and
// 36.5 ms for them replayed from a CUDA graph), the 20k factor's 0.082
// against 0.085 (NVIDIA H100 80GB HBM3, 700 W; scripts/route_profile.py,
// paired).  A step spread over blocks still costs about 3 us: the
// release, the poll and the gather are each a round trip through L2.
// A chunk's used slots read only rows of earlier levels; its unused
// slots (value 0) may read a row another block of the level is
// publishing to, a finite value either way, so their product stays 0.

#include "route2_chunk.cuh"

#include <cstdint>

namespace {

using route2::bits;
using route2::kLanes;
using route2::kSubs;

constexpr int kGroups = 8;      // chunks a slab block runs at once
constexpr int kMinBlocks = 10;  // blocks an SM of the apply kernel
constexpr int kSolveBlocks = 4; // blocks an SM of the solve kernel
constexpr int kPollNs = 32;     // sleep between polls of a done counter

struct Plan {
  const int* tile;
  const float* val;
  const int* slab_base;
  const int* y_base;
  const int* src_flag;
  const int* rho;          // null unless rotated
  const float* src;        // may alias dst
  float* dst;
  long long src_rows, dst_rows;
  int g, dist_max, any_lane, ww, rotated;
};

// A block a chunk (the small launch ranges: aux levels): the slab rows
// gathered from src through L1/L2, the plan loaded evict-first.
__global__ void __launch_bounds__(kLanes, kMinBlocks)
    route2_apply_kernel(Plan P, long long lo) {
  __shared__ route2::Shared sh;
  const long long k = lo + blockIdx.x;
  route2::chunk(sh, P.tile, P.val, P.rho, k, __ldg(P.slab_base + k),
                __ldg(P.src_flag + k), __ldg(P.y_base + k), P.src,
                P.src_rows, P.dst, P.dst_rows, P.g, P.dist_max, P.any_lane,
                P.ww, P.rotated, true);
}

// Rows [sb, sb + rows) of src into slab, zero past src_rows, by every
// thread of the block (16-byte loads where src allows them).
__device__ __forceinline__ void stage_slab(float* slab, const Plan& P,
                                           long long sb, int rows) {
  const float* src = P.src + sb * kLanes;
  const long long avail = P.src_rows - sb;   // rows of src from sb on
  const int n = rows * kLanes;
  if (reinterpret_cast<std::uintptr_t>(src) % 16 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(slab);
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
      d4[q] = q / (kLanes / 4) < avail ? __ldg(s4 + q)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      slab[q] = q / kLanes < avail ? __ldg(src + q) : 0.f;
    }
  }
}

constexpr int kSlabThreads = kGroups * kLanes;
constexpr int kSlabMaxRows = kSubs * 32;   // 8g rows, g <= 32
constexpr size_t kSlabSmem = sizeof(route2::Shared) * kGroups +
                             sizeof(float) * kSlabMaxRows * kLanes;

// The slab-staged launch: a block runs work items (runs of chunks that
// read one slab, in `order`, items[i] .. items[i + 1]) of its contiguous
// share, copying each new slab into shared memory once, and kGroups
// chunks at a time, one a group of 128 threads with its own named
// barrier; the slab route then reads shared memory.
__global__ void __launch_bounds__(kSlabThreads, 1)
    route2_slab_kernel(Plan P, const int* __restrict__ order,
                       const int* __restrict__ items, int nitems) {
  extern __shared__ float4 smem4[];
  route2::Shared* groups = reinterpret_cast<route2::Shared*>(smem4);
  float* slab = reinterpret_cast<float*>(groups + kGroups);
  const int grp = threadIdx.x / kLanes;
  const int j = threadIdx.x % kLanes;
  route2::Shared& sh = groups[grp];
  const route2::GroupBarrier bar{1 + grp};
  const int rows = kSubs * P.g;
  const int i0 = static_cast<int>(static_cast<long long>(nitems) *
                                  blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(nitems) *
                                  (blockIdx.x + 1) / gridDim.x);
  long long staged = -1;
  for (int i = i0; i < i1; ++i) {
    const int s0 = items[i], s1 = items[i + 1];
    const long long sb = __ldg(P.slab_base + order[s0]);
    if (sb != staged) {
      __syncthreads();   // every group is done with the last slab
      stage_slab(slab, P, sb, rows);
      __syncthreads();
      staged = sb;
    }
    for (int pos = s0 + grp; pos < s1; pos += kGroups) {
      const long long k = order[pos];
      unsigned t[kSubs];
      float v[kSubs];
      route2::load_lanes(t, v, P.tile, P.val, k, j, true);
      const int flag = __ldg(P.src_flag + k);
      const long long yb = __ldg(P.y_base + k);
      const int rk = P.rotated && flag != 2 ? __ldg(P.rho + k) : 0;
      bar();   // the group's last chunk is done with sh
#pragma unroll
      for (int a = 0; a < kSubs; ++a) {
        sh.t1[a][j] = slab[min(bits(t[a], 0, 255), rows - 1) * kLanes + j];
      }
      bar();
      route2::finish(sh, t, v, flag, yb, rk, P.dst, P.dst_rows, P.dist_max,
                     P.any_lane, P.ww, P.rotated, j, bar);
    }
  }
}

// The complex product (route2_cx_spmv_f32): one plan, two value planes.
// A block a chunk, as route2_apply_kernel, running the chunk body on
// float2 values: the real plane val and the imaginary plane val_im (0 on
// every aux carrier and padding slot, made with the plan), the source a
// pane of (re, im) pairs (X = float2) or a real x (X = float, read as
// (x, 0)), the output a pane of (re, im) pairs that each published slot
// enters with one float2 atomicAdd (sm_90, global memory).  So the
// routing tile, the slab geometry and the publish run once for both
// planes, where four real applies ran them four times.  No slab kernel:
// a slab of two planes (256 KB at g = 32) does not fit an SM's 227 KB,
// so launch ranges of any size run a block a chunk.
struct PlanCx {
  const int* tile;
  const float* val;
  const float* val_im;
  const int* slab_base;
  const int* y_base;
  const int* src_flag;
  const int* rho;          // null unless rotated
  const void* src;         // (src_rows, 128) of X; may alias dst
  float2* dst;
  long long src_rows, dst_rows;
  int g, dist_max, any_lane, ww, rotated;
};

constexpr int kMinBlocksCx = 8;   // blocks an SM of the complex kernel

template <class X>
__global__ void __launch_bounds__(kLanes, kMinBlocksCx)
    route2_cx_kernel(PlanCx P, long long lo) {
  __shared__ route2::SharedCx sh;
  const int j = threadIdx.x;
  const long long k = lo + blockIdx.x;
  unsigned t[kSubs];
  float2 v[kSubs];
  route2::load_lanes_cx(t, v, P.tile, P.val, P.val_im, k, j);
  const int flag = __ldg(P.src_flag + k);
  const long long yb = __ldg(P.y_base + k);
  const int rk = (P.rotated && flag != 2) ? __ldg(P.rho + k) : 0;
  route2::slab_route(sh.t1, t, 0, __ldg(P.slab_base + k),
                     static_cast<const X*>(P.src), P.src_rows, P.g);
  __syncthreads();
  route2::finish(sh, t, v, flag, yb, rk, P.dst, P.dst_rows, P.dist_max,
                 P.any_lane, P.ww, P.rotated, j, route2::BlockBarrier{});
}

// blocks of the slab kernel the current device holds at once (per
// device, cached, its shared memory limit raised once); 0 where it
// cannot say
long long slab_grid() {
  static long long cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    if (cudaFuncSetAttribute(route2_slab_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSlabSmem)) != cudaSuccess) {
      return 0;
    }
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route2_slab_kernel, kSlabThreads, kSlabSmem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = static_cast<long long>(per_sm) * sms;
  }
  return cached[dev];
}

struct SolvePlan {
  const int* tile;
  const float* val;
  const int* slab_base;
  const int* y_base;
  const int* src_flag;
  const int* item_start;   // (nitems + 1,) first chunk of each item
  const int* item_step;    // (nitems,) step of each item
  const int* step_need;    // (nsteps,) items of each step
  unsigned* counters;      // [0] claims, [1 + t] items of step t done
  float* pane;             // (rows, 128): y0 on entry, x on exit
  long long rows;
  int nitems, g, dist_max, any_lane;
};

// add v to *p with release semantics at gpu scope: this thread's earlier
// writes, and those the block's barrier ordered before it, are visible
// to whoever reads the sum with an acquiring load
__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// one chunk's lane column and scalars, in registers
struct Lanes {
  unsigned t[kSubs];
  float v[kSubs];
  int sb, flag, yb;
};

__device__ __forceinline__ void fetch(Lanes& c, const SolvePlan& P,
                                      long long k, int j) {
  route2::load_lanes(c.t, c.v, P.tile, P.val, k, j, false);
  c.sb = __ldg(P.slab_base + k);
  c.flag = __ldg(P.src_flag + k);
  c.yb = __ldg(P.y_base + k);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a wait longer than this is a fault (a work list whose steps cannot
// complete), not a slow solve: the kernel traps instead of hanging
constexpr unsigned long long kWaitLimitNs = 30000000000ull;

// The persistent solve: claims items in order, waits on the step before
// each new step, runs an item's chunks one after another (see the note
// at the top of this file).
__global__ void __launch_bounds__(kLanes, kSolveBlocks)
    route2_solve_kernel(const SolvePlan P) {
  __shared__ route2::Shared sh;
  // the block's next claim and its item's chunk range and step
  __shared__ int next_item, next_lo, next_hi, next_step;
  const int j = threadIdx.x;
  unsigned* claims = P.counters;
  unsigned* done = P.counters + 1;
  if (j == 0) {
    const int i = static_cast<int>(atomicAdd(claims, 1u));
    next_item = i;
    if (i < P.nitems) {
      next_lo = __ldg(P.item_start + i);
      next_hi = __ldg(P.item_start + i + 1);
      next_step = __ldg(P.item_step + i);
    }
  }
  __syncthreads();
  int cur = -1;          // the step the block last waited for
  Lanes c;
  while (next_item < P.nitems) {
    const int lo = next_lo, hi = next_hi, step = next_step;
    fetch(c, P, lo, j);  // in flight across the wait
    __syncthreads();     // every thread has read the claim
    // thread 0: claim ahead (the value arrives during the wait and the
    // item), then wait for the step this item reads (acquire)
    int ahead = 0, ahead_lo = 0, ahead_hi = 0, ahead_step = 0;
    if (j == 0) {
      ahead = static_cast<int>(atomicAdd(claims, 1u));
      if (step != cur && step > 0) {
        const unsigned need = __ldg(P.step_need + step - 1);
        const unsigned long long t0 = now_ns();
        while (load_acquire(done + step - 1) < need) {
          __nanosleep(kPollNs);
          if (now_ns() - t0 > kWaitLimitNs) __trap();
        }
      }
    }
    if (step != cur) __syncthreads();
    cur = step;
    for (int k = lo; k < hi; ++k) {
      Lanes n;
      if (k + 1 < hi) fetch(n, P, k + 1, j);
      route2::slab_route(sh.t1, c.t, 0, c.sb, P.pane, P.rows, P.g, true);
      if (k == lo && j == 0 && ahead < P.nitems) {
        // the next item's range and step, loaded while this one runs
        ahead_lo = __ldg(P.item_start + ahead);
        ahead_hi = __ldg(P.item_start + ahead + 1);
        ahead_step = __ldg(P.item_step + ahead);
      }
      __syncthreads();
      route2::finish(sh, c.t, c.v, c.flag, c.yb, 0, P.pane, P.rows,
                     P.dist_max, P.any_lane, 1, 0, j,
                     route2::BlockBarrier{});
      // this chunk's publishes before the next chunk's gathers (the
      // next level, inside a stretch), and sh free for it
      __threadfence_block();
      if (k + 1 == hi && j == 0) {
        next_item = ahead;
        next_lo = ahead_lo;
        next_hi = ahead_hi;
        next_step = ahead_step;
      }
      __syncthreads();
      if (k + 1 < hi) c = n;
    }
    // the item is done: count it at once (release, cumulative over the
    // barrier above)
    if (j == 0) add_release(done + step, 1u);
  }
}

// blocks of the solve kernel the current device holds at once (per
// device, cached); 0 where it cannot say
long long solve_grid() {
  static long long cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route2_solve_kernel, kLanes, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = static_cast<long long>(per_sm) * sms;
  }
  return cached[dev];
}

}  // namespace

// tile, val: (nchunks, 8, 128) int32 / f32; slab_base, y_base, src_flag,
// rho: (nchunks,) int32 (rho may be null unless rotated); src:
// (src_rows, 128) f32; dst: (dst_rows, 128) f32, accumulated into.
// With order (the chunks of [lo, hi) by slab) and items (nitems + 1 work
// item starts in order) the slab kernel runs them, else a block a chunk.
extern "C" int route2_spmv_f32(const void* tile, const void* val,
                               const void* slab_base, const void* y_base,
                               const void* src_flag, const void* rho,
                               long long lo, long long hi, const void* src,
                               long long src_rows, void* dst,
                               long long dst_rows, int g, int dist_max,
                               int any_lane, int ww, int rotated,
                               const void* order, const void* items,
                               int nitems, void* stream) {
  if (hi > lo) {
    const Plan P{static_cast<const int*>(tile),
                 static_cast<const float*>(val),
                 static_cast<const int*>(slab_base),
                 static_cast<const int*>(y_base),
                 static_cast<const int*>(src_flag),
                 static_cast<const int*>(rho),
                 static_cast<const float*>(src),
                 static_cast<float*>(dst),
                 src_rows, dst_rows, g, dist_max, any_lane, ww, rotated};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (order != nullptr && nitems > 0) {
      if (g < 1 || g > 32) return static_cast<int>(cudaErrorInvalidValue);
      const long long blocks = slab_grid();
      if (blocks <= 0) {
        const int err = static_cast<int>(cudaGetLastError());
        return err ? err : static_cast<int>(cudaErrorUnknown);
      }
      const long long grid = nitems < blocks ? nitems : blocks;
      route2_slab_kernel<<<static_cast<unsigned>(grid), kSlabThreads,
                           kSlabSmem, st>>>(
          P, static_cast<const int*>(order), static_cast<const int*>(items),
          nitems);
    } else {
      route2_apply_kernel<<<static_cast<unsigned>(hi - lo), kLanes, 0,
                            st>>>(P, lo);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The complex product: chunks [lo, hi) of the plan (tile, slab_base,
// y_base, src_flag, rho as route2_spmv_f32) with the value planes val and
// val_im (nchunks, 8, 128) f32, reading src (src_rows, 128) of (re, im)
// f32 pairs (x_cx != 0) or of f32 (a real x), accumulating into dst
// (dst_rows, 128) of (re, im) pairs.
extern "C" int route2_cx_spmv_f32(const void* tile, const void* val,
                                  const void* val_im, const void* slab_base,
                                  const void* y_base, const void* src_flag,
                                  const void* rho, long long lo, long long hi,
                                  const void* src, int x_cx,
                                  long long src_rows, void* dst,
                                  long long dst_rows, int g, int dist_max,
                                  int any_lane, int ww, int rotated,
                                  void* stream) {
  if (hi > lo) {
    const PlanCx P{static_cast<const int*>(tile),
                   static_cast<const float*>(val),
                   static_cast<const float*>(val_im),
                   static_cast<const int*>(slab_base),
                   static_cast<const int*>(y_base),
                   static_cast<const int*>(src_flag),
                   static_cast<const int*>(rho),
                   src,
                   static_cast<float2*>(dst),
                   src_rows, dst_rows, g, dist_max, any_lane, ww, rotated};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(hi - lo);
    if (x_cx) {
      route2_cx_kernel<float2><<<grid, kLanes, 0, st>>>(P, lo);
    } else {
      route2_cx_kernel<float><<<grid, kLanes, 0, st>>>(P, lo);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Solve mode: one launch of route2_solve_kernel over the work list
// (item_start (nitems + 1,), item_step (nitems,), step_need (nsteps,)
// int32, made by kernels/route2.py build_solve_work; width, the most
// items of one step) and the one pane (rows, 128) f32, which holds y0 on
// entry and x on exit.  counters: (1 + nsteps,) uint32, zeroed.  Launches
// nothing when there is no item.
extern "C" int route2_solve_f32(const void* tile, const void* val,
                                const void* slab_base, const void* y_base,
                                const void* src_flag, const void* item_start,
                                const void* item_step, const void* step_need,
                                int nitems, int width, void* counters,
                                void* pane,
                                long long rows, int g, int dist_max,
                                int any_lane, void* stream) {
  if (nitems <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = solve_grid();
  if (blocks <= 0) {
    const int err = static_cast<int>(cudaGetLastError());
    return err ? err : static_cast<int>(cudaErrorUnknown);
  }
  const SolvePlan P{static_cast<const int*>(tile),
                    static_cast<const float*>(val),
                    static_cast<const int*>(slab_base),
                    static_cast<const int*>(y_base),
                    static_cast<const int*>(src_flag),
                    static_cast<const int*>(item_start),
                    static_cast<const int*>(item_step),
                    static_cast<const int*>(step_need),
                    static_cast<unsigned*>(counters),
                    static_cast<float*>(pane),
                    rows, nitems, g, dist_max, any_lane};
  // the widest step's items at once; more blocks would only wait
  const long long grid = width < blocks ? width : blocks;
  route2_solve_kernel<<<static_cast<unsigned>(grid), kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

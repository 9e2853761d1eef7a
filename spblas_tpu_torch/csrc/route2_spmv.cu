// ROUTE2 chunk SpMV for Hopper: one launch runs the chunks [lo, hi) of a
// ROUTE2 plan (spblas_tpu_torch/kernels/route2.py), reading the source
// pane `src` and publishing into the destination pane `dst` with atomic
// adds.  Both kernels below run route2_chunk.cuh's chunk body, shared
// with the solve mode and route_paned_spmv.cu.
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
// visible to the next level's gathers; here each dependency level (and
// each aux level of a hub level, right after its main chunks) is its
// own launch of route2_apply_kernel (its plan loads plain, see
// route2_chunk.cuh), at most max_chunks chunks each,
// issued in order from one C call with no host op between them.  A
// chunk's used slots read only rows of earlier levels; its unused slots
// (value 0) may read a row another block of the level is publishing to,
// a finite value either way, so their product stays 0.

#include "route2_chunk.cuh"

#include <cstdint>

namespace {

using route2::bits;
using route2::kLanes;
using route2::kSubs;

constexpr int kGroups = 8;      // chunks a slab block runs at once
constexpr int kMinBlocks = 10;  // blocks an SM of the apply kernel

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

// A block a chunk (the small launch ranges: aux levels, and the solve's
// levels): the slab rows gathered from src through L1/L2; the plan
// loaded evict-first with Stream (the SpMV), plainly for the solve.
template <bool Stream>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
    route2_apply_kernel(Plan P, long long lo) {
  __shared__ route2::Shared sh;
  const long long k = lo + blockIdx.x;
  route2::chunk(sh, P.tile, P.val, P.rho, k, __ldg(P.slab_base + k),
                __ldg(P.src_flag + k), __ldg(P.y_base + k), P.src,
                P.src_rows, P.dst, P.dst_rows, P.g, P.dist_max, P.any_lane,
                P.ww, P.rotated, Stream);
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
      route2_apply_kernel<true>
          <<<static_cast<unsigned>(hi - lo), kLanes, 0, st>>>(P, lo);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Solve mode: the launch ranges [starts[r], starts[r + 1]) (the last one
// ends at nchunks), each cut into launches of at most max_chunks chunks,
// all over the one pane (rows, 128) f32, which holds y0 on entry and x
// on exit.  starts is a host array.  *launches counts the launches made;
// returns the first launch error, or 0.
extern "C" int route2_solve_f32(const void* tile, const void* val,
                                const void* slab_base, const void* y_base,
                                const void* src_flag, const void* starts,
                                long long nstarts, long long nchunks,
                                long long max_chunks, void* pane,
                                long long rows, int g, int dist_max,
                                int any_lane, void* launches, void* stream) {
  const long long* st = static_cast<const long long*>(starts);
  long long* count = static_cast<long long*>(launches);
  float* p = static_cast<float*>(pane);
  const Plan P{static_cast<const int*>(tile),
               static_cast<const float*>(val),
               static_cast<const int*>(slab_base),
               static_cast<const int*>(y_base),
               static_cast<const int*>(src_flag),
               nullptr, p, p, rows, rows, g, dist_max, any_lane, 1, 0};
  for (long long r = 0; r < nstarts; ++r) {
    const long long hi = r + 1 < nstarts ? st[r + 1] : nchunks;
    for (long long lo = st[r]; lo < hi; lo += max_chunks) {
      const long long n = hi - lo < max_chunks ? hi - lo : max_chunks;
      route2_apply_kernel<false>
          <<<static_cast<unsigned>(n), kLanes, 0,
             static_cast<cudaStream_t>(stream)>>>(P, lo);
      const int err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
      ++*count;
    }
  }
  return 0;
}

// ROUTE v1 chunk SpMV for Hopper: one persistent launch runs every chunk
// of every level of a ROUTE v1 plan (spblas_tpu_torch/kernels/
// route_plan.py), level 0 reading the packed x, each later level reading
// the aux region the level before published, all into one buffer.
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
// The buffer (kernels/route_spmv.py::V1Layout): the shared y region into
// which every level publishes its y windows, then one region per level
// d >= 1 holding level d's packed x, which level d - 1 fills with its aux
// windows (zero padding included, so no packing runs between levels),
// then the counters (the claim counter and one done counter a level).
// The plan's fused_sb / fused_yb arrays are slab_base / y_base rebased
// into it at plan build.
//
// Differences from the TPU kernel, and why:
// - The TPU's grid is sequential: y += upd is safe, and the aux plan is a
//   second pallas_call after the first.  Here blocks run at once: the
//   publish is an atomicAdd per vA slot (sums into one row are taken in
//   an order that changes from run to run), and a chunk of level d waits
//   on level d - 1's done counter (below).
// - The gather is one load per slot from x (through L2), not the TPU's
//   g-way select over a VMEM-resident slab; slab rows are bounded by the
//   level's source rows and read 0 past them.
// - The prefix runs i downward so P[i - step] is still the previous
//   step's value, the simultaneous semantics of the TPU's roll; wrapped
//   sublanes (i < step) add nothing, as the numpy simulator masks them.
// - tile1's fields end at bit 25 and tile3's at bit 16, so no field
//   reaches the sign bit; chunk offsets are 64-bit.
//
// What bounds it on the H100: bytes, 12 KB of plan stream a chunk plus
// 8 B of per-chunk scalars, x and the buffer: 56.5 MB, 17 us at
// 3.35 TB/s, on the R-MAT 131k sorted base (3,670 / 209 / 13 / 2 / 1
// chunks).  The design of one launch a level took 65 us there (NVIDIA
// H100 80GB HBM3, 700 W; scripts/route_profile.py): level 0 31 us, each
// later level 4-5 us for one to 209 chunks, five pane memsets and the
// gaps between ten operations.  What costs is latency, not bytes: the
// launches and drains, and inside a chunk its chain of dependent steps.
//
// Design: one persistent launch after one memset.  A grid of 128-thread
// blocks, as many as fit on the card, thread j owning lane column j and
// keeping its 8 sublanes in registers:
// - Claims.  Thread 0 claims chunks in stream order (levels in order)
//   from one counter, keeping one claim pending, so a block's claims
//   increase and it runs them in claim order.
// - Ring.  Each block keeps the next chunk's tiles in flight into a
//   shared-memory stage (cp.async.bulk, evict-first in L2, so x and the
//   buffer stay in L2) and its two scalars (4-byte cp.async), both
//   completing on the stage's mbarrier, and refills a stage as soon as
//   every thread has read it.  While it computes a chunk it already
//   gathers the next chunk's x, where that chunk is of the same level.
// - Level order (release/acquire).  A block counts its finished chunks
//   of a level in a register; when its next chunk lies in another level,
//   and when it leaves, it synchronises, and one thread fences
//   (__threadfence, cumulative over the barrier) and adds the count to
//   the level's done counter.  A chunk of level d first has one thread
//   spin (an acquiring load at gpu scope) until level d - 1's counter
//   equals its chunk count, then the block synchronises; levels past the
//   first read the buffer through L2 (ld.cg), never a stale L1 line.
// - Forward progress.  Levels are contiguous in claim order, and a block
//   runs its claims in order, so before it waits it has run and counted
//   every chunk of an earlier level it claimed.  Level 0 waits on
//   nothing, so all its chunks finish and are counted, which ends every
//   wait on it, and so on level by level.  A block claims only while it
//   runs, so the grid may be any size.
// - The body.  The prefix is thread-local; each of the four sublane
//   pulls goes through the thread's own column of a 4 KB shared tile
//   (two accesses a value, where a register select ladder costs fourteen
//   instructions: the body is bound by instruction issue), each of the
//   two lane pulls through another 4 KB tile.

#include <cuda_runtime.h>

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;
constexpr int kSlots = kSubs * kLanes;
constexpr unsigned kTileBytes = kSlots * 4;
constexpr int kStages = 2;
constexpr int kMaxLevels = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a stage's barrier completes a phase on two arrivals (the bulk copies'
// expect_tx and the scalar copies' cp.async arrive) and the bytes
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of bulk copies on the barrier
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                          unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// L2 policy for data read once (the plan stream): evicted first, so it
// does not push x and the output out of L2
__device__ __forceinline__ unsigned long long evict_first() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar,
                                          unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// 4 bytes from global to shared memory (a per-chunk scalar)
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's earlier copy4s have landed
__device__ __forceinline__ void copies_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// order this thread's earlier generic-proxy accesses of shared memory
// before the bulk copies it issues next into the same stage
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// one thread spins until *counter reaches `need`; the caller then
// synchronises the block
__device__ __forceinline__ void wait_count(const unsigned* counter,
                                           unsigned need) {
  while (load_acquire(counter) < need) __nanosleep(32);
}

// persistent grid: as many 128-thread blocks as fit on the card at once,
// at most `work` (0 when there is none)
inline unsigned grid_size(const void* kernel, long long work) {
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const long long full = static_cast<long long>(per_sm) * sms;
  return static_cast<unsigned>(work < full ? work : full);
}

struct Level {
  const int* tile1;
  const int* tile3;
  const float* val;
  const int* sb;          // fused_sb: slab base row in this level's source
  const int* yb;          // fused_yb: window base row in the buffer
  long long end;          // one past the level's last chunk, in claim order
  long long src_rows;     // rows of the source readable by this level
  int g;
};

struct Params {
  Level lv[kMaxLevels];
  int nlevels;
  const float* x2;        // level 0's source: the packed x
  float* buf;             // the buffer: y region, aux regions
  long long buf_rows;
  unsigned* counters;     // [0] claims, [1 + d] chunks of level d done
};

struct __align__(128) Stage {
  int t1[kSlots];
  int t3[kSlots];
  float val[kSlots];
  int sb;                 // the chunk's fused_sb and fused_yb
  int yb;
};

// a sublane pull, out[i] = in[field(f[i])], through the thread's own
// column of shared memory (the body is bound by instruction issue, and
// this costs two accesses a value where a register select ladder costs
// fourteen instructions)
__device__ __forceinline__ void pull(float (&out)[kSubs],
                                     const float (&in)[kSubs],
                                     const int (&f)[kSubs], int shift,
                                     float (&col)[kSubs][kLanes]) {
  const int j = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kSubs; ++i) col[i][j] = in[i];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) out[i] = col[(f[i] >> shift) & 7][j];
}

__device__ __forceinline__ int bits(int t, int shift, int mask) {
  return (t >> shift) & mask;
}

__device__ __forceinline__ int level_of(const Params& P, long long k) {
  int d = 0;
  while (d + 1 < P.nlevels && k >= P.lv[d].end) ++d;
  return d;
}

__device__ __forceinline__ long long level_start(const Params& P, int d) {
  return d ? P.lv[d - 1].end : 0;
}

// thread 0: start the copies of chunk k (three tiles, two scalars) into
// `st`, completing on `bar`
__device__ __forceinline__ void issue(const Params& P, long long k,
                                      Stage& st, unsigned long long* bar,
                                      unsigned long long policy) {
  const int d = level_of(P, k);
  const Level& L = P.lv[d];
  const long long lk = k - level_start(P, d);
  const long long off = lk * kSlots;
  copy4(&st.sb, L.sb + lk);
  copy4(&st.yb, L.yb + lk);
  copies_arrive(bar);
  proxy_fence();
  bar_expect(bar, 3 * kTileBytes);
  bulk_load(st.t1, L.tile1 + off, kTileBytes, bar, policy);
  bulk_load(st.t3, L.tile3 + off, kTileBytes, bar, policy);
  bulk_load(st.val, L.val + off, kTileBytes, bar, policy);
}

// the gather of thread j: vx[i] = x[sb + 8*oct + i, l] for oct < g, from
// level d's source (the aux regions are written during the launch, so
// levels past the first read them from L2)
__device__ __forceinline__ void gather(float (&vx)[kSubs],
                                       const int (&a)[kSubs], long long sb,
                                       const Params& P, int d) {
  const Level& L = P.lv[d];
  const float* xs = d ? P.buf : P.x2;
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    const int oct = bits(a[i], 10, 7);
    const long long row = sb + kSubs * oct + i;
    vx[i] = 0.f;
    if (oct < L.g && row < L.src_rows) {
      const float* px = xs + row * kLanes + bits(a[i], 3, 127);
      vx[i] = d ? __ldcg(px) : __ldg(px);
    }
  }
}

__global__ void __launch_bounds__(kLanes)
    route_spmv_kernel(const __grid_constant__ Params P) {
  __shared__ Stage ring_st[kStages];
  __shared__ float s[kSubs][kLanes];      // the lane-pull tile
  __shared__ float col[kSubs][kLanes];    // each thread's pull column
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ long long chunk_of[kStages];

  const int j = threadIdx.x;
  const long long total = P.lv[P.nlevels - 1].end;
  unsigned* claims = P.counters;
  unsigned* done = P.counters + 1;
  const unsigned long long policy = evict_first();

  long long pending = 0;      // thread 0: the next claim, not yet issued
  if (j == 0) {
    for (int st = 0; st < kStages; ++st) bar_init(&full[st]);
    bar_init_fence();
    for (int st = 0; st < kStages; ++st) {
      const long long k = atomicAdd(claims, 1u);
      chunk_of[st] = k;
      if (k < total) issue(P, k, ring_st[st], &full[st], policy);
    }
    pending = atomicAdd(claims, 1u);
  }
  __syncthreads();

  int cur = 0;                // level of the block's chunks so far
  unsigned ndone = 0;         // of them, done but not yet counted
  bool ahead = false;         // a_next and x_next hold this chunk's
  int a_next[kSubs];
  float x_next[kSubs];
  for (long long it = 0;; ++it) {
    const int st = static_cast<int>(it % kStages);
    const long long k = chunk_of[st];
    const int d = k < total ? level_of(P, k) : -1;
    if (d != cur) {
      // count the block's chunks of its level (release), then wait for
      // the level this chunk reads (acquire); both block-uniform
      __syncthreads();
      if (j == 0) {
        if (ndone) {
          __threadfence();
          atomicAdd(done + cur, ndone);
        }
        if (d > 0) {
          wait_count(done + d - 1, static_cast<unsigned>(
                                             P.lv[d - 1].end -
                                             level_start(P, d - 1)));
          __threadfence();
        }
      }
      __syncthreads();
      cur = d;
      ndone = 0;
    }
    if (d < 0) break;

    bar_wait(&full[st], static_cast<unsigned>((it / kStages) & 1));
    const Stage& tiles = ring_st[st];
    const long long yb = tiles.yb;
    int a[kSubs], b[kSubs];
    float c[kSubs];
    if (ahead) {
#pragma unroll
      for (int i = 0; i < kSubs; ++i) {
        a[i] = a_next[i];
        c[i] = x_next[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSubs; ++i) a[i] = tiles.t1[i * kLanes + j];
      gather(c, a, tiles.sb, P, d);
    }
#pragma unroll
    for (int i = 0; i < kSubs; ++i) {
      b[i] = tiles.t3[i * kLanes + j];
      c[i] *= tiles.val[i * kLanes + j];
    }

    // permute 1: sublane pull q1, lane pull q2 (shared), sublane pull q3
    float t[kSubs];
#pragma unroll
    pull(t, c, a, 13, col);
#pragma unroll
    for (int i = 0; i < kSubs; ++i) s[i][j] = t[i];
    __syncthreads();
    if (j == 0) {
      // every thread has read the stage: refill it with the pending
      // claim, and claim the next
      chunk_of[st] = pending;
      if (pending < total) issue(P, pending, ring_st[st], &full[st], policy);
      pending = atomicAdd(claims, 1u);
    }
    // the next chunk's gather, in flight while this one computes, when
    // it reads what this chunk's level reads
    {
      const int st1 = static_cast<int>((it + 1) % kStages);
      const long long k1 = chunk_of[st1];
      ahead = k1 < total && level_of(P, k1) == d;
      if (ahead) {
        bar_wait(&full[st1],
                       static_cast<unsigned>(((it + 1) / kStages) & 1));
#pragma unroll
        for (int i = 0; i < kSubs; ++i)
          a_next[i] = ring_st[st1].t1[i * kLanes + j];
        gather(x_next, a_next, ring_st[st1].sb, P, d);
      }
    }
#pragma unroll
    for (int i = 0; i < kSubs; ++i) c[i] = s[i][bits(a[i], 16, 127)];
    pull(t, c, a, 23, col);

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
    pull(c, t, b, 4, col);
    __syncthreads();               // every lane pull of permute 1 is done
#pragma unroll
    for (int i = 0; i < kSubs; ++i) s[i][j] = c[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSubs; ++i) t[i] = s[i][bits(b[i], 7, 127)];
    pull(c, t, b, 14, col);

    // publish every vA slot into the (8, 128) window at yb
    float* dst = P.buf;
#pragma unroll
    for (int i = 0; i < kSubs; ++i) {
      const long long row = yb + i;
      if (bits(b[i], 3, 1) && row < P.buf_rows)
        atomicAdd(dst + row * kLanes + j, c[i]);
    }
    ++ndone;
    __syncthreads();               // the lane tile is free for the next
  }
}

}  // namespace

// desc: 8 words a level, nlevels levels: tile1, tile3, val ((n_d, 8, 128)
// int32 / int32 / f32), fused_sb, fused_yb ((n_d,) int32) as pointers,
// the running chunk count, the source rows, g.  x2: level 0's packed x;
// buf: (buf_rows * 128 + 16) f32, zeroed, its last 16 words the
// counters.  Launches nothing when there is no chunk.
extern "C" int route_spmv_f32(const long long* desc, int nlevels,
                              const void* x2, void* buf, long long buf_rows,
                              void* stream) {
  if (nlevels < 1 || nlevels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{};
  for (int d = 0; d < nlevels; ++d) {
    const long long* w = desc + 8 * d;
    P.lv[d] = Level{reinterpret_cast<const int*>(w[0]),
                    reinterpret_cast<const int*>(w[1]),
                    reinterpret_cast<const float*>(w[2]),
                    reinterpret_cast<const int*>(w[3]),
                    reinterpret_cast<const int*>(w[4]),
                    w[5],
                    w[6],
                    static_cast<int>(w[7])};
  }
  P.nlevels = nlevels;
  P.x2 = static_cast<const float*>(x2);
  P.buf = static_cast<float*>(buf);
  P.buf_rows = buf_rows;
  P.counters = reinterpret_cast<unsigned*>(static_cast<float*>(buf) +
                                           buf_rows * kLanes);
  const long long total = desc[8 * nlevels - 3];
  const unsigned grid =
      grid_size(reinterpret_cast<const void*>(route_spmv_kernel), total);
  if (grid > 0) {
    route_spmv_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        P);
  }
  return static_cast<int>(cudaGetLastError());
}

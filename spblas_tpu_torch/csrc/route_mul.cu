// ROUTE v1 SpGEMM numeric for Hopper: one launch runs every chunk of a
// RouteMulPlan (spblas_tpu_torch/kernels/route_mul.py), computing
//   c_values[slot] += A_arr[src_a] * B_arr[src_b]
// over the whole SpGEMM expansion stream, reading the A and B value panes
// and publishing into the out pane with atomic adds.
//
// Replaces the TPU kernel spblas_tpu/kernels/route_mul_kernel.py::
// _mul_kernel (pl.pallas_call in route_mul).  Per (8, 128) chunk (three
// int32 tiles, 12 KB, no value tile):
//   vb[i,j] = B[(bb + 8*ob[i,j] + i) * 128 + lb[i,j]]     for ob < g_b
//   ua[a,j] = A[(ab + 8*oa[a,j] + a) * 128 + la[a,j]]     for oa < g_a
//   c[i,j]  = ua[s7a[i,j], j] * vb[i,j]
//   c       = c[q1[i,j], j]; c = c[i, q2[i,j]]; c = c[q3[i,j], j]   permute 1
//   P       = segmented prefix of c down the 8 sublanes, steps 1, 2, 4,
//             where dist >= step
//   RS      = P[p1[i,j], j]; RS = RS[i, p2[i,j]]; RS = RS[p3[i,j], j] permute 2
//   out[(ob_k + i) * 128 + j] += RS[i,j]                   where vA[i,j]
// with lb, ob, q1, q2, q3 the tile1 fields at bits 0, 7, 13, 16, 23; la,
// oa, s7a the tile2 fields at bits 0, 7, 10; dist, vA, p1, p2, p3 the
// tile3 fields at bits 0, 3, 4, 7, 14 (no field reaches the sign bit).
//
// Differences from the TPU kernel, and why:
// - Out windows overlap: every chunk of a 1024-slot stripe, across all
//   its (A window, B window) cells, adds into the same 8-row window, and
//   a heavily duplicated stream packs tens of chunks a window.  The TPU's
//   sequential grid makes its `o += upd` safe; CUDA blocks run in no
//   order, so each block publishes with one atomicAdd per vA slot (only
//   those: a chunk's other 1024 - nseg slots carry no segment end).  One
//   owner per window would need the chunks grouped by window and a
//   reduction across them; the atomics keep the plan as JAX builds it.
//   Sums into one slot are then taken in an order that changes from run
//   to run.
// - The prefix runs i downward so P[i - step] is still the previous
//   step's value, the simultaneous semantics of the TPU's roll.  The
//   Pallas kernel's roll wraps rows i < step around and the JAX simulator
//   zeroes them; this kernel adds nothing there, as the simulator.  Both
//   agree with the TPU only because no packed tile sets dist >= step on a
//   sublane below step (tests/test_torch_route_mul.py shows it).
// - The gathers are one load per slot from the panes in device memory
//   (through L1/L2), not the TPU's g-way select of lane gathers over
//   VMEM-resident slabs.  Slab rows are bounded by the pane rows and read
//   0 past them; chunk offsets are 64-bit.
//
// What bounds it on the H100: bytes, 12 KB of tiles per chunk plus 12 B
// of per-chunk scalars, the A and B panes read once and the out pane
// written twice (zeroed, then accumulated).
//
// Design: one 128-thread block per chunk, thread j owning lane column j
// and its 8 sublanes in registers, as route_spmv.cu: the tiles are read
// coalesced (one 512-byte row per sublane), the sublane pulls and the
// prefix are thread-local select ladders, and each of the two lane pulls
// passes through a 4 KB shared tile.

#include <cuda_runtime.h>

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;

__device__ __forceinline__ float pick8(const float (&v)[kSubs], int idx) {
  float out = v[0];
#pragma unroll
  for (int a = 1; a < kSubs; ++a) out = (idx == a) ? v[a] : out;
  return out;
}

__device__ __forceinline__ int bits(int t, int shift, int mask) {
  return (t >> shift) & mask;
}

__global__ void route_mul_kernel(
    const int* __restrict__ tile1, const int* __restrict__ tile2,
    const int* __restrict__ tile3, const int* __restrict__ a_base,
    const int* __restrict__ b_base, const int* __restrict__ o_base,
    const float* __restrict__ A, long long a_rows,
    const float* __restrict__ B, long long b_rows, float* __restrict__ out,
    long long out_rows, int g_a, int g_b) {
  __shared__ float s[kSubs][kLanes];

  const long long k = blockIdx.x;
  const int j = threadIdx.x;
  const long long base = k * (kSubs * kLanes);
  const long long ab = a_base[k];
  const long long bb = b_base[k];

  int a[kSubs], a2[kSubs], b[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    a[i] = tile1[base + i * kLanes + j];
    a2[i] = tile2[base + i * kLanes + j];
    b[i] = tile3[base + i * kLanes + j];
  }

  // A gather, step 1: ua[r] = A slab row 8*oa + r at lane la, per the
  // tile2 word at (r, j)
  float ua[kSubs];
#pragma unroll
  for (int r = 0; r < kSubs; ++r) {
    const int oa = bits(a2[r], 7, 7);
    const long long row = ab + kSubs * oa + r;
    ua[r] = (oa < g_a && row < a_rows)
                ? A[row * kLanes + bits(a2[r], 0, 127)] : 0.f;
  }
  // B gather (elementwise) and the products, with A's step 2 (s7a)
  float c[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    const int ob = bits(a[i], 7, 7);
    const long long row = bb + kSubs * ob + i;
    const float vb = (ob < g_b && row < b_rows)
                         ? B[row * kLanes + bits(a[i], 0, 127)] : 0.f;
    c[i] = pick8(ua, bits(a2[i], 10, 7)) * vb;
  }

  // permute 1: sublane pull q1, lane pull q2 (shared), sublane pull q3
  float t[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) t[i] = pick8(c, bits(a[i], 13, 7));
#pragma unroll
  for (int i = 0; i < kSubs; ++i) s[i][j] = t[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSubs; ++i) c[i] = s[i][bits(a[i], 16, 127)];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) t[i] = pick8(c, bits(a[i], 23, 7));

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
#pragma unroll
  for (int i = 0; i < kSubs; ++i) c[i] = pick8(t, bits(b[i], 4, 7));
  __syncthreads();                 // every lane pull of permute 1 is done
#pragma unroll
  for (int i = 0; i < kSubs; ++i) s[i][j] = c[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSubs; ++i) t[i] = s[i][bits(b[i], 7, 127)];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) c[i] = pick8(t, bits(b[i], 14, 7));

  // publish every vA slot into the (8, 128) out window at o_base
  const long long ob = o_base[k];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    const long long row = ob + i;
    if (bits(b[i], 3, 1) && row < out_rows)
      atomicAdd(out + row * kLanes + j, c[i]);
  }
}

}  // namespace

// tile1, tile2, tile3: (nchunks, 8, 128) int32; a_base, b_base, o_base:
// (nchunks,) int32; A: (a_rows, 128) f32; B: (b_rows, 128) f32; out:
// (out_rows, 128) f32, accumulated into.
extern "C" int route_mul_f32(const void* tile1, const void* tile2,
                             const void* tile3, const void* a_base,
                             const void* b_base, const void* o_base,
                             long long nchunks, const void* A,
                             long long a_rows, const void* B,
                             long long b_rows, void* out, long long out_rows,
                             int g_a, int g_b, void* stream) {
  if (nchunks > 0) {
    route_mul_kernel<<<static_cast<unsigned>(nchunks), kLanes, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile1), static_cast<const int*>(tile2),
        static_cast<const int*>(tile3), static_cast<const int*>(a_base),
        static_cast<const int*>(b_base), static_cast<const int*>(o_base),
        static_cast<const float*>(A), a_rows, static_cast<const float*>(B),
        b_rows, static_cast<float*>(out), out_rows, g_a, g_b);
  }
  return static_cast<int>(cudaGetLastError());
}

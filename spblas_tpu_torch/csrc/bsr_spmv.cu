// BSR SpMV for Hopper: y = A·x with A stored as dense (bh, bw) blocks.
//
// Replaces the TPU kernel spblas_tpu/kernels/bsr_pallas.py::
// _bsr_spmv_kernel (pl.pallas_call in bsr_spmv).  Block row i holds the
// blocks e in [rowptr[i], rowptr[i+1]); block e covers columns
// [colind[e]*bw, colind[e]*bw + bw), so
//   y[i*bh + r] = sum_e sum_c values[e, r, c] * x[colind[e]*bw + c].
// Blocks past the stored count (capacity padding) are never reached:
// only rowptr bounds a row's loop.
//
// What bounds it on the H100: bytes.  Every stored block value is read
// once (2 flops each); at the chooser's 8x128 blocks the matrix is
// 1024 values per 8 rows, so the kernel streams values, x slices and y.
//
// Design: one warp per output row.  The 32 lanes stride over the bw
// columns of each block of the row's block row, so a load instruction of
// the warp reads consecutive values and consecutive x (coalesced); the
// sum finishes with a __shfl_down_sync tree and one store.  At 8x128
// blocks one 256-thread CTA is one block row (8 warps, one per row).  An
// empty block row writes 0 (the output comes from torch.empty).  Every
// output row has exactly one writer: no atomics, and no reliance on the
// TPU's in-order grid (whose kernel writes its whole (mb, bh) output
// from each program).  f32 and f64 instantiations: the BSR base path
// takes any BSR, and the TPU kernel computes in result_type(A, x).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, 8 output rows per CTA

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const T* __restrict__ values, const int* __restrict__ rowptr,
                const int* __restrict__ colind, const T* __restrict__ x,
                T* __restrict__ y, long long rows, int bh, int bw) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const long long i = row / bh;
  const int r = static_cast<int>(row - i * bh);
  const int lo = rowptr[i], hi = rowptr[i + 1];
  T acc = T(0);
  for (int e = lo; e < hi; ++e) {
    const T* a = values + (static_cast<long long>(e) * bh + r) * bw;
    const T* xs = x + static_cast<long long>(colind[e]) * bw;
    for (int c = lane; c < bw; c += 32) acc = fma(a[c], xs[c], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) y[row] = acc;
}

template <typename T>
int launch(const void* values, const void* rowptr, const void* colind,
           const void* x, void* y, int mb, int bh, int bw, void* stream) {
  const long long rows = static_cast<long long>(mb) * bh;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    bsr_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(values), static_cast<const int*>(rowptr),
        static_cast<const int*>(colind), static_cast<const T*>(x),
        static_cast<T*>(y), rows, bh, bw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: (capacity, bh, bw) row-major; rowptr: (mb + 1,) int32; colind:
// (capacity,) int32; x: (>= ncols * bw,); y: (mb * bh,).  One dtype for
// values, x and y.
extern "C" int bsr_spmv_f32(const void* values, const void* rowptr,
                            const void* colind, const void* x, void* y,
                            int mb, int bh, int bw, void* stream) {
  return launch<float>(values, rowptr, colind, x, y, mb, bh, bw, stream);
}

extern "C" int bsr_spmv_f64(const void* values, const void* rowptr,
                            const void* colind, const void* x, void* y,
                            int mb, int bh, int bw, void* stream) {
  return launch<double>(values, rowptr, colind, x, y, mb, bh, bw, stream);
}

// Fused multi-diagonal (DIA) SpMV for Hopper:
//   y[i] = sum_k diags[k][i] * x2[i + pad_lo + offsets[k]]
// over the padded rows_pad*128 outputs.
//
// Replaces the TPU kernel spblas_tpu/kernels/dia.py::_dia_kernel
// (pl.pallas_call in _dia_spmv_pallas).  The diagonals keep the JAX
// plan's (ndiag, rows_pad, 128) layout, viewed flat; x2 is x padded on the
// host side exactly as the JAX wrapper pads it (pad_lo zeros in front and
// enough behind), so every read below is in bounds and needs no mask.
//
// What bounds it on the H100: bytes.  It reads every diagonal slot once
// and x once (the ndiag shifted reads of x overlap and hit L1/L2), and
// writes y once: about (ndiag + 2) * rows_pad * 128 * 4 bytes, 28.4 MB
// (about 8.5 us at 3.35 TB/s) for the 1000x1000 5-point stencil.
//
// Design: one thread per output element.  Neighbouring threads read
// neighbouring addresses of each diagonal and of x (coalesced); the
// offsets, a handful of int32s, are the same for every thread and are
// served by the cache as broadcasts.  The sum runs over k in the order of
// the TPU kernel.  Each output has exactly one writer: no atomics, and no
// reliance on the TPU's in-order grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void dia_spmv_kernel(const float* __restrict__ diags,
                                const int* __restrict__ offsets, int ndiag,
                                const float* __restrict__ x2,
                                float* __restrict__ y, long long total,
                                int pad_lo) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int k = 0; k < ndiag; ++k) {
    acc += diags[k * total + i] * x2[i + pad_lo + __ldg(offsets + k)];
  }
  y[i] = acc;
}

}  // namespace

// diags: (ndiag, total) f32; offsets: (ndiag,) int32 on the device;
// x2: f32 of length >= total + pad_lo + max(offsets); y: (total,) f32.
extern "C" int dia_spmv_f32(const void* diags, const void* offsets,
                            int ndiag, const void* x2, void* y,
                            long long total, int pad_lo, void* stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0) {
    dia_spmv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(diags), static_cast<const int*>(offsets),
        ndiag, static_cast<const float*>(x2), static_cast<float*>(y), total,
        pad_lo);
  }
  return static_cast<int>(cudaGetLastError());
}

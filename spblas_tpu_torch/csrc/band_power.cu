// Band power iterations for Hopper: y = A^iters · x over dense (128, W)
// band panels of a square matrix, every iteration issued from one C call.
//
// Replaces the TPU kernel spblas_tpu/kernels/banded.py::_power_kernel
// (pl.pallas_call in band_power_iterations).  The TPU runs the grid
// (iters, nblk/8) in order with x resident in VMEM, and the last block of
// each iteration publishes y into the padded slot.  CUDA blocks run in no
// order, and every row of iteration i + 1 reads a window of iteration
// i's y, so each iteration is its own launch of the band row kernel
// (band_row.cuh, shared with band_spmv.cu) over two padded ping-pong
// buffers of length L = rows + W - 128: iteration i reads buffer i % 2
// and writes rows [h, h + rows) of the other one.  Their halo edges
// [0, h) and [h + rows, L) are never written and stay zero (the caller
// zero-pads x), so every iteration sees the same padding as the TPU's.
// The launches follow each other on one stream with no host op between
// them.  A persistent kernel with a grid-wide sync between iterations
// would save the launch gaps; that is later work.
//
// What bounds it on the H100: bytes, iters times one band SpMV (the
// panels stream again each iteration: 380 MB, 114 us, per iteration at
// the headline shape, where the panels are seven times the 50 MB L2).
// The row kernel's design (band_row.cuh: 16-byte panel loads, the window
// in shared memory, several rows a warp) is what nears that rate; the
// launch gaps cost about 1 % of the chain.  Reading each panel strip
// once for several iterations (temporal blocking) is the next step past
// the per-iteration bound.

#include "band_row.cuh"

namespace {

template <typename T>
int power(const void* panels, void* buf0, void* buf1, int rows, int w,
          int h, int iters, void* stream) {
  float* bufs[2] = {static_cast<float*>(buf0), static_cast<float*>(buf1)};
  for (int it = 0; it < iters; ++it) {
    const int err = band::launch_rows(
        static_cast<const T*>(panels), bufs[it & 1], bufs[(it + 1) & 1] + h,
        rows, w, static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// panels: (rows, w) f32 or bf16, rows a multiple of 128; buf0: the padded
// x (L floats, x at [h, h + rows), zeros elsewhere); buf1: L zeros.  The
// result is in buf0 when iters is even, else in buf1.
extern "C" int band_power_f32(const void* panels, void* buf0, void* buf1,
                              int rows, int w, int h, int iters,
                              void* stream) {
  return power<float>(panels, buf0, buf1, rows, w, h, iters, stream);
}

extern "C" int band_power_bf16(const void* panels, void* buf0, void* buf1,
                               int rows, int w, int h, int iters,
                               void* stream) {
  return power<__nv_bfloat16>(panels, buf0, buf1, rows, w, h, iters,
                              stream);
}

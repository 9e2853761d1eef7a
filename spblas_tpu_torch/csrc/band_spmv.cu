// Band-panel SpMV for Hopper: y = A·x over dense (128, W) band panels.
//
// Replaces the TPU kernel spblas_tpu/kernels/banded.py::_spmv_kernel
// (pl.pallas_call in band_spmv_padded).  Panel row r belongs to row block
// blk = r / 128, and panel column c holds A[r, blk*128 + c - pad_l]; x
// arrives pre-padded by pad_l as xp, so the row's window is
// xp[blk*128 .. blk*128 + W).
//
// What bounds it on the H100: bytes.  Every panel element is read once
// (2 flops each), so the kernel streams rows*W*sizeof(T) bytes of panels
// plus xp and y; at the headline shape (409,600 rows, W = 232, f32) that
// is 380 MB, about 114 us at 3.35 TB/s.  The first design (one warp a
// row, 4-byte loads) took 163 us there, and 133 us on bf16 panels whose
// bound is 58 us (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): the
// count of loads and the bytes in flight held it, not the bytes.
//
// Design (band_row.cuh, shared with band_power.cu): a block takes 64
// rows and copies their x window into shared memory once; each warp runs
// groups of 4 (f32) or 8 (bf16) rows with 16-byte, evict-first panel
// loads, 8 in flight a lane, and sums a group's rows across the warp in
// one halving exchange.  Every output row has exactly one writer: no
// atomics, and no reliance on the TPU's in-order grid.

#include "band_row.cuh"

// panels: (rows, w) f32 or bf16, row-major; xp: f32 of length
// >= rows - 128 + w; y: (rows,) f32.  rows is a multiple of 128.
extern "C" int band_spmv_f32(const void* panels, const void* xp, void* y,
                             int rows, int w, void* stream) {
  return band::launch_rows(static_cast<const float*>(panels),
                           static_cast<const float*>(xp),
                           static_cast<float*>(y), rows, w,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int band_spmv_bf16(const void* panels, const void* xp, void* y,
                              int rows, int w, void* stream) {
  return band::launch_rows(static_cast<const __nv_bfloat16*>(panels),
                           static_cast<const float*>(xp),
                           static_cast<float*>(y), rows, w,
                           static_cast<cudaStream_t>(stream));
}

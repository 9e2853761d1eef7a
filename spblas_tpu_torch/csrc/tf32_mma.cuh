// Full-f32 matrix products on the tensor cores by the 3xTF32 split,
// shared by the streamed band SpMM (band_spmm.cu) and the BSR SpMM
// (bsr_spmm.cu).  The TPU kernels they replace dot at
// Precision.HIGHEST, which splits each f32 operand into bf16 pieces and
// runs several passes on the matrix unit; this is the same idea on
// Hopper's TF32 tensor cores.
//
// The split.  An f32 x becomes two TF32 values (10 explicit mantissa
// bits): hi = rna(x) and lo = rna(x - hi), each rounded to nearest with
// ties away from zero (what cvt.rna.tf32.f32 does, here by two integer
// operations on the bits).  x - hi is exact, and hi + lo gives x back
// within 2^-22 |x|.  a*b is then a_hi*b_hi + a_hi*b_lo + a_lo*b_hi; the
// dropped a_lo*b_lo and the residues of the two splits are below about
// 6 eps_f32 |a*b|, inside the 64 eps (|A|.|B|) tolerance of the port.
// A bf16 value is exact in TF32 (lo = 0), so bf16 operands need two
// products.
//
// The accumulator.  One mma step sums its products and the accumulator
// in f32 with truncation, not rounding to nearest.  Truncation is biased:
// kept across a long sum, the mma accumulator would drift by up to an
// ulp of the running sum a step (of 29 steps at the band's W 232, of 64
// at four 8x128 blocks), which on all-positive data approaches the
// tolerance.  So every step starts from zero: the two correction
// products first, then hi*hi, into a fresh four-register tile that an
// ordinary f32 add (rounded to nearest) folds into the running sum.  The
// truncation then costs about an ulp of one step's 24 products, not of
// the running sum, and the correction terms never meet the large sum
// inside the tensor core.  tests/test_torch_tf32.py models this
// arithmetic on the CPU against float64.
//
// Limits.  |x| >= 2^128 (1 - 2^-12), within half a TF32 ulp of FLT_MAX,
// rounds hi to infinity, so such an operand gives inf or NaN where the
// f32 product is finite.  A lo part below 2^-126 (operands below about
// 2^-115) is subnormal and the tensor cores may flush it.

#pragma once

#include <cstdint>

namespace tf32 {

// x rounded to TF32, to nearest with ties away from zero; the low 13 bits
// are zero (infinity stays infinity)
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));   // exact difference
}

// d += a*b for one m16n8k8 step: a the row-major 16x8 fragment, b the
// column-major 8x8 one, d the 16x8 f32 tile (PTX ISA fragment layouts)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a*b over one step in full f32: the correction products, then
// hi*hi, from zero, folded by an f32 add.  A_LO = false for an A that is
// exact in TF32 (bf16 panels).
template <bool A_LO>
__device__ __forceinline__ void step(float (&acc)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (A_LO) mma(t, alo, bhi);
  mma(t, ahi, blo);
  mma(t, ahi, bhi);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += t[q];
}

}  // namespace tf32

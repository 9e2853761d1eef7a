// Full-f32 matrix products on the tensor cores by the 3xTF32 split,
// shared by the streamed band SpMM (band_spmm.cu), the BSR SpMM
// (bsr_spmm.cu) and the block SpGEMM (bsr_spgemm.cu).  The TPU kernels
// they replace dot at Precision.HIGHEST, which splits each f32 operand
// into bf16 pieces and runs several passes on the matrix unit; this is
// the same idea on Hopper's TF32 tensor cores.
//
// The split.  An f32 x becomes two TF32 values (10 explicit mantissa
// bits): hi = rna(x), rounded to nearest with ties away from zero (what
// cvt.rna.tf32.f32 does, here by two integer operations on the bits),
// and lo = x - hi, exact, which the tensor cores read truncated to TF32
// (they ignore an operand's low 13 bits; measured on the card).  hi +
// lo gives x back within 2^-22 |x|.  a*b is then a_hi*b_hi + a_hi*b_lo + a_lo*b_hi;
// the dropped a_lo*b_lo and the residues of the two splits are below
// about 9 eps_f32 |a*b|, inside the 64 eps (|A|.|B|) tolerance of the
// port.  A bf16 value is exact in TF32 (lo = 0), so bf16 operands need
// two products.
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
// Limits.  The edges of the f32 range.  hi is rna(x) clamped to the
// largest finite TF32 value, +-0x7f7fe000, by two f32 min/max (no branch
// in the loops): a finite x within half a TF32 ulp of FLT_MAX (|x| >=
// 2^128 (1 - 2^-12)), which rna rounds up to infinity, keeps hi finite and
// lo = x - hi exact, so the product keeps f32 accuracy.  lo is x - hi
// as it is, truncated by the tensor cores (rounding its bits, as hi's
// are, could carry a NaN into the sign and lose it).  An infinite x
// splits into hi = +-0x7f7fe000 and lo = x, so its infinity reaches the
// product through a_lo*b_hi; a NaN x reaches it through lo.  But against
// a finite operand whose own lo passes 1 in magnitude (|b| > 2^11) the
// other correction product overflows too and may carry the opposite
// sign: the sum reads NaN where the f32 product is infinite.  Finite
// operands whose product passes FLT_MAX can read NaN in the same way, or
// an infinity where the f32 product is finite (hi*hi rounds up).  A bf16
// A (A_LO = false) is not split, so an infinite panel value meets b_lo =
// 0 as a NaN.  At the low end a lo part below 2^-126 (operands below
// about 2^-115) is a TF32 subnormal.  The tensor cores keep TF32
// subnormals (2^-130 x 2^120 is exact on the card; NVIDIA H100 80GB
// HBM3, 700 W), but on TF32's grid of 2^-136, so an operand below 2^-112
// keeps fewer bits than f32: A at 2^-120 against B at 2^120 read 2.06 of
// the 64 eps (|A| |B|) limit on one row of 16,384 in the streamed band
// kernel (chip_smoke.py).
//
// What the kernels do about it.  The sparse operand is tested once and
// the answer kept with it (types.tf32_gate, cached as
// BandPlan.tf32_exact and BSR.tf32_exact, beside its largest magnitude
// amax): one with a nonzero below 2^-112, an infinity or a NaN takes an
// exact kernel (the resident band FMA kernel, the f32 BSR FMA kernel,
// the f64 block SpGEMM).  The dense B of an SpMM is tested as the kernel
// splits it (b_fails): a B value is flagged when it is nonzero below
// 2^-112, or when its magnitude is not at most lim = FLT_MAX / (amax (1
// + 2^-9)) (types.tf32_b_limit), which every infinity and NaN fails.
// |x_hi| <= |x| (1 + 2^-11) and |x_lo| <= 2^-11 |x|, so within that
// limit no product of the split (a_lo b_hi, a_hi b_lo, a_hi b_hi)
// passes FLT_MAX.  A warp
// that flagged a value raises the call's flag (one __any_sync, one
// store), and the exact kernel, launched after the tensor-core one on
// the same stream, runs the whole product when the flag is up and exits
// at once when it is not: no host read.  Where no product passes
// FLT_MAX, a sum can still pass it in its partial sums, as any f32 sum
// can (the FMA kernels too).  The block SpGEMM's B is sparse, so its
// test is the host's, from both cached maxima (types.tf32_products_safe).

#pragma once

#include <cstdint>

namespace tf32 {

// 2 |x|'s bits, less 2, below this: x nonzero and below 2^-112 (bits
// 0x07800000); a zero's wraps to 0xfffffffe
constexpr uint32_t kTiny2 = 2u * 0x07800000u - 2u;

// x rounded to TF32, to nearest with ties away from zero; the low 13 bits
// are zero
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the largest finite TF32 value
constexpr uint32_t kMaxTf32 = 0x7f7fe000u;

// hi = rna(x) clamped to +-kMaxTf32, lo = x - hi, exact; the tensor
// cores read lo truncated to TF32 (see Limits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float m = __uint_as_float(kMaxTf32);
  const float h = fminf(fmaxf(__uint_as_float(rna(x)), -m), m);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// the dense B's test of x (Limits): x nonzero below 2^-112, or |x| not
// at most lim (every infinity and NaN)
__device__ __forceinline__ bool b_fails(float x, float lim) {
  const uint32_t u = __float_as_uint(x) << 1;
  return !(fabsf(x) <= lim) | (u - 2u < kTiny2);
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

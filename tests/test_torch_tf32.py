"""The arithmetic of the tensor-core kernels (``csrc/tf32_mma.cuh``:
``band_spmm_stream``, the f32 ``bsr_spmm`` and the f32 ``bsr_spgemm``),
modelled in torch on the CPU, where no kernel runs.

Each f32 operand splits into two TF32 values, hi = rna(x) and lo =
x - hi truncated to TF32, hi clamped to the largest finite TF32 value (so
an infinity's lo is the infinity); a product takes a_lo*b_hi + a_hi*b_lo
+ a_hi*b_hi (a_hi*b_hi + a_hi*b_lo for bf16 panels).  A tensor-core step sums its eight exact
products into the accumulator with truncation toward zero; the kernels
start every step from zero (corrections first, then hi*hi) and fold the
step into the running sum with an f32 add rounded to nearest.  The model
below does the same, with each step's sums in float64 and the
truncation made explicit, and is held to the port's per-entry tolerance
64 * eps_f32 * (|A| @ |B|) against float64.
"""

import numpy as np
import pytest
import torch

from spblas_tpu_torch import types as _t

EPS = float(torch.finfo(torch.float32).eps)
STEP = 8          # the depth of one m16n8k8 step


def rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero: the kernels' ``tf32::rna``, (bits + 0x1000) &
    0xffffe000."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(bits: torch.Tensor) -> torch.Tensor:
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """The kernels' ``tf32::split``: hi = rna(x) clamped to the largest
    finite TF32 value (a NaN's hi goes to the clamp's bound: f32 min/max
    return the other operand), lo = x - hi truncated to TF32."""
    big = float(_float(torch.tensor(0x7F7FE000)))
    h = rna(x)
    hi = torch.where(torch.isnan(h), torch.full_like(h, -big),
                     h.clamp(-big, big))
    return hi, _float(_bits(x - hi) & 0xFFFFE000)


def trunc32(s: torch.Tensor) -> torch.Tensor:
    """float64 to float32 with truncation toward zero."""
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def step_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(steps, rows, cols) float64: each step's eight products summed."""
    rows, depth = a.shape
    steps = -(-depth // STEP)
    pad = steps * STEP - depth
    a = torch.nn.functional.pad(a.double(), (0, pad)).view(rows, steps, STEP)
    b = torch.nn.functional.pad(b.double(), (0, 0, 0, pad)).view(
        steps, STEP, -1)
    return torch.einsum("rsk,skc->src", a, b)


def model(a: torch.Tensor, b: torch.Tensor, fold: bool = True,
          a_lo: bool = True) -> torch.Tensor:
    """C = A @ B as the kernels compute it (f32 A and B).  ``fold=False``
    models the design the kernels avoid: every product accumulated in the
    mma accumulator, truncated at each mma."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    parts = [step_sums(ahi, blo), step_sums(ahi, bhi)]
    if a_lo:
        parts.insert(0, step_sums(alo, bhi))
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s in range(parts[0].shape[0]):
        if fold:
            t = torch.zeros_like(acc)
            for p in parts:
                t = trunc32(t.double() + p[s])
            acc = acc + t
        else:
            for p in parts:
                acc = trunc32(acc.double() + p[s])
    return acc


def err_over_limit(c, a, b):
    ref = a.double() @ b.double()
    lim = 64 * EPS * (a.double().abs() @ b.double().abs())
    return float(((c.double() - ref).abs() / lim).max())


def operands(rows, depth, cols, positive, seed):
    rng = np.random.default_rng(seed)
    if positive:
        a = rng.uniform(0, 1, (rows, depth))
        b = rng.uniform(0, 100, (depth, cols))
    else:
        a = rng.standard_normal((rows, depth))
        b = rng.standard_normal((depth, cols)) * 100
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


def test_split_hi_is_tf32_and_round_trips():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(200_000)
                          * np.exp2(rng.integers(-100, 100, 200_000))
                          ).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        # at most 10 explicit mantissa bits: the low 13 bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool((x - hi == x.double() - hi.double()).all())   # exact
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -22
    # rounding to nearest, ties away from zero
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0 * 2.0 ** -12])
    assert rna(one).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                                 3.0 * 2.0 ** -12]
    inf = torch.tensor([float("inf"), -float("inf")])
    assert rna(inf).tolist() == inf.tolist()


def test_split_bf16_is_exact():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    xb = x.to(torch.bfloat16).float()
    hi, lo = split(xb)
    assert torch.equal(hi, xb)
    assert int((lo != 0).sum()) == 0


@pytest.mark.parametrize("positive", [True, False], ids=["positive", "mixed"])
@pytest.mark.parametrize("depth", [232, 512])
def test_step_model_within_tolerance(depth, positive):
    """The band's W 232 and four 8x128 blocks (depth 512): all-positive
    data, where truncation's bias adds up, and mixed signs."""
    a, b = operands(256, depth, 16, positive, seed=depth + positive)
    c = model(a, b)
    assert err_over_limit(c, a, b) <= 1.0
    # the split and the per-step truncation cost a few eps, well inside
    assert err_over_limit(c, a, b) <= 0.25


def test_fold_keeps_truncation_off_the_running_sum():
    """Kept in the mma accumulator, the truncations of a long all-positive
    sum add up; folded every step they do not."""
    a, b = operands(256, 512, 16, True, seed=7)
    folded = err_over_limit(model(a, b), a, b)
    unfolded = err_over_limit(model(a, b, fold=False), a, b)
    assert folded < unfolded
    assert unfolded > 0.2


@pytest.mark.parametrize("positive", [True, False], ids=["positive", "mixed"])
def test_bf16_panels_take_two_products(positive):
    """bf16 panels are exact in TF32: a_hi*b_hi + a_hi*b_lo, no a_lo."""
    a, b = operands(256, 232, 16, positive, seed=11 + positive)
    a = a.to(torch.bfloat16).float()
    c = model(a, b, a_lo=False)
    assert torch.equal(model(a, b), c)      # a_lo is zero
    assert err_over_limit(c, a, b) <= 0.25


FLT_MAX = float(torch.finfo(torch.float32).max)


def test_split_saturates_within_half_an_ulp_of_flt_max():
    """rna alone rounds |x| >= 2^128 (1 - 2^-12) up to infinity; the split
    saturates hi to the largest finite TF32 value (0x7f7fe000), so lo =
    x - hi is exact and finite and hi + lo gives x back."""
    top = 2.0 ** 128 * (1 - 2.0 ** -12)
    x = torch.tensor([FLT_MAX, -FLT_MAX, top, -top,
                      float(np.nextafter(np.float32(top), np.float32(0))),
                      1.0, -3.5], dtype=torch.float32)
    assert bool(torch.isinf(rna(x[:4])).all())        # the fault repaired
    hi, lo = split(x)
    assert bool(torch.isfinite(hi).all() and torch.isfinite(lo).all())
    big = _float(torch.tensor(0x7F7FE000))
    assert hi[:4].abs().tolist() == [float(big)] * 4
    assert bool((x - hi == x.double() - hi.double()).all())   # exact
    rel = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -22


def test_split_of_infinity_and_nan():
    """An infinity splits into hi = the largest finite TF32 value of its
    sign and lo = the infinity; a NaN keeps lo a NaN (rounding its bits
    would carry into the sign)."""
    hi, lo = split(torch.tensor([float("inf"), -float("inf"),
                                 float("nan")]))
    big = float(_float(torch.tensor(0x7F7FE000)))
    assert hi[:2].tolist() == [big, -big]
    assert lo[:2].tolist() == [float("inf"), -float("inf")]
    assert bool(torch.isnan(lo[2]))
    canonical = _float(torch.tensor(0x7FFFFFFF)).view(1)   # the GPU's NaN
    assert bool(torch.isnan(split(canonical)[1]).all())
    assert not bool(torch.isnan(rna(canonical)).any())   # the carry


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["max", "neg_max"])
@pytest.mark.parametrize("a_side", [True, False], ids=["in_a", "in_b"])
def test_flt_max_operand_gives_the_finite_product(sign, a_side):
    """An operand at +-FLT_MAX in every row of A (or column of B), against
    factors below 1/2: the f32 product is finite, and so is the split
    product, within 64 eps (|A| @ |B|)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0, 0.5, (64, 232)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0, 0.5, (232, 16)).astype(np.float32))
    if a_side:
        a[torch.arange(64), torch.arange(64) * 3] = sign * FLT_MAX
    else:
        b[torch.arange(16) * 7, torch.arange(16)] = sign * FLT_MAX
    ref = a.double() @ b.double()
    assert bool(torch.isfinite(ref).all()) and float(ref.abs().max()) < FLT_MAX
    c = model(a, b)
    assert bool(torch.isfinite(c).all())
    assert err_over_limit(c, a, b) <= 0.25


def test_infinities_propagate_as_the_f32_product():
    """Infinite operands give the f32 product's infinities (with its signs)
    and its NaNs (an infinity times 0, opposite infinities), and nothing
    else becomes infinite or NaN; bf16 panels (not split) with an
    infinity fail the entry points' gate instead."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(-1, 1, (48, 24)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (24, 8)).astype(np.float32))
    a[::5, 3] = float("inf")
    a[2::7, 11] = -float("inf")
    b[3, ::3] = 0.0
    b[11, 1] = 0.0
    b[17, 5] = -float("inf")
    ref = a.double() @ b.double()
    c = model(a, b).double()
    assert torch.equal(torch.isnan(c), torch.isnan(ref))
    assert torch.equal(torch.isinf(c), torch.isinf(ref))
    inf = torch.isinf(ref)
    assert inf.any() and torch.isnan(ref).any()
    assert torch.equal(torch.sign(c[inf]), torch.sign(ref[inf]))
    assert not _t.tf32_exact(a) and not _t.tf32_exact(a.to(torch.bfloat16))


def test_block_spgemm_depth_needs_the_fold():
    """A C block of bsr_spgemm sums 16 pairs of 128-deep products: 2,048
    deep.  Folded every step the all-positive sum stays well inside the
    limit; kept in the mma accumulator it passes the limit."""
    a, b = operands(64, 16 * 128, 16, True, seed=13)
    assert err_over_limit(model(a, b), a, b) <= 0.25
    assert err_over_limit(model(a, b, fold=False), a, b) > 1.0


@pytest.mark.parametrize("depth", [128, 232])
def test_low_end_scaled_operands_need_the_gate(depth):
    """A scaled by 2^-120 against B scaled by 2^120: the lo parts fall
    below 2^-126, TF32 subnormals, which the tensor cores keep (measured
    on the card) on TF32's subnormal grid of 2^-136.  An operand then keeps
    about 17 bits: the split product comes near the limit (the card's
    streamed band kernel missed it on one row of 16,384), so
    ``types.tf32_exact`` flags such an operand and the entry points route
    it to an exact kernel."""
    a, b = operands(256, depth, 16, True, seed=depth)
    a = a * 2.0 ** -120
    b = b / 128 * 2.0 ** 120
    assert float(a[a > 0].abs().min()) < 2.0 ** -126   # subnormal lo parts
    assert err_over_limit(model(a, b), a, b) > 0.25
    assert not _t.tf32_exact(a) and _t.tf32_exact(b)
    # at 2^-80 the same operands keep f32 accuracy, and pass the gate
    a2 = a * 2.0 ** 40
    assert _t.tf32_exact(a2) and err_over_limit(model(a2, b), a2, b) < 0.25


def test_tf32_exact_flags_only_tiny_nonzeros():
    """The gate's test: a nonzero f32 (or complex64 part) below 2^-112 in
    magnitude, or an infinity or a NaN (bf16 too, which is not split);
    zeros, 2^-112 itself, finite bf16 and f64 values pass."""
    x = torch.tensor([0.0, -0.0, 1.0, 2.0 ** -112, -3.0], dtype=torch.float32)
    assert _t.tf32_exact(x)
    for bad in (float("inf"), -float("inf"), float("nan")):
        assert not _t.tf32_exact(torch.cat([x, torch.tensor([bad])]))
        assert not _t.tf32_exact(torch.tensor([bad]).to(torch.bfloat16))
    assert not _t.tf32_exact(torch.cat([x, torch.tensor([-2.0 ** -113])]))
    assert not _t.tf32_exact(torch.tensor([1.0 + 2.0 ** -120 * 1j],
                                          dtype=torch.complex64))
    assert _t.tf32_exact(torch.tensor([2.0 ** -130], dtype=torch.float64))
    assert _t.tf32_exact(torch.tensor([2.0 ** -120]).to(torch.bfloat16))


@pytest.mark.parametrize("values, want", [
    ([1.0, -2.0 ** -112, 3.0], True),
    ([1.0, -2.0 ** -113, 3.0], False),
    ([1.0, 2.0 ** -140, 3.0], False),
    ([1.0, float("inf"), 3.0], False),
    ([1.0, float("nan"), 0.0], False),
    ([0.0, 0.0], True),
    ([0.0, 2.0 ** -120], False),
    ([0.0, -2.0 ** -149, 5.0], False),
    ([0.0, -2.0 ** -112, 2.0 ** -112], True),
    ([torch.finfo(torch.float32).max, -1.0], True)])
def test_tf32_exact_layouts(values, want):
    """The gate's answer at the edges of its range (2^-112 itself passes,
    anything nonzero below it fails, FLT_MAX passes, an infinity or a NaN
    fails, zeros pass), the same for every layout: f32, complex64 with
    the value in either part, and a strided view."""
    x = torch.tensor(values, dtype=torch.float32)
    assert _t.tf32_exact(x) is want
    assert _t.tf32_exact(torch.complex(x, torch.ones_like(x))) is want
    assert _t.tf32_exact(torch.complex(torch.ones_like(x), x)) is want
    assert _t.tf32_exact(torch.stack([x, x], 1)[:, 0]) is want

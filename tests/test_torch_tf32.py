"""The arithmetic of the tensor-core SpMM kernels (``csrc/tf32_mma.cuh``:
``band_spmm_stream`` and the f32 ``bsr_spmm``), modelled in torch on the
CPU, where no kernel runs.

Each f32 operand splits into two TF32 values, hi = rna(x) and lo =
rna(x - hi); a product takes a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (a_hi*b_hi
+ a_hi*b_lo for bf16 panels).  A tensor-core step sums its eight exact
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


def split(x: torch.Tensor):
    hi = rna(x)
    return hi, rna(x - hi)


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

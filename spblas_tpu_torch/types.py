"""Global type configuration and device resolution for spblas_tpu_torch.

Counterpart of ``spblas_tpu/types.py``: int32 indices and offsets (the
vendor backends of the reference narrow to 32 bits too), the ``Config``
knobs and ``quantize_capacity``.  PyTorch keeps float64 as it is, so the
port behaves as the JAX package does under ``jax_enable_x64`` and has no
narrowing guard.

Device rule: entry points place tensors on ``cuda`` unless the caller
names another device; with no card and no device named they raise.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# int32 everywhere — watch 2^31 nnz limits on very large matrices.
index_dtype = torch.int32
offset_dtype = torch.int32

real_dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class Config:
    """Runtime knobs.  The JAX package's TPU tiling fields (row block,
    lane, MXU tile) come back when a CUDA kernel reads them."""

    # quantize capacities to powers of two (bounded set of shapes)
    capacity_quantum: bool = True


DEFAULT_CONFIG = Config()


def quantize_capacity(nnz: int, cfg: Config = DEFAULT_CONFIG) -> int:
    """Round a requested capacity up to a power-of-two bucket."""
    nnz = int(nnz)
    if nnz <= 0:
        return 1
    if not cfg.capacity_quantum:
        return nnz
    return 1 << (nnz - 1).bit_length()


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device — the probe behind plan
    selection and every kernel wrapper's launch-or-plain decision."""
    return t.device.type == "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its tensors on: ``device`` when
    given, else ``cuda``.  Raises when no device was named and there is
    no card: the port never carries on on the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "spblas_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


def as_tensor(arr, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device``.  A numpy array is
    copied (the tensor never aliases the caller's array), and ml_dtypes
    bfloat16 arrays, as the JAX package hands them over, keep their
    bits."""
    if not isinstance(arr, torch.Tensor):
        arr = np.array(arr, order="C", copy=True)
        if arr.dtype.name == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            arr = torch.from_numpy(arr)
    return arr.to(device=device, dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy for the numpy inspectors (bfloat16 widens to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.resolve_conj().numpy()


# the least magnitude of a nonzero f32 operand whose 3xTF32 split keeps
# f32 accuracy: the split's lo part lies on TF32's subnormal grid of
# 2^-136 (measured on the card, csrc/tf32_mma.cuh), so below 2^-112 an
# operand keeps fewer bits than f32
TF32_TINY = 2.0 ** -112


def tf32_gate(values: torch.Tensor):
    """(exact, amax) of an operand of the 3xTF32 kernels, from one pass
    and one host read.  ``exact`` is True when every entry of an f32 (or
    complex64) ``values`` is finite and none that is nonzero lies below
    :data:`TF32_TINY` in magnitude: then the kernels keep f32 accuracy on
    it and propagate its infinities and NaNs as the f32 product does
    (``csrc/tf32_mma.cuh``, Limits); bf16 values must be finite (a bf16
    panel is not split); f64 is never split: True.  ``amax`` is the
    largest magnitude of a finite operand (of its real and imaginary
    parts), the bound :func:`tf32_b_limit` sets the dense B's test from
    (f64: 0.0, unused).  Callers keep both with the operand
    (``BSR.tf32_exact``, ``BandPlan.tf32_exact`` and their ``tf32_amax``)."""
    if values.dtype not in (torch.float32, torch.complex64, torch.bfloat16):
        return True, 0.0
    v = torch.view_as_real(values) if values.is_complex() else values
    mag = v.abs().float()
    if mag.numel() == 0:
        return True, 0.0
    bad = ~torch.isfinite(mag)
    if values.dtype != torch.bfloat16:
        bad |= (mag > 0) & (mag < TF32_TINY)
    flag, amax = torch.stack([bad.any().float(), mag.max()]).tolist()
    return not flag, float(amax)


def tf32_b_limit(amax: float) -> float:
    """The largest |b| of a dense B value that the 3xTF32 kernels take
    against a sparse operand whose largest magnitude is ``amax``: no
    product of the split (a_hi b_hi, a_hi b_lo, a_lo b_hi) can then pass
    FLT_MAX.  |x_hi| <= |x| (1 + 2^-11) and |x_lo| <= 2^-11 |x|, so every
    product is below |a| |b| (1 + 2^-9): the limit is FLT_MAX / (amax (1
    + 2^-9)), rounded down to f32 (FLT_MAX for amax 0), which every
    infinity and NaN fails.  ``csrc/tf32_mma.cuh``, Limits, states the
    rule the kernels apply."""
    fmax = float(np.finfo(np.float32).max)
    lim = fmax if amax <= 0 else min(
        fmax, fmax / (float(amax) * (1.0 + 2.0 ** -9)))
    f = np.float32(lim)
    if float(f) > lim:
        f = np.nextafter(f, np.float32(0))
    return float(f)


def tf32_products_safe(amax_a: float, amax_b: float) -> bool:
    """True when no product of the 3xTF32 split of two sparse operands
    with these largest magnitudes can pass FLT_MAX: the block SpGEMM's
    host form of the dense B's test (:func:`tf32_b_limit`)."""
    return amax_b <= tf32_b_limit(amax_a)


def wide_matmul(fn, *ts) -> torch.Tensor:
    """``fn(*ts)`` (a matmul, bmm or einsum) computed in float64 (complex128
    for complex operands) and cast back to the operands' result type.  A
    float32 product on CUDA follows the caller's TF32 setting
    (``torch.backends.cuda.matmul``), which keeps about three decimal
    digits; the JAX package's dots run at ``Precision.HIGHEST``, and a
    float64 product reaches no such setting.  Non-float operands run as
    they are."""
    out = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    if not (out.is_floating_point or out.is_complex):
        return fn(*ts)
    wide = torch.complex128 if out.is_complex else torch.float64
    return fn(*(t.to(wide) for t in ts)).to(out)

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


def tf32_exact(values: torch.Tensor) -> bool:
    """True when every entry of an f32 (or complex64) ``values`` is finite
    and none that is nonzero lies below :data:`TF32_TINY` in magnitude:
    then the 3xTF32 tensor-core kernels keep f32 accuracy on it and
    propagate its infinities and NaNs as the f32 product does
    (``csrc/tf32_mma.cuh``, Limits).  bf16 values must also be finite (a
    bf16 panel is not split); f64 is never split: True.  One pass over
    ``values`` and one host read; callers keep the answer with the
    operand (``BSR.tf32_exact``, ``BandPlan.tf32_exact``)."""
    if values.dtype == torch.bfloat16:
        return bool(torch.isfinite(values).all())
    if values.dtype not in (torch.float32, torch.complex64):
        return True
    v = torch.view_as_real(values) if values.is_complex() else values
    mag = v.abs()
    return not bool((((mag > 0) & (mag < TF32_TINY))
                     | ~torch.isfinite(mag)).any())


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

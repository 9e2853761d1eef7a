"""DIA (diagonal) SpMV — counterpart of ``spblas_tpu/kernels/dia.py``.

Storing the populated diagonals densely removes all index traffic:
y[i] = sum_k diags[k, i] * x[i + offsets[k]].  ``dia_spmv`` keeps the JAX
gate, with the card in place of the TPU: on CUDA, f32 diagonals, f32 or
bf16 x, at most 32 diagonals and the 2.5M extent run the fused kernel
``csrc/dia_spmv.cu``, which replaces the TPU kernel
``dia.py::_dia_kernel``.  Everything else runs the shift-multiply-
accumulate chain as torch ops.  The gated path :func:`dia_spmv_fused`
calls :func:`dia_spmv_inplace`, which reads x in place (zeros outside
it) and writes m rows; :func:`dia_spmv_padded` runs the same sum over
the TPU kernel's padded x pane (:func:`pad_x`) into every padded row,
with the same bits.  Each wrapper takes its plain version
(:func:`dia_spmv_inplace_reference`, :func:`dia_spmv_reference`) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR, host_arrays

_DIA_RB_MAX = 256     # build-time diagonal padding unit (rows of 128)
_LANES = 128
# The 2.5M extent is the TPU kernel's VMEM envelope for its resident x
# pane, kept for parity; re-deriving it for the H100 is ROADMAP Queue 1
# item 18.
_KERNEL_EXTENT = 2_500_000
_KERNEL_MAX_DIAGS = 32


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Diagonals stored dense: diags[k, i] = A[i, i + offsets[k]], kept in
    the (ndiag, rows_pad, 128) layout of the JAX plan (m padded to a
    multiple of 256*128)."""

    diags: torch.Tensor       # (ndiag, rows_pad, 128)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def ndiag(self) -> int:
        return int(self.diags.shape[0])

    def diags_flat(self) -> torch.Tensor:
        """(ndiag, m) view for the shift-mul-accumulate chain."""
        return self.diags.reshape(self.ndiag, -1)[:, : self.shape[0]]

    @functools.cached_property
    def offsets_tensor(self) -> torch.Tensor:
        """The offsets as int32 on the diagonals' device (made once)."""
        return torch.tensor(self.offsets, dtype=torch.int32,
                            device=self.diags.device)

    @functools.cached_property
    def offsets_host(self):
        """The offsets as a host int32 array for the in-place kernel,
        which takes them by value (made once)."""
        return (ctypes.c_int * self.ndiag)(*self.offsets)


def dia_fill_fraction(a: CSR) -> float:
    """Fraction of DIA storage that would hold true nonzeros — the plan
    chooser's banded-ness test."""
    m, _ = a.shape
    if a.nnz == 0:
        return 0.0
    rows, cols, _ = host_arrays(a)
    offs = np.unique(cols.astype(np.int64) - rows)
    return a.nnz / float(len(offs) * m)


def build_dia_plan(a: CSR) -> DiaPlan:
    m, n = a.shape
    rows, cols, values = host_arrays(a)
    offs_arr = cols.astype(np.int64) - rows
    offsets = np.unique(offs_arr)
    rows_pad = -(-m // (_DIA_RB_MAX * _LANES)) * _DIA_RB_MAX
    diags = np.zeros((len(offsets), rows_pad * _LANES), dtype=values.dtype)
    diags[np.searchsorted(offsets, offs_arr), rows] = values
    return DiaPlan(
        diags=torch.from_numpy(diags.reshape(len(offsets), rows_pad,
                                             _LANES)).to(a.device),
        offsets=tuple(int(o) for o in offsets), shape=(m, n))


def _kernel_gate(plan: DiaPlan, x: torch.Tensor) -> bool:
    m, n = plan.shape
    return (_t.on_cuda(x) and 0 < plan.ndiag <= _KERNEL_MAX_DIAGS
            and plan.diags.dtype == torch.float32
            and x.dtype in (torch.float32, torch.bfloat16)
            # the x pane's extent is set by the padded operand (n for
            # wide rectangles), not just m
            and (max(m, n) + abs(min(plan.offsets))
                 + abs(max(plan.offsets))) <= _KERNEL_EXTENT)


def dia_spmv(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k diags[k, i] * x[i + offsets[k]].

    diags[k, i] is 0 wherever i + off falls outside the matrix, so
    padding contributes nothing."""
    m, n = plan.shape
    if _kernel_gate(plan, x):
        return dia_spmv_fused(plan, x)
    pad_lo = max(-min(plan.offsets, default=0), 0)
    pad_hi = max(max(plan.offsets, default=0) + m - n, 0)
    xp = F.pad(x, (pad_lo, pad_hi))
    d = plan.diags_flat()
    y = torch.zeros(m, dtype=torch.promote_types(d.dtype, x.dtype),
                    device=x.device)
    for k, off in enumerate(plan.offsets):
        y = y + d[k] * xp[pad_lo + off: pad_lo + off + m]
    return y


def dia_spmm(plan: DiaPlan, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B over the diagonals, as torch ops (the JAX ``dia_spmm`` is
    XLA code, with no TPU kernel): C += diags[k][:, None] * B shifted by
    offsets[k], for every diagonal."""
    m, n = plan.shape
    pad_lo = max(-min(plan.offsets, default=0), 0)
    pad_hi = max(max(plan.offsets, default=0) + m - n, 0)
    bp = F.pad(b, (0, 0, pad_lo, pad_hi))
    d = plan.diags_flat()
    c = torch.zeros(m, b.shape[1], dtype=torch.promote_types(d.dtype, b.dtype),
                    device=b.device)
    for k, off in enumerate(plan.offsets):
        c = c + d[k][:, None] * bp[pad_lo + off: pad_lo + off + m]
    return c


def _dia_rb(ndiag: int) -> int:
    """The TPU kernel's block height; it sets the x padding below, which
    the port keeps so both packages pad x alike."""
    for rb in (256, 128, 64):
        if ndiag * rb * _LANES * 4 <= 2 * 1024 * 1024:
            return rb
    return 64


def pad_x(plan: DiaPlan, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x as the fused kernel reads it: f32, pad_lo zeros in front and
    enough zeros behind that the furthest shifted read of the last row
    stays in bounds (the JAX padding of ``_dia_spmv_pallas``); returns
    (flat x2, pad_lo)."""
    n = plan.shape[1]
    pad_lo = max(-min(plan.offsets), 0)
    rows_out = int(plan.diags.shape[1])
    max_q = max((off + pad_lo) // _LANES for off in plan.offsets)
    x_rows = max(rows_out + max_q + _dia_rb(plan.ndiag) + 8,
                 -(-(pad_lo + n) // _LANES))
    x2 = F.pad(x.float(), (pad_lo, x_rows * _LANES - pad_lo - n))
    return x2.contiguous(), pad_lo


def dia_spmv_reference(diags: torch.Tensor, offsets, x2: torch.Tensor,
                       pad_lo: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the same sum over the padded
    layout: y[i] = sum_k diags[k, i] * x2[i + pad_lo + offsets[k]] for
    every i < rows_pad * 128, in f32, in the kernel's order over k."""
    d = diags.reshape(diags.shape[0], -1)
    total = d.shape[1]
    y = torch.zeros(total, dtype=torch.float32, device=d.device)
    for k, off in enumerate(offsets):
        y = y + d[k] * x2[pad_lo + off: pad_lo + off + total]
    return y


def _check_operands(diags, offsets_t, x2, pad_lo) -> None:
    if not (diags.device == offsets_t.device == x2.device):
        raise ValueError("diags, offsets and x2 must share a device")
    if diags.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError(f"diags and x2 must be float32, got {diags.dtype}"
                        f" and {x2.dtype}")
    if offsets_t.dtype != torch.int32 or offsets_t.dim() != 1 \
            or offsets_t.shape[0] != diags.shape[0]:
        raise ValueError("offsets must be int32 with one entry per diagonal")
    if diags.dim() != 3 or diags.shape[2] != _LANES or x2.dim() != 1:
        raise ValueError(f"bad shapes: diags {tuple(diags.shape)}, "
                         f"x2 {tuple(x2.shape)}")
    if not (diags.is_contiguous() and x2.is_contiguous()
            and offsets_t.is_contiguous()):
        raise ValueError("diags, offsets and x2 must be contiguous")


# (diags, offsets, ndiag, x2, y, total, pad_lo, stream) of dia_spmv_f32
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p)


def dia_spmv_padded(plan: DiaPlan, x2: torch.Tensor,
                    pad_lo: int) -> torch.Tensor:
    """The fused sweep over padded x2 (from :func:`pad_x`); returns the
    (rows_pad * 128,) f32 result.  CUDA tensors launch ``dia_spmv.cu``;
    CPU tensors take :func:`dia_spmv_reference`."""
    diags, offsets_t = plan.diags, plan.offsets_tensor
    _check_operands(diags, offsets_t, x2, pad_lo)
    total = diags.shape[1] * _LANES
    lo, hi = min(plan.offsets), max(plan.offsets)
    if pad_lo + lo < 0 or x2.shape[0] < total + pad_lo + hi:
        raise ValueError("x2 does not cover every shifted read")
    if not _t.on_cuda(diags):
        return dia_spmv_reference(diags, plan.offsets, x2, pad_lo)
    y = torch.empty(total, dtype=torch.float32, device=diags.device)
    stream = torch.cuda.current_stream(diags.device).cuda_stream
    _build.check(_build.function("dia_spmv", "dia_spmv_f32", _ARGTYPES)(
        diags.data_ptr(), offsets_t.data_ptr(), plan.ndiag, x2.data_ptr(),
        y.data_ptr(), total, pad_lo, stream), "dia_spmv")
    dia_spmv_padded.launches += 1
    return y


dia_spmv_padded.launches = 0


def dia_spmv_inplace_reference(plan: DiaPlan,
                               x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the in-place kernel: y[i] = sum_k
    diags[k, i] * x[i + offsets[k]] for every i < m, x read as f32 and as
    0 outside [0, n), in f32, in the kernel's order over k; (m,) f32."""
    m, n = plan.shape
    d = plan.diags.reshape(plan.ndiag, -1)
    xf = x.float()
    rows = torch.arange(m, device=x.device)
    y = torch.zeros(m, dtype=torch.float32, device=x.device)
    for k, off in enumerate(plan.offsets):
        j = rows + off
        inside = (j >= 0) & (j < n)
        y = y + d[k, :m] * torch.where(inside, xf[j.clamp(0, max(n - 1, 0))],
                                       0.0)
    return y


def _check_inplace(plan: DiaPlan, x: torch.Tensor) -> None:
    diags = plan.diags
    m, n = plan.shape
    if diags.device != x.device:
        raise ValueError(f"diags on {diags.device}, x on {x.device}")
    if diags.dtype != torch.float32 \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"diags must be float32 and x float32 or bfloat16, "
                        f"got {diags.dtype} and {x.dtype}")
    if diags.dim() != 3 or diags.shape[2] != _LANES \
            or diags.shape[1] * _LANES < m or x.shape != (n,) \
            or not 0 < plan.ndiag <= _KERNEL_MAX_DIAGS \
            or len(plan.offsets) != plan.ndiag:
        raise ValueError(f"bad shapes: diags {tuple(diags.shape)} with "
                         f"{len(plan.offsets)} offsets for {plan.shape}, "
                         f"x {tuple(x.shape)}")
    if not (diags.is_contiguous() and x.is_contiguous()):
        raise ValueError("diags and x must be contiguous")


# (diags, offsets, ndiag, x, y, m, n, total, stream) of
# dia_spmv_inplace_f32 and _bf16x (offsets: a host int32 array)
_INPLACE_ARGTYPES = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_void_p)


def dia_spmv_inplace(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """The fused sweep with x read in place (f32 or bf16, zeros outside
    it); returns the (m,) f32 result.  CUDA tensors launch
    ``dia_spmv.cu``'s in-place kernel (counted on
    ``dia_spmv_padded.launches``), with the bits of
    :func:`dia_spmv_padded`; CPU tensors take
    :func:`dia_spmv_inplace_reference`."""
    _check_inplace(plan, x)
    if not _t.on_cuda(x):
        return dia_spmv_inplace_reference(plan, x)
    m, n = plan.shape
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    name = ("dia_spmv_inplace_f32" if x.dtype == torch.float32
            else "dia_spmv_inplace_bf16x")
    _build.check(_build.function("dia_spmv", name, _INPLACE_ARGTYPES)(
        plan.diags.data_ptr(), plan.offsets_host, plan.ndiag, x.data_ptr(),
        y.data_ptr(), m, n, plan.diags.shape[1] * _LANES,
        torch.cuda.current_stream(x.device).cuda_stream), "dia_spmv")
    if m:
        dia_spmv_padded.launches += 1
    return y


def dia_spmv_fused(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """The gated fused path of :func:`dia_spmv` (the JAX
    ``_dia_spmv_pallas``): one sweep with x read in place, m rows in x's
    dtype."""
    return dia_spmv_inplace(plan, x.contiguous()).to(x.dtype)

"""Banded-panel SpMV — counterpart of ``spblas_tpu/kernels/banded.py``.

128-row blocks of a band with half-width h touch only the columns
[i*128 - h, i*128 + 127 + h], so each block is a dense (128, W) panel and
SpMV becomes a stream of panel-row dot products with no index loads.

On a CUDA tensor :func:`band_spmv_padded` launches the hand-written
kernel ``csrc/band_spmv.cu`` (which replaces the TPU kernel
``banded.py::_spmv_kernel``); on a CPU tensor it runs
:func:`band_spmv_reference`, the plain PyTorch version of the same sum.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR, host_arrays

_R = 128  # rows per panel
_G = 8    # panel count granule: nblk is padded to a multiple of 8


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """panels (nblk * 128, W): row-block i's dense band window;
    pad_l: left extent such that panel column c maps to global column
    i*128 + c - pad_l."""

    panels: torch.Tensor
    pad_l: int
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return int(self.panels.shape[1])

    @property
    def nblocks(self) -> int:
        return int(self.panels.shape[0]) // _R


def band_halfwidth(a: CSR) -> int:
    """Max |col - row| over live entries (host-side, numpy only)."""
    if a.nnz == 0:
        return 0
    rows, cols, _ = host_arrays(a)
    return int(np.abs(cols - rows).max())


def build_band_plan(a: CSR, dtype=None) -> BandPlan:
    """Host inspect: re-lay the band into dense 128-row panels, on the
    matrix's device.  nblk is padded to a multiple of 8 and W to a
    multiple of 8, as in the JAX plan.  ``dtype`` overrides the panel
    storage (``torch.bfloat16`` halves the streamed bytes; the kernel
    accumulates in f32)."""
    m, n = a.shape
    h = band_halfwidth(a)
    pad_l = h
    w = -(-(_R + 2 * pad_l) // 8) * 8
    nblk = -(-m // _R)
    nblk = -(-nblk // _G) * _G
    rows, cols, vals = host_arrays(a)
    panels = np.zeros((nblk * _R, w), dtype=vals.dtype)
    # panel-local column: global col - (block_start - pad_l)
    c_loc = cols - (rows // _R) * _R + pad_l
    if not ((c_loc >= 0) & (c_loc < w)).all():
        raise ValueError("entry outside declared band window")
    panels[rows, c_loc] = vals
    panels_t = torch.from_numpy(panels)
    if dtype is not None:
        # convert on the host so the upload moves the narrow type
        panels_t = panels_t.to(dtype)
    return BandPlan(panels=panels_t.to(a.device), pad_l=pad_l, shape=(m, n))


def band_spmv_reference(panels: torch.Tensor,
                        xp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: y[r] = sum_c panels[r, c] *
    xp[(r // 128) * 128 + c], in f32; returns (nblk * 128,) f32."""
    nblk = panels.shape[0] // _R
    w = panels.shape[1]
    windows = xp.float()[: (nblk - 1) * _R + w].unfold(0, w, _R)
    prod = panels.float().view(nblk, _R, w) * windows[:, None, :]
    return prod.sum(dim=2).reshape(nblk * _R)


def _check_operands(panels: torch.Tensor, xp: torch.Tensor) -> None:
    if panels.device != xp.device:
        raise ValueError(f"panels on {panels.device}, xp on {xp.device}")
    if panels.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"panels must be float32 or bfloat16, got "
                        f"{panels.dtype}")
    if xp.dtype != torch.float32:
        raise TypeError(f"xp must be float32, got {xp.dtype}")
    if panels.dim() != 2 or panels.shape[0] % _R or xp.dim() != 1:
        raise ValueError(f"bad shapes: panels {tuple(panels.shape)}, "
                         f"xp {tuple(xp.shape)}")
    if xp.shape[0] < panels.shape[0] - _R + panels.shape[1]:
        raise ValueError(f"xp length {xp.shape[0]} < "
                         f"{panels.shape[0] - _R + panels.shape[1]}")
    if not (panels.is_contiguous() and xp.is_contiguous()):
        raise ValueError("panels and xp must be contiguous")


# (panels, xp, y, rows, w, stream) of band_spmv_{f32,bf16}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def band_spmv_padded(panels: torch.Tensor,
                     xp: torch.Tensor) -> torch.Tensor:
    """Core panel sweep over pre-padded f32 x (len >= nblk*128 + W - 128);
    returns (nblk * 128,) f32.  CUDA tensors launch ``band_spmv.cu``;
    CPU tensors take :func:`band_spmv_reference`."""
    _check_operands(panels, xp)
    if not _t.on_cuda(panels):
        return band_spmv_reference(panels, xp)
    rows, w = panels.shape
    y = torch.empty(rows, dtype=torch.float32, device=panels.device)
    stream = torch.cuda.current_stream(panels.device).cuda_stream
    symbol = ("band_spmv_bf16" if panels.dtype == torch.bfloat16
              else "band_spmv_f32")
    _build.check(_build.function("band_spmv", symbol, _ARGTYPES)(
        panels.data_ptr(), xp.data_ptr(), y.data_ptr(), rows, w, stream),
        "band_spmv")
    band_spmv_padded.launches += 1
    return y


band_spmv_padded.launches = 0


def pad_x(plan: BandPlan, x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: f32, shifted right by pad_l, then padded
    or trimmed to L = nblk*128 - 128 + W so that every window
    [i*128, i*128 + W) is in bounds (the JAX padding of ``band_spmv``;
    for wide matrices the trimmed tail columns hold no band entries)."""
    n = plan.shape[1]
    L = plan.nblocks * _R - _R + plan.width
    xp = F.pad(x, (plan.pad_l, max(0, L - plan.pad_l - n)))[:L]
    return xp.float().contiguous()


def band_spmv(plan: BandPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the panel layout."""
    y = band_spmv_padded(plan.panels, pad_x(plan, x))
    return y[: plan.shape[0]].to(
        torch.promote_types(plan.panels.dtype, x.dtype))

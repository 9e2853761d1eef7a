"""Banded-panel SpMV and SpMM — counterpart of
``spblas_tpu/kernels/banded.py``.

128-row blocks of a band with half-width h touch only the columns
[i*128 - h, i*128 + 127 + h], so each block is a dense (128, W) panel:
SpMV becomes a stream of panel-row dot products with no index loads,
SpMM one dense (128, W) x (W, k) product per block.

On a CUDA tensor the wrappers launch hand-written kernels, and on a CPU
tensor they run the plain PyTorch version of the same sum:

  band_spmv_padded         csrc/band_spmv.cu   (replaces banded.py::
                                                _spmv_kernel)
  band_spmm_padded,        csrc/band_spmm.cu   (replaces _spmm_kernel)
  band_spmm_inplace        (resident)
  band_spmm_cx             csrc/band_spmm.cu,  (the complex band's four
                           complex entry point  _spmm_kernel products)
  band_spmm_stream_padded, csrc/band_spmm.cu,  (replaces
  band_spmm_stream_inplace stream entry point   _spmm_stream_kernel)
  band_power_padded        csrc/band_power.cu  (replaces _power_kernel)

The SpMM kernels read B where it lies (``*_inplace``, ``band_spmm_cx``):
the plan entry points make no padded copy of B (:func:`pad_b` is the
``*_padded`` forms' operand).

:func:`band_plan_from_diags` lays a band out from DIA storage on the
diagonals' own device (torch ops, no host traffic), the device-side plan
builder of the bench's headline band.

:class:`PermutedBandPlan` is the RCM-reordered band of a general square
matrix (kind ``band_perm``).  Its SpMV permutes x and y by
``index_select`` by ``perm`` and ``rank`` (the JAX package sorts by key,
since the TPU has no fast gather; both are exact); its SpMM hands
``perm`` to the resident kernel, which gathers B's rows and scatters C's
as it reads and writes them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spblas_tpu_torch import _build, native
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

    @functools.cached_property
    def tf32_gate(self):
        """:func:`types.tf32_gate` of the panels, (exact, amax), made on
        first use and kept."""
        return _t.tf32_gate(self.panels)

    @property
    def tf32_exact(self) -> bool:
        """False sends :func:`band_spmm_stream` to the FMA kernel."""
        return self.tf32_gate[0]

    @property
    def tf32_amax(self) -> float:
        """The panels' largest magnitude: the tensor-core kernel's test
        of B is set from it (``types.tf32_b_limit``)."""
        return self.tf32_gate[1]


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


def _check_operands(panels: torch.Tensor, xp: torch.Tensor,
                    ndim: int = 1) -> None:
    """The checks of every panel kernel: ``xp`` is the padded x (1-D, for
    SpMV) or the padded B (2-D, for SpMM)."""
    name = "xp" if ndim == 1 else "bp"
    if panels.device != xp.device:
        raise ValueError(f"panels on {panels.device}, {name} on {xp.device}")
    if panels.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"panels must be float32 or bfloat16, got "
                        f"{panels.dtype}")
    if xp.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {xp.dtype}")
    if (panels.dim() != 2 or panels.shape[0] % _R
            or xp.dim() != ndim):
        raise ValueError(f"bad shapes: panels {tuple(panels.shape)}, "
                         f"{name} {tuple(xp.shape)}")
    if xp.shape[0] < panels.shape[0] - _R + panels.shape[1]:
        raise ValueError(f"{name} rows {xp.shape[0]} < "
                         f"{panels.shape[0] - _R + panels.shape[1]}")
    if not (panels.is_contiguous() and xp.is_contiguous()):
        raise ValueError(f"panels and {name} must be contiguous")


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


class _BandSpmvAD(torch.autograd.Function):
    """:func:`band_spmv` with JAX's custom VJP (``banded.py``,
    ``_band_spmv_bwd``): the forward is the band kernel (its plain
    version on the CPU); the backward is tensor ops, as XLA code is in
    the JAX package."""

    @staticmethod
    def forward(ctx, panels, x, pad_l, shape):
        ctx.save_for_backward(panels, x)
        ctx.geo = (pad_l, shape)
        return band_spmv(BandPlan(panels=panels, pad_l=pad_l, shape=shape),
                         x)

    @staticmethod
    def backward(ctx, dy):
        panels, x = ctx.saved_tensors
        h, (m, n) = ctx.geo
        w = panels.shape[1]
        nblk = panels.shape[0] // _R
        dyp = F.pad(dy.float(), (0, nblk * _R - dy.shape[0]))
        dpanels = dx = None
        if ctx.needs_input_grad[1]:
            # dx: panel entry (g, c) consumed xp[(g // 128) * 128 + c], so
            # its cotangent goes back there: the overlap-add of per-block
            # column sums at stride 128
            t = panels.float() * dyp[:, None]
            blocksum = t.view(nblk, _R, w).sum(dim=1)
            chunks = -(-w // _R)
            bs = F.pad(blocksum, (0, chunks * _R - w))
            acc = torch.zeros((nblk + chunks) * _R, dtype=torch.float32,
                              device=dy.device)
            for k in range(chunks):
                acc[k * _R:(k + nblk) * _R] += \
                    bs[:, k * _R:(k + 1) * _R].reshape(-1)
            dx = acc[h:h + n].to(x.dtype)
        if ctx.needs_input_grad[0]:
            # dpanels[g, c] = dy[g] * xp[(g // 128) * 128 + c]
            lx = nblk * _R - _R + w
            xp = F.pad(x.float(), (h, max(0, lx - h - n)))[:lx]
            win = xp.unfold(0, w, _R)                       # (nblk, w)
            dpanels = (dyp.view(nblk, _R, 1) * win[:, None, :]).reshape(
                nblk * _R, w).to(panels.dtype)
        return dpanels, dx, None, None


def band_spmv_ad(plan: BandPlan, x: torch.Tensor) -> torch.Tensor:
    """Differentiable band SpMV (square matrices): the forward is the
    panel kernel; the backward gives dx = A^T dy by the overlap-add of
    the panels' column sums and d(panels) as the window outer products,
    cast to the panels' dtype.  Gradients reach ``plan.panels`` where it
    requires grad, and ``x``."""
    return _BandSpmvAD.apply(plan.panels, x, plan.pad_l, plan.shape)


def band_plan_from_diags(diags: torch.Tensor, offsets, shape,
                         dtype=None) -> BandPlan:
    """Plan from DIA storage, built on the diagonals' device with no host
    traffic: ``diags[k, i] = A[i, i + offsets[k]]`` (0 where out of
    range), offsets distinct.  Panel row r of block b holds diagonal k at
    column ``r % 128 + h + offsets[k]`` (h the largest |offset|, pad_l =
    h), so the panels equal :func:`build_band_plan`'s on the same matrix
    whenever its outermost diagonals hold an entry.  One indexed store
    writes every (row phase, diagonal) slot."""
    offs = [int(o) for o in offsets]
    ndiag = len(offs)
    m, n = shape
    if tuple(diags.shape) != (ndiag, m):
        raise ValueError(f"diags shape {tuple(diags.shape)} != "
                         f"({ndiag}, {m})")
    h = max(max(offs), -min(offs), 0)
    w = -(-(_R + 2 * h) // 8) * 8
    nblk = -(-m // _R)
    nblk = -(-nblk // _G) * _G
    mp = nblk * _R
    out_dtype = dtype or diags.dtype
    dev = diags.device
    dt = F.pad(diags.t().to(out_dtype), (0, 0, 0, mp - m))
    r = torch.arange(_R, device=dev).view(_R, 1)
    cols = r + h + torch.tensor(offs, device=dev).view(1, ndiag)
    panels = torch.zeros(nblk, _R, w, dtype=out_dtype, device=dev)
    panels[:, r, cols] = dt.view(nblk, _R, ndiag)
    return BandPlan(panels=panels.view(nblk * _R, w), pad_l=h,
                    shape=(m, n))


def band_spmm_reference(panels: torch.Tensor,
                        bp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of both SpMM kernels over the same windows
    as :func:`band_spmv_reference`: C[r] = panels[r] @ bp[(r // 128) *
    128 : + W] per row block, each block product in float64
    (:func:`types.wide_matmul`); returns (nblk * 128, k) f32."""
    nblk = panels.shape[0] // _R
    w = panels.shape[1]
    windows = bp.float()[: (nblk - 1) * _R + w].unfold(0, w, _R)  # (nblk,k,w)
    c = _t.wide_matmul(torch.bmm, panels.float().view(nblk, _R, w),
                       windows.transpose(1, 2))
    return c.reshape(nblk * _R, -1)


def _window_rows(b: torch.Tensor, pad_l: int, length: int,
                 perm: torch.Tensor | None = None) -> torch.Tensor:
    """The rows the kernels read from B in place, as a (length, k) copy:
    window row q is B row q - pad_l (or perm[q - pad_l]), zero where that
    falls outside B's rows."""
    src = torch.arange(length, device=b.device) - pad_l
    if perm is not None:
        inside = (src >= 0) & (src < perm.shape[0])
        src = torch.where(inside, perm.long()[src.clamp(0, max(
            perm.shape[0] - 1, 0))], -1)
    valid = (src >= 0) & (src < b.shape[0])
    bp = b.new_zeros((length,) + tuple(b.shape[1:]))
    bp[valid] = b[src[valid]]
    return bp


def _scatter_rows(c: torch.Tensor, m: int,
                  perm: torch.Tensor | None = None) -> torch.Tensor:
    """Band row j as C row j (perm[j] with ``perm``), rows below m."""
    if perm is None:
        return c[:m]
    dst = perm.long()
    keep = dst < m
    out = c.new_zeros((m,) + tuple(c.shape[1:]))
    out[dst[keep]] = c[keep]
    return out


def band_spmm_inplace_reference(panels: torch.Tensor, b: torch.Tensor,
                                pad_l: int, m: int,
                                perm: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernels' in-place read of B: the
    windows of :func:`band_spmm_reference` over B's rows shifted by pad_l
    (or gathered by ``perm``), zeros outside B; C's rows by
    :func:`_scatter_rows`.  Returns (m, k) f32."""
    rows, w = panels.shape
    bp = _window_rows(b.float(), pad_l, rows - _R + w, perm)
    return _scatter_rows(band_spmm_reference(panels, bp), m, perm)


def band_spmm_cx_reference(panels_re: torch.Tensor, panels_im: torch.Tensor,
                           b: torch.Tensor, pad_l: int,
                           m: int) -> torch.Tensor:
    """Plain PyTorch version of the complex pass: (P_re + i P_im) @ B
    over the in-place windows of B (complex64 or real), each row block's
    product in complex128; returns (m, k) complex64."""
    rows, w = panels_re.shape
    nblk = rows // _R
    bp = _window_rows(b, pad_l, rows - _R + w)
    windows = bp.unfold(0, w, _R).transpose(1, 2)          # (nblk, w, k)
    p = torch.complex(panels_re.double(), panels_im.double())
    c = torch.bmm(p.view(nblk, _R, w), windows.to(torch.complex128))
    return c.reshape(rows, -1)[:m].to(torch.complex64)


def _check_inplace(panels: torch.Tensor, b: torch.Tensor, pad_l: int,
                   m: int, perm: torch.Tensor | None = None,
                   b_dtypes=(torch.float32,)) -> None:
    """The checks of the in-place SpMM forms: B (n, k) contiguous beside
    the panels, 0 <= pad_l, 0 <= m <= rows, and ``perm`` (rows,) int32."""
    if panels.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"panels must be float32 or bfloat16, got "
                        f"{panels.dtype}")
    if b.dtype not in b_dtypes:
        raise TypeError(f"b must be {' or '.join(map(str, b_dtypes))}, "
                        f"got {b.dtype}")
    if panels.dim() != 2 or panels.shape[0] % _R or b.dim() != 2:
        raise ValueError(f"bad shapes: panels {tuple(panels.shape)}, b "
                         f"{tuple(b.shape)}")
    if panels.device != b.device:
        raise ValueError(f"panels on {panels.device}, b on {b.device}")
    if not (panels.is_contiguous() and b.is_contiguous()):
        raise ValueError("panels and b must be contiguous")
    rows = panels.shape[0]
    if pad_l < 0 or not 0 <= m <= rows:
        raise ValueError(f"pad_l {pad_l} and m {m} must be >= 0, m <= "
                         f"{rows}")
    if perm is not None and (perm.dtype != torch.int32
                             or tuple(perm.shape) != (rows,)
                             or perm.device != panels.device
                             or not perm.is_contiguous()):
        raise ValueError(f"perm must be a contiguous ({rows},) int32 "
                         f"tensor beside the panels")


# (panels, b, index, c, rows, w, k, n, pad_l, m, stream) of
# band_spmm_{f32,bf16}
_RES_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p,)
# (panels, b, c, rows, w, k, n, pad_l, m, flag, lim, stream) of
# band_spmm_stream_*
_STREAM_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p)
# (panels_re, panels_im, b, c, rows, w, k, n, pad_l, m, b_complex,
# stream) of band_spmm_cx
_CX_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (
    ctypes.c_void_p,)


def _symbol(entry: str, panels: torch.Tensor) -> str:
    return entry + ("_bf16" if panels.dtype == torch.bfloat16 else "_f32")


def _launch_resident(panels: torch.Tensor, b: torch.Tensor, pad_l: int,
                     m: int, perm: torch.Tensor | None) -> torch.Tensor:
    """One launch of the resident kernel; counted on
    :func:`band_spmm_padded`."""
    rows, w = panels.shape
    n, k = b.shape
    c = torch.empty(m, k, dtype=torch.float32, device=panels.device)
    stream = torch.cuda.current_stream(panels.device).cuda_stream
    _build.check(_build.function(
        "band_spmm", _symbol("band_spmm", panels), _RES_ARGTYPES)(
        panels.data_ptr(), b.data_ptr(),
        None if perm is None else perm.data_ptr(), c.data_ptr(), rows, w,
        k, n, pad_l, m, stream), "band_spmm")
    band_spmm_padded.launches += 1
    return c


def _launch_stream(panels: torch.Tensor, b: torch.Tensor, pad_l: int,
                   m: int, amax) -> torch.Tensor:
    """One launch of the tensor-core kernel, counted on
    :func:`band_spmm_stream_padded`'s ``launches``, then the resident
    kernel gated by the call's flag, counted on its ``gated``: the
    tensor-core kernel raises the flag where a B value fails the test
    against ``types.tf32_b_limit(amax)`` (``csrc/tf32_mma.cuh``, Limits),
    and the resident kernel then rewrites C; with the flag down it exits
    at once.  ``amax`` is the panels' largest magnitude
    (``BandPlan.tf32_amax``); the call reads nothing back to find it.  The
    flag stays readable as ``band_spmm_stream_padded.flag``, the path the
    call took."""
    rows, w = panels.shape
    n, k = b.shape
    if amax is None:
        raise ValueError("band_spmm_stream: amax, the panels' largest "
                         "magnitude (BandPlan.tf32_amax), is required on "
                         "CUDA")
    c = torch.empty(m, k, dtype=torch.float32, device=panels.device)
    flag = torch.zeros(1, dtype=torch.int32, device=panels.device)
    stream = torch.cuda.current_stream(panels.device).cuda_stream
    _build.check(_build.function(
        "band_spmm", _symbol("band_spmm_stream", panels), _STREAM_ARGTYPES)(
        panels.data_ptr(), b.data_ptr(), c.data_ptr(), rows, w, k, n, pad_l,
        m, flag.data_ptr(), _t.tf32_b_limit(amax), stream),
        "band_spmm_stream")
    band_spmm_stream_padded.launches += 1
    band_spmm_stream_padded.gated += 1
    band_spmm_stream_padded.flag = flag
    return c


def band_spmm_padded(panels: torch.Tensor,
                     bp: torch.Tensor) -> torch.Tensor:
    """Core panel SpMM over pre-padded f32 B (rows >= nblk*128 + W - 128)
    with B read from device memory; returns (nblk * 128, k) f32.  CUDA
    tensors launch ``band_spmm.cu``'s resident entry point (pad_l 0, no
    index); CPU tensors take :func:`band_spmm_reference`.  ``launches``
    counts every resident launch, the in-place forms' too, but not the
    gated one behind a tensor-core call (``band_spmm_stream_padded.gated``)."""
    _check_operands(panels, bp, ndim=2)
    if not _t.on_cuda(panels):
        return band_spmm_reference(panels, bp)
    return _launch_resident(panels, bp, 0, panels.shape[0], None)


band_spmm_padded.launches = 0


def band_spmm_stream_padded(panels: torch.Tensor, bp: torch.Tensor,
                            amax=None) -> torch.Tensor:
    """The same product with each row block's B window streamed through
    shared memory, on the tensor cores, B tested against the panels'
    largest magnitude ``amax`` (:func:`_launch_stream`; required on
    CUDA); CUDA tensors launch ``band_spmm.cu``'s stream entry point, CPU
    tensors take :func:`band_spmm_reference`.  ``launches`` counts its
    in-place form's launches too, ``gated`` the resident launches gated
    behind them."""
    _check_operands(panels, bp, ndim=2)
    if not _t.on_cuda(panels):
        return band_spmm_reference(panels, bp)
    return _launch_stream(panels, bp, 0, panels.shape[0], amax)


band_spmm_stream_padded.launches = 0
band_spmm_stream_padded.gated = 0
band_spmm_stream_padded.flag = None


def band_spmm_inplace(panels: torch.Tensor, b: torch.Tensor, pad_l: int,
                      m: int, perm: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The resident product with B read where it lies, no padded copy:
    window row q of a row block reads B row q - pad_l, zero outside
    [0, n); with ``perm`` (a permutation of [0, rows), as
    :class:`PermutedBandPlan` holds) it reads B row perm[q - pad_l], zero
    where that is >= n, and band row j is written to C row perm[j].
    Returns (m, k) f32 C, rows at or past m dropped.  CUDA tensors launch
    the resident kernel, CPU tensors take
    :func:`band_spmm_inplace_reference`."""
    _check_inplace(panels, b, pad_l, m, perm)
    if not _t.on_cuda(panels):
        return band_spmm_inplace_reference(panels, b, pad_l, m, perm)
    return _launch_resident(panels, b, pad_l, m, perm)


def band_spmm_stream_inplace(panels: torch.Tensor, b: torch.Tensor,
                             pad_l: int, m: int, amax=None) -> torch.Tensor:
    """:func:`band_spmm_inplace` (no index) on the tensor-core kernel, B
    tested against ``amax`` as :func:`band_spmm_stream_padded` tests it."""
    _check_inplace(panels, b, pad_l, m)
    if not _t.on_cuda(panels):
        return band_spmm_inplace_reference(panels, b, pad_l, m)
    return _launch_stream(panels, b, pad_l, m, amax)


def band_spmm_cx(panels_re: torch.Tensor, panels_im: torch.Tensor,
                 b: torch.Tensor, pad_l: int, m: int) -> torch.Tensor:
    """C = (P_re + i P_im) @ B over two f32 panel planes of one band (the
    same width and pad_l) in one pass, B (n, k) complex64 or f32 read in
    place as :func:`band_spmm_inplace` reads it; returns (m, k)
    complex64.  CUDA tensors launch ``band_spmm.cu``'s complex entry
    point, CPU tensors take :func:`band_spmm_cx_reference`."""
    if panels_re.shape != panels_im.shape or panels_im.dtype != \
            torch.float32 or panels_re.device != panels_im.device \
            or not panels_im.is_contiguous():
        raise ValueError("the two planes must be contiguous float32 "
                         "panels of one shape")
    _check_inplace(panels_re, b, pad_l, m,
                   b_dtypes=(torch.complex64, torch.float32))
    if panels_re.dtype != torch.float32:
        raise TypeError(f"complex planes must be float32, got "
                        f"{panels_re.dtype}")
    if not _t.on_cuda(panels_re):
        return band_spmm_cx_reference(panels_re, panels_im, b, pad_l, m)
    rows, w = panels_re.shape
    n, k = b.shape
    c = torch.empty(m, k, dtype=torch.complex64, device=panels_re.device)
    stream = torch.cuda.current_stream(panels_re.device).cuda_stream
    _build.check(_build.function("band_spmm", "band_spmm_cx", _CX_ARGTYPES)(
        panels_re.data_ptr(), panels_im.data_ptr(), b.data_ptr(),
        c.data_ptr(), rows, w, k, n, pad_l, m, int(b.is_complex()),
        stream), "band_spmm_cx")
    band_spmm_cx.launches += 1
    return c


band_spmm_cx.launches = 0


def pad_b(plan: BandPlan, b: torch.Tensor) -> torch.Tensor:
    """B as :func:`band_spmm_padded` reads it: f32, rows shifted down by
    pad_l, then padded or trimmed to L = nblk*128 - 128 + W rows (the JAX
    padding of ``band_spmm``).  A copy of B; the plan entry points read B
    in place instead."""
    n = plan.shape[1]
    L = plan.nblocks * _R - _R + plan.width
    bp = F.pad(b.float(), (0, 0, plan.pad_l, max(0, L - plan.pad_l - n)))
    return bp[:L].contiguous()


def _b_operand(b: torch.Tensor) -> torch.Tensor:
    """B as the kernels read it in place: f32 and contiguous; another
    dtype or a strided view is converted by one copy."""
    if b.dtype == torch.float32 and b.is_contiguous():
        return b
    return b.float().contiguous()


def band_spmm(plan: BandPlan, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B (dense (n, k) B) over the panel layout on the resident
    kernel, B read in place."""
    c = band_spmm_inplace(plan.panels, _b_operand(b), plan.pad_l,
                          plan.shape[0])
    return c.to(torch.promote_types(plan.panels.dtype, b.dtype))


def band_spmm_stream(plan: BandPlan, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with each row block's B window streamed through shared
    memory, on the tensor cores, B read in place.  Panels with nonzero
    f32 entries below 2^-112, an infinity or a NaN (``plan.tf32_exact``
    False), where the 3xTF32 split keeps fewer bits, take
    :func:`band_spmm`'s f32 FMAs instead; a B that fails the kernel's
    test against ``plan.tf32_amax`` gets them through the gated resident
    launch (``csrc/tf32_mma.cuh``, Limits).  Nothing is read back to the
    host."""
    if not plan.tf32_exact:
        return band_spmm(plan, b)
    c = band_spmm_stream_inplace(plan.panels, _b_operand(b), plan.pad_l,
                                 plan.shape[0], amax=plan.tf32_amax)
    return c.to(torch.promote_types(plan.panels.dtype, b.dtype))


def band_power_reference(panels: torch.Tensor, xp: torch.Tensor,
                         iters: int, h: int) -> torch.Tensor:
    """Plain PyTorch version of the power kernel: ``iters`` chained
    :func:`band_spmv_reference` steps, each writing its y into rows
    [h, h + nblk*128) of a fresh zero buffer of xp's length (the padded
    slot of the next step).  Returns the last (L,) f32 buffer."""
    rows = panels.shape[0]
    for _ in range(iters):
        y = band_spmv_reference(panels, xp)
        xp = torch.zeros_like(xp)
        xp[h:h + rows] = y
    return xp


# (panels, buf0, buf1, rows, w, h, iters, stream) of band_power_{f32,bf16}
_POWER_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,)


def band_power_padded(panels: torch.Tensor, xp: torch.Tensor, iters: int,
                      h: int) -> torch.Tensor:
    """y = A^iters x over pre-padded f32 x (length L = nblk*128 - 128 +
    W, x at [h, h + n), zeros elsewhere); returns the padded (L,) f32
    result, y at [h, h + nblk*128).  CUDA tensors launch
    ``band_power.cu``: one C call issues the ``iters`` launches over two
    ping-pong buffers; CPU tensors take :func:`band_power_reference`."""
    _check_operands(panels, xp)
    rows, w = panels.shape
    if xp.shape[0] < h + rows + h:
        raise ValueError(f"xp length {xp.shape[0]} < {rows + 2 * h}")
    if not _t.on_cuda(panels):
        return band_power_reference(panels, xp, iters, h)
    bufs = (xp.clone(), torch.zeros_like(xp))
    stream = torch.cuda.current_stream(panels.device).cuda_stream
    symbol = ("band_power_bf16" if panels.dtype == torch.bfloat16
              else "band_power_f32")
    _build.check(_build.function("band_power", symbol, _POWER_ARGTYPES)(
        panels.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), rows, w,
        h, iters, stream), "band_power")
    band_power_padded.launches += iters
    return bufs[iters % 2]


band_power_padded.launches = 0


def band_power_iterations(plan: BandPlan, x: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """y = A^iters · x over a square plan, the vector in f32 throughout;
    ``iters <= 0`` returns x.  The result has the dtype of
    ``promote_types(panels.dtype, x.dtype)``."""
    m, n = plan.shape
    if m != n:
        raise ValueError("band_power_iterations requires a square plan")
    if iters <= 0:
        return x
    h = plan.pad_l
    out = band_power_padded(plan.panels, pad_x(plan, x), int(iters), h)
    return out[h:h + m].to(torch.promote_types(plan.panels.dtype, x.dtype))


@dataclasses.dataclass(frozen=True)
class PermutedBandPlan:
    """RCM-reordered band plan for a general square matrix: the native
    RCM inspector (``native.rcm``) finds a low-bandwidth symmetric
    ordering P, and P·A·Pᵀ becomes dense band panels.

      perm: (mp,) int32, perm[i] = old position of new i, padded with
            the identities m..mp-1
      rank: (mp,) int32, its inverse (rank[j] = new position of old j)
    """

    band: BandPlan
    perm: torch.Tensor
    rank: torch.Tensor

    @property
    def shape(self):
        return self.band.shape


def build_permuted_band_plan(a: CSR, perm=None) -> PermutedBandPlan:
    """Host inspect: permute the CSR by ``perm`` (RCM when None) and lay
    the result out as band panels, on the matrix's device."""
    m, n = a.shape
    if m != n:
        raise ValueError("permuted band plan requires a square matrix")
    nnz = a.nnz
    rows, colind, vals = host_arrays(a)
    if perm is None:
        perm, _ = native.rcm(m, nnz, _t.to_numpy(a.rowptr).astype(np.int64),
                             colind)
    perm = np.asarray(perm)
    rank = np.empty(m, np.int64)
    rank[perm] = np.arange(m)
    new_rows = rank[rows]
    new_cols = rank[colind]
    order = np.lexsort((new_cols, new_rows))
    p_rowptr = np.zeros(m + 1, np.int64)
    np.add.at(p_rowptr[1:], new_rows, 1)
    pa = CSR.from_arrays(vals[order], np.cumsum(p_rowptr), new_cols[order],
                         (m, m), nnz=nnz, device=a.device)
    band = build_band_plan(pa)
    mp = band.nblocks * _R
    perm_p = np.concatenate([perm, np.arange(m, mp)]).astype(np.int32)
    rank_p = np.concatenate([rank, np.arange(m, mp)]).astype(np.int32)
    return PermutedBandPlan(band=band,
                            perm=torch.from_numpy(perm_p).to(a.device),
                            rank=torch.from_numpy(rank_p).to(a.device))


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    pad = (0, 0) * (t.dim() - 1) + (0, rows - t.shape[0])
    return F.pad(t, pad)


def _permuted_apply(fn, plan: PermutedBandPlan,
                    x: torch.Tensor) -> torch.Tensor:
    """A = P^T (P A P^T) P: gather the rows of x (or B) by perm, apply
    ``fn`` over the band, gather the rows of the result by rank."""
    m, n = plan.shape
    mp = plan.perm.shape[0]
    x_p = _pad_rows(x, mp).index_select(0, plan.perm)[:n]
    return _pad_rows(fn(plan.band, x_p), mp).index_select(0, plan.rank)[:m]


def permuted_band_spmv(plan: PermutedBandPlan, x: torch.Tensor
                       ) -> torch.Tensor:
    """y = A @ x over the permuted band."""
    return _permuted_apply(band_spmv, plan, x)


def permuted_band_spmm(plan: PermutedBandPlan, b: torch.Tensor
                       ) -> torch.Tensor:
    """C = A @ B over the permuted band with the resident band SpMM (as
    JAX's ``plan_spmm`` does for ``band_perm``), in one launch: the
    kernel gathers B's rows by perm as it reads them and writes C's rows
    through perm, so neither is copied."""
    c = band_spmm_inplace(plan.band.panels, _b_operand(b), plan.band.pad_l,
                          plan.shape[0], perm=plan.perm)
    return c.to(torch.promote_types(plan.band.panels.dtype, b.dtype))

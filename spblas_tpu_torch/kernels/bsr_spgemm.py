"""Block SpGEMM: C = A @ B with BSR operands — counterpart of
``spblas_tpu/kernels/bsr_spgemm.py``.

With block structure the product is a stream of dense (bh, bk) @
(bk, bw) block products.  The symbolic phase works on the block graph
(numpy on the host, small); the numeric phase sums each C block's pair
products.  On a CUDA tensor :func:`bsr_spgemm_blocks` launches the
hand-written kernel ``csrc/bsr_spgemm.cu`` (which replaces the TPU
kernel ``bsr_spgemm.py::_numeric_kernel``): on the tensor cores, f32 by
the 3xTF32 split of ``csrc/tf32_mma.cuh``, f64 by the FP64 tensor cores.
On a CPU tensor it runs :func:`bsr_spgemm_reference`, the plain PyTorch
version.

Layout contract: A is BSR with blocks (bh, bk); B is BSR with blocks
(bk, bw); C comes out BSR with blocks (bh, bw).  The kernel takes any
block shape; bh a multiple of 8 and bk, bw multiples of 128 are the
shapes the TPU kernel was written for.  The kernel computes in float32
or float64; other real dtypes compute in float32, complex ones as real
planes (four launches), and the result is in result_type(A, B).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.bsr import BSR

_KERNEL_DTYPES = (torch.float32, torch.float64)
# elements of the largest of the plain version's gathered A blocks, B
# blocks and pair products formed at once
_REF_PRODUCT_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class BsrSpgemmPlan:
    """Numeric plan from the block-symbolic phase.

    pair_ptr (nnzb_c + 1,): contraction-pair range per C block;
    pair_a / pair_b: A / B block indices per pair;
    c_rowptr / c_colind: C's block structure.
    """

    pair_ptr: torch.Tensor
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    c_rowptr: torch.Tensor
    c_colind: torch.Tensor
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nnzb_c(self) -> int:
        return int(self.pair_ptr.shape[0]) - 1

    @property
    def npairs(self) -> int:
        return int(self.pair_ptr[-1]) if self.nnzb_c else 0


def bsr_spgemm_compute(a: BSR, b: BSR) -> BsrSpgemmPlan:
    """Block-symbolic phase (host): the structure of C and the
    contraction pair list of each C block, on A's device.  Costs
    O(block flops) on the block graph."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"bsr_spgemm: A is {a.shape}, B is {b.shape}")
    bh, bk = a.block_shape
    bk2, bw = b.block_shape
    if bk != bk2:
        raise ValueError(
            f"block mismatch: A blocks {a.block_shape}, "
            f"B blocks {b.block_shape}")
    na = a.nnz_blocks
    nb = b.nnz_blocks
    a_rp = _t.to_numpy(a.block_rowptr).astype(np.int64)
    a_ci = _t.to_numpy(a.block_colind)[:na]
    a_rows = np.repeat(np.arange(len(a_rp) - 1),
                       np.minimum(a_rp[1:], na) - np.minimum(a_rp[:-1], na))
    b_rp = _t.to_numpy(b.block_rowptr).astype(np.int64)
    b_ci = _t.to_numpy(b.block_colind)[:nb]

    # expansion over the block graph: every A block (i, kk) pairs with
    # every B block of block row kk
    b_len = np.minimum(b_rp[1:], nb) - np.minimum(b_rp[:-1], nb)
    counts = b_len[a_ci]
    e_total = int(counts.sum())
    src_a = np.repeat(np.arange(na), counts)
    local = np.arange(e_total) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    src_b = np.repeat(np.minimum(b_rp[:-1], nb)[a_ci], counts) + local
    rows_e = np.repeat(a_rows, counts)
    cols_e = b_ci[src_b]
    order = np.lexsort((cols_e, rows_e))
    rows_s, cols_s = rows_e[order], cols_e[order]
    heads = np.concatenate([[True], (rows_s[1:] != rows_s[:-1])
                            | (cols_s[1:] != cols_s[:-1])]) \
        if e_total else np.zeros(0, bool)
    pair_ptr = np.concatenate([np.flatnonzero(heads), [e_total]]) \
        if e_total else np.zeros(1, np.int64)
    c_colind = cols_s[heads] if e_total else np.zeros(0, np.int64)
    c_rows = rows_s[heads] if e_total else np.zeros(0, np.int64)
    mb = len(a_rp) - 1
    c_rowptr = np.zeros(mb + 1, np.int64)
    np.add.at(c_rowptr[1:], c_rows, 1)
    pa = src_a[order] if e_total else np.zeros(1, np.int64)
    pb = src_b[order] if e_total else np.zeros(1, np.int64)
    dev = a.device
    return BsrSpgemmPlan(
        pair_ptr=_t.as_tensor(pair_ptr, dev, torch.int32),
        pair_a=_t.as_tensor(pa, dev, torch.int32),
        pair_b=_t.as_tensor(pb, dev, torch.int32),
        c_rowptr=_t.as_tensor(np.cumsum(c_rowptr), dev, _t.offset_dtype),
        c_colind=_t.as_tensor(c_colind, dev, _t.index_dtype),
        shape=(m, n), block_shape=(bh, bw))


def bsr_spgemm_reference(pair_ptr, pair_a, pair_b, a_values,
                         b_values) -> torch.Tensor:
    """Plain PyTorch version of the kernel: C[e] = the sum of the pair
    products A[pair_a[t]] @ B[pair_b[t]] over the pairs t of C block e,
    each product and the sum in float64 (complex128 for complex
    operands; :func:`types.wide_matmul`), returned in the operands'
    dtype as (nnzb_c, bh, bw)."""
    nnzb_c = int(pair_ptr.shape[0]) - 1
    bh, bw = int(a_values.shape[1]), int(b_values.shape[2])
    dtype = torch.promote_types(a_values.dtype, b_values.dtype)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    out = torch.zeros(nnzb_c, bh, bw, dtype=wide, device=a_values.device)
    npairs = int(pair_ptr[-1]) if nnzb_c else 0
    if npairs:
        c_of = torch.searchsorted(pair_ptr[1:], torch.arange(
            npairs, dtype=pair_ptr.dtype, device=pair_ptr.device),
            right=True)
        bk = int(a_values.shape[2])
        step = max(1, _REF_PRODUCT_ELEMS // max(bh * bw, bk * bw, bh * bk))
        for s in range(0, npairs, step):
            part = _t.wide_matmul(
                torch.bmm, a_values[pair_a[s:s + step].long()].to(wide),
                b_values[pair_b[s:s + step].long()].to(wide))
            out.index_add_(0, c_of[s:s + step], part)
    return out.to(dtype)


def _check_operands(pair_ptr, pair_a, pair_b, a_values, b_values) -> None:
    ts = (pair_ptr, pair_a, pair_b, a_values, b_values)
    if any(t.device != a_values.device for t in ts):
        raise ValueError("pair lists and blocks must share a device")
    if any(t.dtype != torch.int32 for t in ts[:3]):
        raise TypeError("pair_ptr, pair_a and pair_b must be int32")
    if a_values.dtype not in _KERNEL_DTYPES \
            or b_values.dtype != a_values.dtype:
        raise TypeError(f"blocks must be one of float32/float64, got "
                        f"{a_values.dtype} and {b_values.dtype}")
    if a_values.dim() != 3 or b_values.dim() != 3 \
            or a_values.shape[2] != b_values.shape[1] \
            or pair_a.shape != pair_b.shape:
        raise ValueError(f"bad shapes: A blocks {tuple(a_values.shape)}, "
                         f"B blocks {tuple(b_values.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("pair lists and blocks must be contiguous")


# (pair_ptr, pair_a, pair_b, A, B, C, nnzb_c, bh, bk, bw, vec, stream) of
# bsr_spgemm_{f32,f64}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)


def bsr_spgemm_blocks(pair_ptr, pair_a, pair_b, a_values,
                      b_values) -> torch.Tensor:
    """The C blocks (nnzb_c, bh, bw) of one real dtype from the pair
    lists and the A and B blocks.  CUDA tensors launch
    ``bsr_spgemm.cu``; CPU tensors take :func:`bsr_spgemm_reference`."""
    _check_operands(pair_ptr, pair_a, pair_b, a_values, b_values)
    if not _t.on_cuda(a_values):
        return bsr_spgemm_reference(pair_ptr, pair_a, pair_b, a_values,
                                    b_values)
    nnzb_c = int(pair_ptr.shape[0]) - 1
    _, bh, bk = a_values.shape
    bw = int(b_values.shape[2])
    c = torch.empty(nnzb_c, bh, bw, dtype=a_values.dtype,
                    device=a_values.device)
    width = 16 // a_values.element_size()
    vec = int(bk % width == 0 and bw % width == 0
              and all(t.data_ptr() % 16 == 0 for t in (a_values, b_values,
                                                       c)))
    sym = "bsr_spgemm_" + ("f64" if a_values.dtype == torch.float64
                           else "f32")
    stream = torch.cuda.current_stream(a_values.device).cuda_stream
    _build.check(_build.function("bsr_spgemm", sym, _ARGTYPES)(
        pair_ptr.data_ptr(), pair_a.data_ptr(), pair_b.data_ptr(),
        a_values.data_ptr(), b_values.data_ptr(), c.data_ptr(), nnzb_c, bh,
        bk, bw, vec, stream), "bsr_spgemm")
    bsr_spgemm_blocks.launches += 1
    return c


bsr_spgemm_blocks.launches = 0


def _blocks(plan: BsrSpgemmPlan, av, bv, out_dtype,
            exact=True) -> torch.Tensor:
    """The C blocks in ``out_dtype``: one kernel call for real operands,
    real planes (up to four calls) for complex ones.  ``exact`` False
    (operands with nonzero f32 values below 2^-112, where the 3xTF32
    split keeps fewer bits) runs the f32 products on the f64 kernel: exact
    products, rounded once to f32."""
    pp, pa, pb = plan.pair_ptr, plan.pair_a, plan.pair_b
    if not out_dtype.is_complex:
        dt = out_dtype if out_dtype in _KERNEL_DTYPES else torch.float32
        if dt == torch.float32 and not exact:
            dt = torch.float64
        return bsr_spgemm_blocks(pp, pa, pb, av.to(dt).contiguous(),
                                 bv.to(dt).contiguous()).to(out_dtype)
    real = torch.float64 if out_dtype == torch.complex128 or not exact \
        else torch.float32

    def planes(t):
        if not t.is_complex():
            return t.to(real).contiguous(), None
        t = t.resolve_conj()
        return t.real.to(real).contiguous(), t.imag.to(real).contiguous()

    ar, ai = planes(av)
    br, bi = planes(bv)
    cr = bsr_spgemm_blocks(pp, pa, pb, ar, br)
    ci = bsr_spgemm_blocks(pp, pa, pb, ar, bi) if bi is not None \
        else torch.zeros_like(cr)
    if ai is not None:
        ci = ci + bsr_spgemm_blocks(pp, pa, pb, ai, br)
        if bi is not None:
            cr = cr - bsr_spgemm_blocks(pp, pa, pb, ai, bi)
    return torch.complex(cr, ci).to(out_dtype)


def bsr_spgemm_numeric(plan: BsrSpgemmPlan, a: BSR, b: BSR) -> BSR:
    """Numeric phase: each C block the sum of its pair products.
    Re-runnable with new values over unchanged block sparsity.  The
    result's capacity is a power-of-two bucket of its blocks."""
    bh, bw = plan.block_shape
    nnzb_c = plan.nnzb_c
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    dev = a.device
    if nnzb_c == 0:
        return BSR(values=torch.zeros(1, bh, bw, dtype=out_dtype,
                                      device=dev),
                   block_rowptr=plan.c_rowptr,
                   block_colind=torch.zeros(1, dtype=_t.index_dtype,
                                            device=dev),
                   nnz_blocks=0, shape=plan.shape,
                   block_shape=plan.block_shape)
    # operands the 3xTF32 split cannot carry (tf32_exact), or whose
    # largest magnitudes make a product of the split pass FLT_MAX, take
    # the f64 kernel (csrc/tf32_mma.cuh, Limits)
    c_blocks = _blocks(plan, a.values, b.values, out_dtype,
                       exact=a.tf32_exact and b.tf32_exact
                       and _t.tf32_products_safe(a.tf32_amax, b.tf32_amax))
    cap = _t.quantize_capacity(max(nnzb_c, 1))
    pad = cap - nnzb_c
    values = torch.cat([c_blocks, c_blocks.new_zeros(pad, bh, bw)]) \
        if pad else c_blocks
    colind = torch.cat([plan.c_colind, plan.c_colind.new_zeros(pad)]) \
        if pad else plan.c_colind
    return BSR(values=values, block_rowptr=plan.c_rowptr,
               block_colind=colind, nnz_blocks=nnzb_c, shape=plan.shape,
               block_shape=plan.block_shape)


def bsr_spgemm(a: BSR, b: BSR) -> BSR:
    """One-shot block SpGEMM (compute + numeric)."""
    return bsr_spgemm_numeric(bsr_spgemm_compute(a, b), a, b)

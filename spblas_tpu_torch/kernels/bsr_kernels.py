"""BSR SpMV and SpMM — counterpart of ``spblas_tpu/kernels/bsr_pallas.py``.

Each stored block is a dense (bh, bw) tile, so block-sparse products
need no index traffic inside a block.  On a CUDA tensor
:func:`bsr_spmv_blocks` and :func:`bsr_spmm_blocks` launch the
hand-written kernels ``csrc/bsr_spmv.cu`` and ``csrc/bsr_spmm.cu``
(which replace the TPU kernels ``bsr_pallas.py::_bsr_spmv_kernel`` and
``_bsr_spmm_kernel``); on a CPU tensor they run
:func:`bsr_spmv_reference` and :func:`bsr_spmm_reference`, the plain
PyTorch versions of the same sums.  The SpMV kernel takes any block
shape in one of three mappings that :func:`spmv_mapping` picks from the
shape, the dtype and the operands' alignment, and reads x in place.  The f32 SpMM kernel walks the
blocks by block column (``BSR.column_order``), each block's product
into its own slot of a scratch buffer, then sums each block row's slots
in order; :func:`bsr_spmm_columns_reference` is that walk in plain
PyTorch.

The kernels take float32 or float64 blocks; :func:`bsr_spmv` and
:func:`bsr_spmm` compute in ``result_type(A, x)`` as the JAX functions
do, a complex product as real planes (four launches when both operands
are complex, as ``band_cx_spmv`` does).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spblas_tpu_torch import _build
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.bsr import BSR, block_column_order

_KERNEL_DTYPES = (torch.float32, torch.float64)
# bytes of the f32 SpMM's slot scratch a call may hold (its block
# products, one (bh, k) slot a stored block): past it a call walks k in
# column phases, and ranges of block rows where one phase of
# _SPMM_KTILE columns alone passes it
SPMM_SCRATCH_BYTES = 1 << 30
_SPMM_KTILE = 64           # the f32 kernel's k-tile (csrc/bsr_spmm.cu)
# entries of a block's B slice gathered at once by the plain SpMM (keeps
# its (entries, bw, k) intermediate near 1 GB at the main path's widths)
_REF_GATHER_ELEMS = 1 << 28


def _block_rows(rowptr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Block row of each block slot; padded slots map to mb."""
    e = torch.arange(capacity, dtype=rowptr.dtype, device=rowptr.device)
    return torch.searchsorted(rowptr[1:], e, right=True)


def bsr_spmv_reference(values, block_rowptr, block_colind,
                       x) -> torch.Tensor:
    """Plain PyTorch version of the kernel: y[i*bh + r] = sum over the
    blocks e of block row i of values[e, r, :] . x[colind[e]*bw:+bw], in
    the blocks' dtype, x read as zeros past its end; returns (mb * bh,)."""
    cap, bh, bw = values.shape
    mb = block_rowptr.shape[0] - 1
    n = int(x.shape[0])
    idx = (block_colind.long()[:, None] * bw
           + torch.arange(bw, device=x.device))
    xs = x[idx.clamp(max=max(n - 1, 0))] if n else x.new_zeros(idx.shape)
    xs = torch.where(idx < n, xs, 0)
    part = (values * xs[:, None, :]).sum(dim=2)         # (cap, bh)
    out = torch.zeros(mb + 1, bh, dtype=values.dtype, device=values.device)
    out.index_add_(0, _block_rows(block_rowptr, cap), part)
    return out[:mb].reshape(mb * bh)


def bsr_spmm_reference(values, block_rowptr, block_colind,
                       b) -> torch.Tensor:
    """Plain PyTorch version of the kernel: C block row i = sum over its
    blocks e of values[e] @ B[colind[e]*bw:+bw, :] (each block product
    in float64, :func:`types.wide_matmul`), in the blocks' dtype; returns
    (mb * bh, k)."""
    cap, bh, bw = values.shape
    mb = block_rowptr.shape[0] - 1
    k = int(b.shape[1])
    bsl = b[: (int(b.shape[0]) // bw) * bw].reshape(-1, bw, k)
    rows = _block_rows(block_rowptr, cap)
    out = torch.zeros(mb + 1, bh, k, dtype=values.dtype,
                      device=values.device)
    step = max(1, _REF_GATHER_ELEMS // max(bw * k, 1))
    for s in range(0, cap, step):
        part = _t.wide_matmul(torch.bmm, values[s:s + step],
                              bsl.index_select(
                                  0, block_colind[s:s + step].long()))
        out.index_add_(0, rows[s:s + step], part)
    return out[:mb].reshape(mb * bh, k)


def bsr_spmm_columns_reference(values, block_rowptr, block_colind, b,
                               column_order=None) -> torch.Tensor:
    """The f32 kernel's walk in plain PyTorch: for each block column j,
    the blocks listed in ``column_order`` (default: built from the
    structure, :func:`block_column_order`) each take their product with
    B's slice of column j (in float64) into their own slot; then each
    block row sums its slots in block order.  Returns (mb * bh, k) in
    the blocks' dtype."""
    cap, bh, bw = values.shape
    mb = block_rowptr.shape[0] - 1
    k = int(b.shape[1])
    ncb = -(-int(b.shape[0]) // max(bw, 1))
    col_ptr, col_order = (column_order if column_order is not None
                          else block_column_order(block_rowptr, block_colind,
                                                  ncb))
    bsl = torch.nn.functional.pad(b, (0, 0, 0, ncb * bw - b.shape[0]))
    bsl = bsl.reshape(ncb, bw, k)
    slots = torch.zeros(cap, bh, k, dtype=torch.float64, device=values.device)
    ptr = col_ptr.tolist()
    for j in range(ncb):
        blocks = col_order[ptr[j]:ptr[j + 1]].long()
        if blocks.numel():
            slots[blocks] = torch.matmul(values[blocks].double(),
                                         bsl[j].double())
    rows = _block_rows(block_rowptr, cap)
    stored = torch.arange(cap, device=values.device) < block_rowptr[-1]
    out = torch.zeros(mb + 1, bh, k, dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, rows[stored], slots[stored])
    return out[:mb].reshape(mb * bh, k).to(values.dtype)


def bsr_spmm_cuts_reference(values, block_rowptr, block_colind, b,
                            column_order=None, budget=None) -> torch.Tensor:
    """The f32 kernel's walk cut as :func:`spmm_phases` cuts a call past
    the scratch ``budget``: :func:`bsr_spmm_columns_reference` on each
    cut's blocks, column list and columns of B, into its block rows and
    columns of C.  Returns (mb * bh, k) in the blocks' dtype."""
    cap, bh, bw = values.shape
    mb = block_rowptr.shape[0] - 1
    k = int(b.shape[1])
    ncb = -(-int(b.shape[0]) // max(bw, 1))
    col_ptr, col_order = (column_order if column_order is not None
                          else block_column_order(block_rowptr, block_colind,
                                                  ncb))
    c = torch.empty(mb * bh, k, dtype=values.dtype, device=values.device)
    for r0, r1, e0, rp, cp, co, p0, p1 in spmm_phases(
            block_rowptr, block_colind, col_ptr, col_order, cap, bh, k, ncb,
            budget):
        e1 = e0 + int(co.shape[0])
        c[r0 * bh:r1 * bh, p0:p1] = bsr_spmm_columns_reference(
            values[e0:e1], rp, block_colind[e0:e1], b[:, p0:p1], (cp, co))
    return c


def _check_operands(values, block_rowptr, block_colind, x, ndim) -> None:
    if not (values.device == block_rowptr.device == block_colind.device
            == x.device):
        raise ValueError("values, block_rowptr, block_colind and the dense "
                         "operand must share a device")
    if values.dtype not in _KERNEL_DTYPES or x.dtype != values.dtype:
        raise TypeError(f"values and the dense operand must be one of "
                        f"float32/float64, got {values.dtype} and {x.dtype}")
    if block_rowptr.dtype != torch.int32 or block_colind.dtype != torch.int32:
        raise TypeError("block_rowptr and block_colind must be int32")
    if values.dim() != 3 or x.dim() != ndim or block_rowptr.dim() != 1 \
            or block_colind.shape != values.shape[:1]:
        raise ValueError(f"bad shapes: values {tuple(values.shape)}, "
                         f"block_colind {tuple(block_colind.shape)}, "
                         f"operand {tuple(x.shape)}")
    if not (values.is_contiguous() and x.is_contiguous()
            and block_rowptr.is_contiguous()
            and block_colind.is_contiguous()):
        raise ValueError("BSR arrays and the dense operand must be "
                         "contiguous")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


# (values, rowptr, colind, x, y, mb, bh, bw, n, mapping, vec, stream) of
# bsr_spmv_{f32,f64}
_SPMV_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# the SpMV kernel's mappings (csrc/bsr_spmv.cu)
SPMV_COLS, SPMV_SPAN, SPMV_SMALL = 0, 1, 2
# (values, rowptr, colind, b, c, mb, bh, bw, k, vec, gate, stream) of
# bsr_spmm_f64 and bsr_spmm_f32_fma
_SPMM_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p, ctypes.c_void_p)
# (values, rowptr, col_ptr, col_order, b, partial, c, mb, ncb, bh, bw, k,
# ldb, ldc, vec, flag, lim, stream) of bsr_spmm_f32
_SPMM_F32_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_void_p)


def _suffix(dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def spmv_mapping(bh: int, bw: int, itemsize: int, aligned: bool = True):
    """(mapping, vec) of the SpMV kernel for (bh, bw) blocks of
    ``itemsize``-byte values: vec, the elements of one load, is the
    largest power of two up to 16 bytes that divides bw (1 where the
    operands are not 16-byte aligned).  Power-of-two blocks of at most
    32 * vec elements take ``SPMV_SPAN`` (a warp a block row in vec-wide
    pieces), other blocks of at most 32 elements, such as 3x3,
    ``SPMV_SMALL`` (a warp a block row, whole blocks a step, an element
    a lane), and every other shape ``SPMV_COLS`` (a warp an output
    row)."""
    vec = 16 // itemsize if aligned else 1
    while bw % vec:
        vec //= 2
    size = bh * bw
    if size & (size - 1) == 0 and size <= 32 * vec:
        return SPMV_SPAN, vec
    if size <= 32:
        return SPMV_SMALL, 1
    return SPMV_COLS, vec


def bsr_spmv_blocks(values, block_rowptr, block_colind,
                    x) -> torch.Tensor:
    """y = A @ x over raw BSR arrays of one real dtype; x is read in
    place, as zeros past its end (it may stop short of the last block
    column); returns (mb * bh,).  CUDA tensors launch ``bsr_spmv.cu`` in
    the mapping :func:`spmv_mapping` picks; CPU tensors take
    :func:`bsr_spmv_reference`."""
    _check_operands(values, block_rowptr, block_colind, x, 1)
    if not _t.on_cuda(values):
        return bsr_spmv_reference(values, block_rowptr, block_colind, x)
    _, bh, bw = values.shape
    mb = int(block_rowptr.shape[0]) - 1
    y = torch.empty(mb * bh, dtype=values.dtype, device=values.device)
    mapping, vec = spmv_mapping(bh, bw, values.element_size(),
                                _aligned(values, x))
    stream = torch.cuda.current_stream(values.device).cuda_stream
    sym = f"bsr_spmv_{_suffix(values.dtype)}"
    _build.check(_build.function("bsr_spmv", sym, _SPMV_ARGTYPES)(
        values.data_ptr(), block_rowptr.data_ptr(), block_colind.data_ptr(),
        x.data_ptr(), y.data_ptr(), mb, bh, bw, int(x.shape[0]), mapping,
        vec, stream), "bsr_spmv")
    bsr_spmv_blocks.launches += 1
    return y


bsr_spmv_blocks.launches = 0


def bsr_spmm_blocks(values, block_rowptr, block_colind, b,
                    column_order=None, tc=True, amax=None) -> torch.Tensor:
    """C = A @ B over raw BSR arrays of one real dtype and a row-major B;
    returns (mb * bh, k).  CUDA tensors launch ``bsr_spmm.cu`` (f32: its
    two tensor-core passes over the column list ``column_order``, from
    ``BSR.column_order`` or built here, cut past the scratch budget, then
    the FMA kernel gated by the call's flag, which the passes raise where
    a B value fails the test against ``types.tf32_b_limit(amax)``;
    ``amax`` is the blocks' largest magnitude, ``BSR.tf32_amax``, required
    there; with ``tc`` False, or f64: one FMA launch); CPU tensors take
    :func:`bsr_spmm_reference`.  ``launches`` counts the kernel launches
    but the gated one, which ``gated`` counts; the flag of the last call
    stays readable as ``bsr_spmm_blocks.flag``, the path it took."""
    _check_operands(values, block_rowptr, block_colind, b, 2)
    if not _t.on_cuda(values):
        return bsr_spmm_reference(values, block_rowptr, block_colind, b)
    if tc and values.dtype == torch.float32 and amax is None:
        raise ValueError("bsr_spmm: amax, the blocks' largest magnitude "
                         "(BSR.tf32_amax), is required on the tensor cores")
    cap, bh, bw = values.shape
    mb = int(block_rowptr.shape[0]) - 1
    k = int(b.shape[1])
    c = torch.empty(mb * bh, k, dtype=values.dtype, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    if values.dtype == torch.float64 or not tc:
        _build.check(_build.function("bsr_spmm",
                                     f"bsr_spmm_{_suffix(values.dtype)}"
                                     + ("" if tc else "_fma"),
                                     _SPMM_ARGTYPES)(
            values.data_ptr(), block_rowptr.data_ptr(),
            block_colind.data_ptr(), b.data_ptr(), c.data_ptr(), mb, bh, bw,
            k, 0, None, stream), "bsr_spmm")
        bsr_spmm_blocks.launches += 1
        return c
    lim = _t.tf32_b_limit(amax)
    flag = torch.zeros(1, dtype=torch.int32, device=values.device)
    ncb = -(-int(b.shape[0]) // max(bw, 1))
    col_ptr, col_order = (column_order if column_order is not None
                          else block_column_order(block_rowptr, block_colind,
                                                  ncb))
    cuts = spmm_phases(block_rowptr, block_colind, col_ptr, col_order, cap,
                       bh, k, ncb)
    # one scratch for every cut, each cut's slots from its start
    partial = torch.empty(max(max(int(co.shape[0]) * (p1 - p0)
                                  for *_, co, p0, p1 in cuts), 1)
                          * bh, dtype=torch.float32, device=values.device)
    vec = int(k % 4 == 0 and _aligned(b, c, partial))
    fn = _build.function("bsr_spmm", "bsr_spmm_f32", _SPMM_F32_ARGTYPES)
    for r0, r1, e0, rp, cp, co, p0, p1 in cuts:
        _build.check(fn(
            values[e0:].data_ptr(), rp.data_ptr(),
            cp.data_ptr(), co.data_ptr(), b.data_ptr() + 4 * p0,
            partial.data_ptr(), c.data_ptr() + 4 * (r0 * bh * k + p0),
            r1 - r0, int(cp.shape[0]) - 1, bh, bw, p1 - p0, k, k, vec,
            flag.data_ptr(), lim, stream), "bsr_spmm")
        bsr_spmm_blocks.launches += 2     # the products, then the row sums
    # the exact product, which runs only when the flag is up
    _build.check(_build.function("bsr_spmm", "bsr_spmm_f32_fma",
                                 _SPMM_ARGTYPES)(
        values.data_ptr(), block_rowptr.data_ptr(), block_colind.data_ptr(),
        b.data_ptr(), c.data_ptr(), mb, bh, bw, k, 0, flag.data_ptr(),
        stream), "bsr_spmm")
    bsr_spmm_blocks.gated += 1
    bsr_spmm_blocks.flag = flag
    return c


def spmm_phases(block_rowptr, block_colind, col_ptr, col_order, cap, bh,
                k, ncb, budget=None):
    """The cuts of one f32 SpMM call whose slot scratch would pass
    ``budget`` (default :data:`SPMM_SCRATCH_BYTES`): a list of (r0, r1,
    e0, rowptr, col_ptr, col_order, p0, p1), block rows [r0, r1) (their
    blocks from e0 on; ``rowptr`` and ``col_order`` count from e0) by
    columns [p0, p1) of B and C.  One cut, the whole call, when the ``cap`` slots fit; else
    column phases of the widest multiple of the 64-column k-tile that
    fits; else 64-column phases over ranges of block rows whose blocks
    fit.  Each cut's ``col_order`` keeps the call's order, so every slot
    and every row sum is the one the whole call would compute.  Raises
    where one block row's blocks alone pass the budget."""
    budget = SPMM_SCRATCH_BYTES if budget is None else budget
    mb = int(block_rowptr.shape[0]) - 1
    slot = bh * 4                          # bytes of one slot column
    if cap * slot * k <= budget:
        return [(0, mb, 0, block_rowptr, col_ptr, col_order, 0, k)]
    kp = budget // max(cap * slot, 1) // _SPMM_KTILE * _SPMM_KTILE
    cols = [(p0, min(k, p0 + max(kp, _SPMM_KTILE)))
            for p0 in range(0, k, max(kp, _SPMM_KTILE))]
    if kp >= _SPMM_KTILE:
        return [(0, mb, 0, block_rowptr, col_ptr, col_order, p0, p1)
                for p0, p1 in cols]
    width = min(k, _SPMM_KTILE)
    rp = block_rowptr.tolist()
    per_block = slot * width
    ranges, r0 = [], 0
    while r0 < mb:
        if (rp[r0 + 1] - rp[r0]) * per_block > budget:
            raise ValueError(
                f"bsr_spmm: block row {r0} holds {rp[r0 + 1] - rp[r0]} "
                f"blocks, past the {budget}-byte scratch budget at "
                f"{width} columns")
        r1 = r0 + 1
        while r1 < mb and (rp[r1 + 1] - rp[r0]) * per_block <= budget:
            r1 += 1
        ranges.append((r0, r1))
        r0 = r1
    dev = col_order.device
    out = []
    for r0, r1 in ranges:
        e0, e1 = rp[r0], rp[r1]
        keep = (col_order >= e0) & (col_order < e1)
        co = (col_order[keep] - e0).to(torch.int32)
        counts = torch.bincount(block_colind[co.long() + e0].long(),
                                minlength=ncb)[:ncb]
        cp = torch.zeros(ncb + 1, dtype=torch.int32, device=dev)
        cp[1:] = torch.cumsum(counts, 0)
        rpc = (block_rowptr[r0:r1 + 1] - e0).contiguous()
        out += [(r0, r1, e0, rpc, cp, co.contiguous(), p0, p1)
                for p0, p1 in cols]
    return out


bsr_spmm_blocks.launches = 0
bsr_spmm_blocks.gated = 0
bsr_spmm_blocks.flag = None


def _apply(fn, a: BSR, x: torch.Tensor) -> torch.Tensor:
    """fn over a's arrays and x in result_type(A, x): one call for real
    operands, real planes (up to four calls) for complex ones."""
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    rp, ci = a.block_rowptr, a.block_colind
    if not out_dtype.is_complex:
        dt = out_dtype if out_dtype in _KERNEL_DTYPES else torch.float32
        y = fn(a.values.to(dt).contiguous(), rp, ci, x.to(dt).contiguous())
        return y.to(out_dtype)
    real = torch.float64 if out_dtype == torch.complex128 else torch.float32

    def planes(t):
        if not t.is_complex():
            return t.to(real).contiguous(), None
        t = t.resolve_conj()
        return t.real.to(real).contiguous(), t.imag.to(real).contiguous()

    ar, ai = planes(a.values)
    xr, xi = planes(x)
    yr = fn(ar, rp, ci, xr)
    yi = fn(ar, rp, ci, xi) if xi is not None else torch.zeros_like(yr)
    if ai is not None:
        yi = yi + fn(ai, rp, ci, xr)
        if xi is not None:
            yr = yr - fn(ai, rp, ci, xi)
    return torch.complex(yr, yi).to(out_dtype)


def bsr_spmv(a: BSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with BSR A; returns (m,) in result_type(A, x)."""
    m, n = a.shape
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"bsr_spmv: A is {a.shape}, x is {tuple(x.shape)}")
    return _apply(bsr_spmv_blocks, a, x)


def bsr_spmm(a: BSR, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with BSR A and dense (n, k) B; returns (m, k) in
    result_type(A, B)."""
    m, n = a.shape
    if b.dim() != 2 or b.shape[0] != n:
        raise ValueError(f"bsr_spmm: A is {a.shape}, B is {tuple(b.shape)}")
    if not _t.on_cuda(a.values):
        return _apply(bsr_spmm_blocks, a, b)
    # the f32 kernel's column list, made once and kept on the BSR; blocks
    # with nonzero f32 entries below 2^-112, an infinity or a NaN
    # (a.tf32_exact False) take the FMA kernel, where the 3xTF32 split
    # would keep fewer bits; B is tested in the kernel against the blocks'
    # largest magnitude (csrc/tf32_mma.cuh, Limits)
    return _apply(functools.partial(bsr_spmm_blocks,
                                    column_order=a.column_order,
                                    tc=a.tf32_exact, amax=a.tf32_amax), a, b)

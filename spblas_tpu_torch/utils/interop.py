"""Interop with scipy.sparse and torch.sparse, and carrying state across
from the JAX package.

``from_scipy``/``to_scipy`` are the JAX package's; ``from_torch_sparse``
and ``to_torch_sparse`` take the place of its BCOO bridges
(``from_bcoo``/``to_bcoo``), with torch's sparse COO and CSR tensors on
the operand's device.

The JAX package's arrays, handed over as numpy (``np.asarray`` of its
containers and plans), become the port's objects on ``device`` bit for
bit: every plan that ``utils.serialize.load_plan`` returns has a loader
here.  With these, both packages run on the same matrix and the same
plan.
"""

from __future__ import annotations

import numpy as np
import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.convert import to_coo, to_csr
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.dcsr import DCSR
from spblas_tpu_torch.kernels.banded import BandPlan, PermutedBandPlan
from spblas_tpu_torch.kernels.bsr_spgemm import BsrSpgemmPlan
from spblas_tpu_torch.kernels.dia import DiaPlan
from spblas_tpu_torch.kernels.ell import EllPlan
from spblas_tpu_torch.kernels.plans import SortedRoutePlan
from spblas_tpu_torch.kernels.route2 import (SUBS, Route2MulPlan, Route2Plan,
                                             build_slab_work,
                                             build_solve_work)
from spblas_tpu_torch.kernels.route_mul import RouteMulPlan
from spblas_tpu_torch.kernels.route_mul_paned import (MulPanedPanel,
                                                      Route2MulPanedPlan)
from spblas_tpu_torch.kernels.route_paned import (CB, PanedPanel,
                                                  RoutePanedPlan)
from spblas_tpu_torch.kernels.route_plan import RoutePlan, fuse_levels


def from_scipy(a, capacity=None, device=None) -> CSR:
    """scipy.sparse matrix -> CSR container on ``device``."""
    a = a.tocsr()
    return CSR.from_arrays(a.data, a.indptr, a.indices, a.shape,
                           nnz=a.nnz, capacity=capacity, device=device)


def to_scipy(a):
    """Any container -> scipy.sparse.csr_matrix (its live entries, read
    to the host)."""
    import scipy.sparse as sps

    a = to_csr(a)
    nnz = int(a.nnz)
    m, n = a.shape
    return sps.csr_matrix(
        (_t.to_numpy(a.values)[:nnz], _t.to_numpy(a.colind)[:nnz],
         _t.to_numpy(a.rowptr)[: m + 1]), shape=(m, n))


def from_torch_sparse(t: torch.Tensor, capacity=None) -> CSR:
    """A rank-2 ``torch.sparse_coo`` or ``torch.sparse_csr`` tensor (no
    batch or dense dimensions) -> CSR on the tensor's device, its entries
    sorted by (row, col) and kept as they are (duplicates of an
    uncoalesced COO tensor stay two entries, as JAX's ``from_bcoo`` keeps
    BCOO's)."""
    if t.layout == torch.sparse_csr:
        crow, cols, vals = t.crow_indices(), t.col_indices(), t.values()
        rows = torch.repeat_interleave(
            torch.arange(t.shape[0], device=t.device),
            (crow[1:] - crow[:-1]).long())
    elif t.layout == torch.sparse_coo:
        if t.sparse_dim() != 2 or t.dense_dim() != 0:
            raise ValueError("only plain rank-2 sparse tensors (no batch "
                             "or dense dims)")
        idx, vals = t._indices(), t._values()
        rows, cols = idx[0], idx[1]
    else:
        raise ValueError(f"not a sparse COO or CSR tensor: {t.layout}")
    m, n = t.shape
    rows, cols = rows.long(), cols.long()
    order = torch.argsort(rows * n + cols, stable=True)
    rows, cols, vals = rows[order], cols[order], vals[order]
    rowptr = torch.zeros(m + 1, dtype=torch.int64, device=t.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return CSR.from_arrays(vals, rowptr, cols, (m, n), nnz=int(len(vals)),
                           capacity=capacity, device=t.device)


def to_torch_sparse(a, layout=torch.sparse_coo) -> torch.Tensor:
    """Any container -> a torch sparse tensor of ``layout`` (COO, as
    JAX's ``to_bcoo`` gives BCOO, or CSR) over its live entries, on the
    container's device."""
    if layout == torch.sparse_csr:
        c = to_csr(a)
        nnz = int(c.nnz)
        return torch.sparse_csr_tensor(
            c.rowptr[: c.shape[0] + 1].long(), c.colind[:nnz].long(),
            c.values[:nnz], size=c.shape)
    if layout != torch.sparse_coo:
        raise ValueError(f"layout must be sparse_coo or sparse_csr, got "
                         f"{layout}")
    coo = to_coo(a)
    nnz = int(coo.nnz)
    idx = torch.stack([coo.rowind[:nnz].long(), coo.colind[:nnz].long()])
    return torch.sparse_coo_tensor(idx, coo.values[:nnz], size=coo.shape)


def csr_from_numpy(values, rowptr, colind, nnz, shape,
                   device=None) -> CSR:
    """A CSR over the given arrays; their length is kept as the capacity
    (padding past ``nnz`` is made canonical)."""
    values = np.asarray(values)
    return CSR.from_arrays(values, np.asarray(rowptr), np.asarray(colind),
                           shape, nnz=int(nnz), capacity=len(values),
                           device=device)


def csc_from_numpy(values, colptr, rowind, nnz, shape, device=None) -> CSC:
    """A CSC over a JAX ``CSC``'s arrays; their length is kept as the
    capacity."""
    values = np.asarray(values)
    return CSC.from_arrays(values, np.asarray(colptr), np.asarray(rowind),
                           shape, nnz=int(nnz), capacity=len(values),
                           device=device)


def coo_from_numpy(values, rowind, colind, nnz, shape, device=None) -> COO:
    """A COO over a JAX ``COO``'s arrays; their length is kept as the
    capacity."""
    values = np.asarray(values)
    return COO.from_arrays(values, np.asarray(rowind), np.asarray(colind),
                           shape, nnz=int(nnz), capacity=len(values),
                           device=device)


def dcsr_from_numpy(values, colind, rowind, rowptr, nrows, nnz, shape,
                    device=None) -> DCSR:
    """A DCSR over a JAX ``DCSR``'s arrays (capacity and row capacity
    kept) and its ``nrows`` and ``nnz``."""
    dev = _t.resolve_device(device)
    return DCSR(values=_t.as_tensor(np.asarray(values), dev),
                colind=_t.as_tensor(np.asarray(colind), dev, _t.index_dtype),
                rowind=_t.as_tensor(np.asarray(rowind), dev, _t.index_dtype),
                rowptr=_t.as_tensor(np.asarray(rowptr), dev,
                                    _t.offset_dtype),
                nrows=int(nrows), nnz=int(nnz),
                shape=(int(shape[0]), int(shape[1])))


def ell_plan_from_numpy(values, cols, gather_idx, valid, shape,
                        device=None) -> EllPlan:
    """An EllPlan over a JAX one's (m_pad, W) arrays."""
    dev = _t.resolve_device(device)
    return EllPlan(values=_t.as_tensor(np.asarray(values), dev),
                   cols=_t.as_tensor(np.asarray(cols), dev, torch.int32),
                   gather_idx=_t.as_tensor(np.asarray(gather_idx), dev,
                                           torch.int32),
                   valid=_t.as_tensor(np.asarray(valid), dev, torch.bool),
                   shape=(int(shape[0]), int(shape[1])))


def bsr_from_numpy(values, block_rowptr, block_colind, nnz_blocks, shape,
                   block_shape, device=None) -> BSR:
    """A BSR over a JAX ``BSR``'s arrays (values (capacity, bh, bw),
    block_rowptr, block_colind) and its ``nnz_blocks``; the capacity is
    kept."""
    dev = _t.resolve_device(device)
    return BSR(values=_t.as_tensor(np.asarray(values), dev),
               block_rowptr=_t.as_tensor(np.asarray(block_rowptr), dev,
                                         _t.offset_dtype),
               block_colind=_t.as_tensor(np.asarray(block_colind), dev,
                                         _t.index_dtype),
               nnz_blocks=int(nnz_blocks),
               shape=(int(shape[0]), int(shape[1])),
               block_shape=(int(block_shape[0]), int(block_shape[1])))


def band_plan_from_numpy(panels, pad_l, shape, device=None) -> BandPlan:
    """A BandPlan over the JAX plan's panels (f32, or bfloat16 as
    ml_dtypes hands it over)."""
    dev = _t.resolve_device(device)
    return BandPlan(panels=_t.as_tensor(np.asarray(panels), dev),
                    pad_l=int(pad_l), shape=(int(shape[0]), int(shape[1])))


def permuted_band_plan_from_numpy(panels, pad_l, shape, perm, rank,
                                  device=None) -> PermutedBandPlan:
    """A PermutedBandPlan over a JAX one: its band plan's panels, pad_l
    and shape, and its padded perm and rank."""
    dev = _t.resolve_device(device)
    return PermutedBandPlan(
        band=band_plan_from_numpy(panels, pad_l, shape, device=dev),
        perm=_t.as_tensor(np.asarray(perm), dev, _t.index_dtype),
        rank=_t.as_tensor(np.asarray(rank), dev, _t.index_dtype))


def dia_plan_from_numpy(diags, offsets, shape, device=None) -> DiaPlan:
    """A DiaPlan over the JAX plan's (ndiag, rows_pad, 128) diagonals."""
    dev = _t.resolve_device(device)
    return DiaPlan(diags=_t.as_tensor(np.asarray(diags), dev),
                   offsets=tuple(int(o) for o in offsets),
                   shape=(int(shape[0]), int(shape[1])))


def route2_launch_starts(src_flag, slab_base, y_base, g: int,
                         row_window_mult: int) -> tuple:
    """Launch starts for a plan that carries none: the first flag-1 (aux)
    chunk, then, walking the aux chunks in order, every chunk whose slab
    rows [sb, sb + 8g) meet a window [yb, yb + 8*ww) written by a chunk
    of the current launch.  This can only split more than needed."""
    flags = np.asarray(src_flag)
    aux = np.flatnonzero(flags == 1)
    if not len(aux):
        return (0,)
    if (flags[aux[0]:] != 1).any():
        raise ValueError("chunks after the first aux chunk must be aux")
    sb = np.asarray(slab_base).astype(np.int64)
    yb = np.asarray(y_base).astype(np.int64)
    slab, win = SUBS * g, SUBS * row_window_mult
    rows = int(max((sb[aux] + slab).max(), (yb[aux] + win).max()))
    written = np.zeros(rows, bool)
    touched = []
    starts = [0, int(aux[0])]
    for k in aux:
        if written[sb[k]:sb[k] + slab].any():
            starts.append(int(k))
            for lo in touched:
                written[lo:lo + win] = False
            touched = []
        written[yb[k]:yb[k] + win] = True
        touched.append(yb[k])
    return tuple(starts)


def route2_plan_from_numpy(arrays: dict, static: dict,
                           device=None) -> Route2Plan:
    """A Route2Plan over a JAX ``Route2Plan``'s arrays (as numpy, keyed
    by field name: tile, val, slab_base, y_base, src_flag, val_src,
    ext_cols and rho, None when not rotated) and its static fields (g,
    shape, nat_slots, x_rows, y_rows, aux_rows, n_aux_chunks, fill,
    dist_max, any_lane, row_window_mult, has_hub, rotated).  The carried
    plan records no aux or dependency levels, so its launch starts come
    from :func:`route2_launch_starts`; for a solve plan (every chunk
    flag 1) they split wherever a chunk's slab meets a window the
    current launch writes, more launch ranges than the builder's levels,
    and the persistent solve's work list is built over them."""
    dev = _t.resolve_device(device)
    put = {k: (None if v is None else _t.as_tensor(np.asarray(v), dev))
           for k, v in arrays.items()}
    static = dict(static)
    static["shape"] = (int(static["shape"][0]), int(static["shape"][1]))
    starts = route2_launch_starts(
        arrays["src_flag"], arrays["slab_base"], arrays["y_base"],
        int(static["g"]), int(static.get("row_window_mult", 1)))
    # a solve plan (every chunk reads the pane it publishes into) also
    # gets the persistent solve's work list over those starts
    solve = bool(len(arrays["src_flag"])) and bool(
        (np.asarray(arrays["src_flag"]) == 1).all())
    return Route2Plan(**put, **static, launch_starts=starts,
                      slab_work=build_slab_work(arrays["slab_base"], starts,
                                                dev),
                      solve_work=build_solve_work(
                          starts, len(arrays["src_flag"]), dev)
                      if solve else None)


def route_mul_plan_from_numpy(arrays: dict, static: dict,
                              device=None) -> RouteMulPlan:
    """A RouteMulPlan over a JAX one's arrays (as numpy, keyed by field
    name: tile1, tile2, tile3, a_base, b_base, o_base) and its static
    fields (g_a, g_b, a_rows, b_rows, out_rows, capacity, fill).  It has
    no expansion stream (``expansion`` None), so the CUDA numeric, the
    slot fill over that stream, refuses it; the CPU walks its tiles."""
    dev = _t.resolve_device(device)
    return RouteMulPlan(
        **{k: _t.as_tensor(np.asarray(v), dev) for k, v in arrays.items()},
        **static)


def route_plan_from_numpy(arrays: dict, static: dict,
                          device=None) -> RoutePlan:
    """A RoutePlan over a JAX ``RoutePlan``'s arrays (as numpy, keyed by
    field name: tile1, tile3, val, slab_base, y_base, val_src, hot_cols,
    and aux_plan, the aux plan's own (arrays, static) pair or None) and
    its static fields (g, shape, x_rows, y_rows, aux_len, n_pad, fill).
    The one-launch layout (rebased bases, ``V1Layout``) is derived as the
    builder derives it (``route_plan.fuse_levels``)."""
    return fuse_levels(_route_level_from_numpy(arrays, static,
                                               _t.resolve_device(device)))


def _route_level_from_numpy(arrays: dict, static: dict, dev) -> RoutePlan:
    arrays = dict(arrays)
    aux = arrays.pop("aux_plan")
    put = {k: _t.as_tensor(np.asarray(v), dev) for k, v in arrays.items()}
    static = dict(static)
    static["shape"] = (int(static["shape"][0]), int(static["shape"][1]))
    return RoutePlan(
        **put, **static,
        aux_plan=None if aux is None else _route_level_from_numpy(*aux, dev))


def sorted_route_plan_from_numpy(base: tuple, unperm: tuple, entry_perm,
                                 device=None) -> SortedRoutePlan:
    """A SortedRoutePlan over a JAX one: ``base`` the (arrays, static)
    pair of its ROUTE v1 plan, ``unperm`` that of its ROUTE2 un-permute
    plan, ``entry_perm`` its entry permutation."""
    dev = _t.resolve_device(device)
    return SortedRoutePlan(
        base=route_plan_from_numpy(*base, device=dev),
        unperm=route2_plan_from_numpy(*unperm, device=dev),
        entry_perm=_t.as_tensor(np.asarray(entry_perm), dev))


def paned_chunk_panes(fl, eva, evb, evs) -> np.ndarray:
    """The x pane each chunk of a carried paned panel reads: group k
    (chunks [8k, 8k + 8)) reads buffer slot ``evs[k]``, which holds the
    last pane started into it (``eva``/``evb`` = pane * 2 + slot) at or
    before group k; aux and pad chunks get 0."""
    in_slot = [0, 0]
    group_pane = np.zeros(len(evs), np.int32)
    for k, (a, b, s) in enumerate(zip(np.asarray(eva), np.asarray(evb),
                                      np.asarray(evs))):
        for ev in (a, b):
            if ev >= 0:
                in_slot[ev & 1] = ev >> 1
        group_pane[k] = in_slot[s]
    return np.where(np.asarray(fl) == 0, np.repeat(group_pane, CB),
                    0).astype(np.int32)


def route_paned_plan_from_numpy(panels: list, static: dict, device=None
                                ) -> RoutePanedPlan:
    """A RoutePanedPlan over a JAX one: ``panels`` one (arrays, static)
    pair per panel (tile, val, sb, yb, fl, eva, evb, evw, evs, src_pos,
    src_idx, rho; rows, out_rows, has_aux, dist_max, any_lane, rotated),
    ``static`` the plan's (shape, g, pane_rows, x_rows_pad, fill,
    row_window_mult).  The per-chunk pane comes from the event streams
    (:func:`paned_chunk_panes`) and the launch starts conservatively from
    :func:`route2_launch_starts`."""
    dev = _t.resolve_device(device)
    static = dict(static)
    static["shape"] = (int(static["shape"][0]), int(static["shape"][1]))
    out = []
    for arrays, pstatic in panels:
        a = {k: np.asarray(v) for k, v in arrays.items()}
        a["pane"] = paned_chunk_panes(a["fl"], a["eva"], a["evb"], a["evs"])
        starts = route2_launch_starts(a["fl"], a["sb"], a["yb"],
                                      int(static["g"]),
                                      int(static["row_window_mult"]))
        out.append(PanedPanel(
            **{k: _t.as_tensor(v, dev) for k, v in a.items()}, **pstatic,
            launch_starts=tuple(sorted(set(starts)))))
    return RoutePanedPlan(panels=tuple(out), **static)


def route2_mul_plan_from_numpy(arrays: dict, static: dict,
                               device=None) -> Route2MulPlan:
    """A Route2MulPlan over a JAX one's arrays (as numpy, keyed by field
    name: tile1, tile2, a_base, b_base, src_flag, y_base) and its static
    fields (g_a, g_b, a_rows, b_rows, y_rows, aux_rows, n_aux_chunks,
    capacity, fill, dist_max).  The carried plan records no aux levels,
    so its launch starts come from :func:`route2_launch_starts` over the
    B-side slabs (8 * g_b rows) and the 8-row out windows.  It has no
    expansion stream (``expansion`` None), so the CUDA numeric, the slot
    fill over that stream, refuses it; the CPU walks its tiles."""
    dev = _t.resolve_device(device)
    starts = route2_launch_starts(arrays["src_flag"], arrays["b_base"],
                                  arrays["y_base"], int(static["g_b"]), 1)
    return Route2MulPlan(
        **{k: _t.as_tensor(np.asarray(v), dev) for k, v in arrays.items()},
        **static, launch_starts=starts)


def route2_mul_paned_plan_from_numpy(panels: list, static: dict,
                                     device=None) -> Route2MulPanedPlan:
    """A Route2MulPanedPlan over a JAX one: ``panels`` one (arrays,
    static) pair per panel (t1, t2, ab, bb, yb, fl, eva, evb, evw, evs;
    slots, out_rows, has_aux, dist_max), ``static`` the plan's (g_a, g_b,
    a_rows, b_rows_pad, pane_rows, capacity, fill).  Each chunk's B pane
    comes from the event streams (:func:`paned_chunk_panes`) and the
    launch starts conservatively from :func:`route2_launch_starts`."""
    dev = _t.resolve_device(device)
    out = []
    for arrays, pstatic in panels:
        a = {k: np.asarray(v) for k, v in arrays.items()}
        a["pane"] = paned_chunk_panes(a["fl"], a["eva"], a["evb"], a["evs"])
        starts = route2_launch_starts(a["fl"], a["bb"], a["yb"],
                                      int(static["g_b"]), 1)
        out.append(MulPanedPanel(
            **{k: _t.as_tensor(v, dev) for k, v in a.items()}, **pstatic,
            launch_starts=tuple(sorted(set(starts)))))
    return Route2MulPanedPlan(panels=tuple(out), **static)


def bsr_spgemm_plan_from_numpy(pair_ptr, pair_a, pair_b, c_rowptr,
                               c_colind, shape, block_shape,
                               device=None) -> BsrSpgemmPlan:
    """A BsrSpgemmPlan over a JAX one's pair lists and C structure."""
    dev = _t.resolve_device(device)
    return BsrSpgemmPlan(
        pair_ptr=_t.as_tensor(np.asarray(pair_ptr), dev, torch.int32),
        pair_a=_t.as_tensor(np.asarray(pair_a), dev, torch.int32),
        pair_b=_t.as_tensor(np.asarray(pair_b), dev, torch.int32),
        c_rowptr=_t.as_tensor(np.asarray(c_rowptr), dev, _t.offset_dtype),
        c_colind=_t.as_tensor(np.asarray(c_colind), dev, _t.index_dtype),
        shape=(int(shape[0]), int(shape[1])),
        block_shape=(int(block_shape[0]), int(block_shape[1])))


def trsv_plan_from_numpy(arrays: dict, static: dict, route=None,
                         device=None):
    """A TrsvPlan over a JAX one's arrays (as numpy, keyed by field name:
    ent_idx, ent_col, ent_slot, lv_estart, row_ids, diag_idx, lv_rstart,
    and where it has a route, route_diag, route_vals_ref, route_dpe), its
    static fields (e_cap, r_cap, uplo, unit_diag, m) and its ROUTE2 solve
    plan ``route`` (a port plan, or None).  The host level offsets are
    derived from the arrays; the values token does not survive the trip,
    so a routed solve re-bakes its values (``route_dpe``)."""
    from spblas_tpu_torch.ops.triangular_solve import TrsvPlan
    dev = _t.resolve_device(device)
    put = {k: None if v is None else _t.as_tensor(np.asarray(v), dev)
           for k, v in arrays.items()}
    return TrsvPlan(
        **put, **static, route=route,
        lv_estart_host=np.asarray(arrays["lv_estart"]).astype(np.int64),
        lv_rstart_host=np.asarray(arrays["lv_rstart"]).astype(np.int64))


def spgemm_plan_from_numpy(arrays: dict, static: dict, route=None,
                           device=None):
    """A SpgemmPlan over a JAX one's arrays (src_a, src_b, is_d, valid,
    slot, c_rowptr, c_colind, and c_nnz, a 0-d array held here as a host
    int), its static fields (shape, has_d, a_capacity, b_capacity,
    d_capacity) and its mul engine plan ``route`` (a port plan, or
    None)."""
    from spblas_tpu_torch.ops.spgemm import SpgemmPlan
    dev = _t.resolve_device(device)
    arrays = dict(arrays)
    c_nnz = int(np.asarray(arrays.pop("c_nnz")))
    static = dict(static)
    static["shape"] = (int(static["shape"][0]), int(static["shape"][1]))
    return SpgemmPlan(
        **{k: _t.as_tensor(np.asarray(v), dev) for k, v in arrays.items()},
        c_nnz=c_nnz, **static, route=route)

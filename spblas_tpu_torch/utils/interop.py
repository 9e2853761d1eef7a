"""Carrying state across from the JAX package.

The JAX package's arrays, handed over as numpy (``np.asarray`` of its
containers and plans), become the port's objects on ``device`` bit for
bit.  With these, both packages run on the same matrix and the same plan.
"""

from __future__ import annotations

import numpy as np

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.kernels.banded import BandPlan
from spblas_tpu_torch.kernels.dia import DiaPlan
from spblas_tpu_torch.kernels.route2 import SUBS, Route2Plan


def csr_from_numpy(values, rowptr, colind, nnz, shape,
                   device=None) -> CSR:
    """A CSR over the given arrays; their length is kept as the capacity
    (padding past ``nnz`` is made canonical)."""
    values = np.asarray(values)
    return CSR.from_arrays(values, np.asarray(rowptr), np.asarray(colind),
                           shape, nnz=int(nnz), capacity=len(values),
                           device=device)


def band_plan_from_numpy(panels, pad_l, shape, device=None) -> BandPlan:
    """A BandPlan over the JAX plan's panels (f32, or bfloat16 as
    ml_dtypes hands it over)."""
    dev = _t.resolve_device(device)
    return BandPlan(panels=_t.as_tensor(np.asarray(panels), dev),
                    pad_l=int(pad_l), shape=(int(shape[0]), int(shape[1])))


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
    plan records no aux levels, so its launch starts come from
    :func:`route2_launch_starts`."""
    dev = _t.resolve_device(device)
    put = {k: (None if v is None else _t.as_tensor(np.asarray(v), dev))
           for k, v in arrays.items()}
    static = dict(static)
    static["shape"] = (int(static["shape"][0]), int(static["shape"][1]))
    starts = route2_launch_starts(
        arrays["src_flag"], arrays["slab_base"], arrays["y_base"],
        int(static["g"]), int(static.get("row_window_mult", 1)))
    return Route2Plan(**put, **static, launch_starts=starts)

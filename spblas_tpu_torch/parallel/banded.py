"""Distributed band SpMV and SpMM: a halo exchange, then the band kernels
on each rank — counterpart of ``spblas_tpu/parallel/banded.py``.

Rank d's rows of a banded matrix touch only the columns
[d*mloc - h, (d+1)*mloc + h), so a multiply moves only the h-wide edges
of x (or B) between ring neighbours: a non-cyclic ``ppermute`` each
way, rank 0 getting a zero left edge and rank p-1 a zero right edge, as
zero padding gives the single-card kernel.  Each rank then runs the
port's panel kernels over [left | local | right]: ``band_spmv_padded``
(``csrc/band_spmv.cu``) for x and the resident ``band_spmm_padded``
(``csrc/band_spmm.cu``) for B, one launch a rank a call.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.formats.csr import host_arrays
from spblas_tpu_torch.kernels import banded as _bk
from spblas_tpu_torch.parallel.dist_csr import rank_rows
from spblas_tpu_torch.parallel.mesh import RowMesh, check_mesh_matches

_R, _G = _bk._R, _bk._G


@dataclasses.dataclass(frozen=True)
class DistBandPlan:
    """This rank's panels (nblk_loc*128, w) = ``panels[rank]`` of the JAX
    plan: panel block i covers global rows rank*mloc + [i*128, (i+1)*128)
    and global columns rank*mloc + i*128 + [-h, 128+h)."""

    panels: torch.Tensor
    h: int
    mloc: int
    shape: Tuple[int, int]
    p: int
    rank: int

    @property
    def width(self) -> int:
        return int(self.panels.shape[1])


def partition_band(a, mesh: RowMesh) -> DistBandPlan:
    """Host inspect: this rank's dense panels of a banded square matrix
    (the distributed ``build_band_plan``)."""
    a = to_csr(a)
    m, n = a.shape
    if m != n:
        raise ValueError("distributed band requires a square matrix")
    p, d = mesh.size, mesh.rank
    h = _bk.band_halfwidth(a)
    mloc = -(-m // p)
    mloc = -(-mloc // (_G * _R)) * (_G * _R)   # one block count a rank
    if h > mloc:
        raise ValueError(
            f"band half-width {h} exceeds local rows {mloc}; "
            "use fewer devices or the general DistCSR path")
    w = -(-(_R + 2 * h) // 8) * 8
    nblk = mloc // _R
    rows, cols, vals = host_arrays(a)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    dev = rows // mloc
    r_loc = rows % mloc
    # panel-local column: global col - (dev*mloc + blk*128 - h)
    c_loc = cols - dev * mloc - (r_loc // _R) * _R + h
    if not ((c_loc >= 0) & (c_loc < w)).all():
        raise ValueError("entry outside band window")
    own = dev == d
    panels = np.zeros((nblk * _R, w), dtype=vals.dtype)
    panels[r_loc[own], c_loc[own]] = vals[own]
    return DistBandPlan(panels=torch.from_numpy(panels).to(mesh.device),
                        h=h, mloc=mloc, shape=(m, n), p=p, rank=d)


def halo_window(plan: DistBandPlan, xl: torch.Tensor,
                mesh: RowMesh) -> torch.Tensor:
    """[left | local | right] zero-padded to the panel sweep's rows: the
    left edge is the previous rank's last h rows, the right edge the
    next rank's first h (zeros at the ends of the ring)."""
    p, mloc, h = plan.p, plan.mloc, plan.h
    if h:
        # both edges in flight at once: rank i sends its tail right and
        # its head left
        left = mesh.ppermute(xl[mloc - h:], [(i, i + 1)
                                             for i in range(p - 1)],
                             async_op=True)
        right = mesh.ppermute(xl[:h], [(i + 1, i) for i in range(p - 1)],
                              async_op=True)
        xwin = torch.cat([left.wait(), xl, right.wait()])
    else:
        xwin = xl
    tail = plan.panels.shape[0] + plan.width - _R
    pad = [0, 0] * (xl.dim() - 1) + [0, tail - xwin.shape[0]]
    return F.pad(xwin.float(), pad).contiguous()


def _check(plan: DistBandPlan, xl: torch.Tensor, mesh: RowMesh,
           what: str) -> None:
    check_mesh_matches(plan.p, mesh, what, rank=plan.rank)
    if xl.shape[0] != plan.mloc:
        raise ValueError(
            f"{what}: operand rows {xl.shape[0]} != local {plan.mloc}; "
            "use partition_band_vector")


def dist_band_spmv(plan: DistBandPlan, x: torch.Tensor, mesh: RowMesh
                   ) -> torch.Tensor:
    """y = A @ x with x this rank's (mloc,) piece; returns its (mloc,)
    piece of y: the halo exchange, then one ``band_spmv_padded``."""
    _check(plan, x, mesh, "dist_band_spmv")
    y = _bk.band_spmv_padded(plan.panels, halo_window(plan, x, mesh))
    return y.to(torch.promote_types(plan.panels.dtype, x.dtype))


def dist_band_spmm(plan: DistBandPlan, b: torch.Tensor, mesh: RowMesh
                   ) -> torch.Tensor:
    """C = A @ B with B this rank's (mloc, k) rows: the (h, k) edges
    exchanged, then one resident ``band_spmm_padded``."""
    _check(plan, b, mesh, "dist_band_spmm")
    c = _bk.band_spmm_padded(plan.panels, halo_window(plan, b, mesh))
    return c.to(torch.promote_types(plan.panels.dtype, b.dtype))


def partition_band_vector(x, plan: DistBandPlan, mesh: RowMesh
                          ) -> torch.Tensor:
    """This rank's rows of x (or B) padded to p*mloc."""
    return rank_rows(x, plan.p * plan.mloc, plan.mloc, mesh.rank,
                     mesh.device)

"""Distributed two-phase SpGEMM: C = A @ B over row-partitioned operands —
counterpart of ``spblas_tpu/parallel/spgemm.py``.

The symbolic phase runs once on the host: each rank expands and sorts
its own C row block (Gustavson) into gather maps over its A block and
the all-gathered B values, the ranks agreeing on the common capacities
by a MAX all-reduce.  The numeric phase re-runs with new values of the
same sparsity: one all-gather of B's values (the structure is in the
plan; only values move), then each rank fills its own C block.

The numeric engine (``DistMulEngine`` in the JAX package, each rank's
:class:`~spblas_tpu_torch.kernels.route_mul_paned.Route2MulPanedPlan`
here) is the single-card paned mul plan of the rank's expansion stream,
in the JAX engine's lockstep geometry: common (g_a, g_b, pane rows,
panel grid), each panel's chunk streams padded to the largest rank's
with flag-1 zero groups, every array bit-equal to ``[rank]`` of the
stacked JAX engine.  On the card a numeric is one launch of the slot
fill ``csrc/mul_fill.cu`` over the rank's whole expansion stream
(``route_mul_paned.route2_mul_paned``, as on one card; the panels cut
only the tiles, which the card does not read); on the CPU the plain tile
walker runs panel by panel.  Each rank's stream owns its hub counters.
Without an engine the numeric is gather·mul·``index_add`` as torch ops.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from spblas_tpu_torch import native
from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.kernels import route_mul_paned as _rmp
from spblas_tpu_torch.kernels.route2 import LANES, SLOTS, mul_pane_g
from spblas_tpu_torch.parallel.mesh import RowMesh, check_mesh_matches
from spblas_tpu_torch.parallel.rowblock import RowBlockCSR, \
    partition_rowblock
from spblas_tpu_torch.utils.profiling import record_phase


@dataclasses.dataclass(frozen=True)
class DistSpgemmPlan:
    """This rank's numeric plan: ``[rank]`` of the JAX plan's arrays.

    For stream entry s (sorted by (local row, col)): src_a (scap,) the
    local A entry; src_b (scap,) the index into the flattened
    all-gathered B values; valid (scap,); slot (scap,) the local C slot
    (ccap: dropped).  C structure: c_rowptr (mloc+1,), c_colind (ccap,)
    global columns, c_nnz this block's live entries and result_nnz every
    block's (host ints).  ``engine``: the rank's paned mul plan, or None
    for the torch numeric."""

    src_a: torch.Tensor
    src_b: torch.Tensor
    valid: torch.Tensor
    slot: torch.Tensor
    c_rowptr: torch.Tensor
    c_colind: torch.Tensor
    c_nnz: int
    result_nnz: int
    shape: Tuple[int, int]
    mloc: int
    p: int
    rank: int
    engine: Optional[_rmp.Route2MulPanedPlan] = None

    @property
    def c_capacity(self) -> int:
        return int(self.c_colind.shape[0])


def _engine_gate(dtype) -> bool:
    """The engine builds on the card; on the CPU only under
    ``SPBLAS_FORCE_ROUTE_SPGEMM`` (its fills then walk the tiles), never
    under ``SPBLAS_NO_ROUTE_SPGEMM``, and for f32 values only."""
    if os.environ.get("SPBLAS_NO_ROUTE_SPGEMM") == "1":
        return False
    return np.dtype(dtype) == np.float32


def _build_engine(mesh: RowMesh, own, lcap_a: int, b_len_flat: int,
                  ccap: int, dtype) -> Optional[_rmp.Route2MulPanedPlan]:
    """This rank's paned mul plan when every rank's operands fit the
    single-card engine's envelope (the gates of ``ops/spgemm``, applied
    to every rank's stream: the ranks agree through all-reduces)."""
    from spblas_tpu_torch.ops.spgemm import _PANED_A_ROWS_MAX
    if not (mesh.device.type == "cuda"
            or os.environ.get("SPBLAS_FORCE_ROUTE_SPGEMM")):
        return None
    if not _engine_gate(dtype):
        return None
    a_len = lcap_a + 1              # + the aux constant-1 slot
    a_rows = -(-a_len // LANES)
    if a_rows > _PANED_A_ROWS_MAX:
        return None
    sa, sb, slots = own[0], own[1], own[2]
    g_b = mul_pane_g(b_len_flat)
    win_b = g_b * SLOTS
    est = 0
    if len(slots):
        cellkey = ((slots.astype(np.int64) >> 10)
                   * (b_len_flat // win_b + 2) + sb.astype(np.int64) // win_b)
        sk = native.argsort_i64(cellkey)[1]
        est = 1 + int(np.count_nonzero(np.diff(sk)))
    (longest,) = mesh.reduce_ints([len(sa)], "max")
    (est_total,) = mesh.reduce_ints([est], "sum")
    if longest > int(os.environ.get("SPBLAS_MUL_EXPANSION_BUDGET",
                                    64_000_000)):
        return None
    if est_total > int(os.environ.get("SPBLAS_MUL_CHUNK_BUDGET", 400_000)):
        return None

    t0 = time.perf_counter()
    # lockstep panel grid: every rank cuts the same slot panels, all
    # halve the panel when any rank's pack passes the dispatch budget,
    # and each panel's geometry is the largest rank's
    plan = _rmp.build_route2_mul_paned_plan(
        slots, sa, sb, a_len, b_len_flat, ccap,
        panel_slots=int(os.environ.get("SPBLAS_DIST_MUL_PANEL_SLOTS",
                                       _rmp._PANEL_SLOTS)),
        device=mesh.device,
        agree=lambda values: mesh.reduce_ints(values, "max"))
    record_phase("dist_spgemm", "host_pack_s", time.perf_counter() - t0)
    return plan


def dist_spgemm_compute(a: RowBlockCSR, b: RowBlockCSR, mesh: RowMesh,
                        reuse: bool = True) -> DistSpgemmPlan:
    """Host symbolic phase: this rank's expansion and sort, as gather
    maps; ``result_nnz`` is known on return.  With ``reuse`` (and on the
    card, or under ``SPBLAS_FORCE_ROUTE_SPGEMM``) it also builds the
    rank's paned mul engine."""
    p = a.p
    check_mesh_matches(p, mesh, "dist_spgemm_compute", rank=a.rank)
    if b.p != p:
        raise ValueError(
            f"dist_spgemm: a partitioned for p={p} but b for p={b.p}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"spgemm dimension mismatch: A is {a.shape}, B is {b.shape}")
    mloc, lcap_b, nloc_b = a.mloc, b.local_capacity, b.mloc

    # B's structure on every rank: one all-gather of each index array
    b_cols = _t.to_numpy(mesh.all_gather(b.colind)).astype(np.int64)
    b_rptr = _t.to_numpy(mesh.all_gather(b.rowptr)).astype(np.int64)
    # global B row -> (start, len) in the flattened gathered values
    kk = np.arange(k2)
    bd, bi = kk // nloc_b, kk % nloc_b
    b_start = bd * lcap_b + b_rptr[bd, bi]
    b_len = b_rptr[bd, bi + 1] - b_rptr[bd, bi]

    d = a.rank
    r1 = max(0, min((d + 1) * mloc, m) - min(d * mloc, m))
    a_rptr = _t.to_numpy(a.rowptr).astype(np.int64)
    nnz_d = int(a_rptr[r1]) if r1 > 0 else 0
    cols_d = _t.to_numpy(a.colind[:nnz_d]).astype(np.int64)
    rows_d = np.repeat(np.arange(r1), np.diff(a_rptr[: r1 + 1]))
    # expansion: every (i, k) A entry times every entry of B row k
    counts = b_len[cols_d]
    e_total = int(counts.sum())
    src_a = np.repeat(np.arange(nnz_d), counts)
    local = np.arange(e_total) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    src_b = np.repeat(b_start[cols_d], counts) + local
    rows_e = np.repeat(rows_d, counts)
    cols_e = b_cols.reshape(-1)[src_b] if e_total else np.zeros(0, np.int64)
    if mloc * n < (1 << 62):
        order = native.argsort_i64(rows_e * np.int64(n) + cols_e)[0]
    else:
        order = np.lexsort((cols_e, rows_e))
    rows_s, cols_s = rows_e[order], cols_e[order]
    heads = np.concatenate([[True], (rows_s[1:] != rows_s[:-1])
                            | (cols_s[1:] != cols_s[:-1])]) \
        if e_total else np.zeros(0, bool)
    slots = np.cumsum(heads) - 1
    nnz_c = int(heads.sum())
    c_rptr = np.zeros(mloc + 1, dtype=np.int64)
    np.add.at(c_rptr[1:], rows_s[heads], 1)
    sa_s, sb_s = src_a[order], src_b[order]

    scap, ccap, sb_max = mesh.reduce_ints(
        [e_total, nnz_c, int(sb_s.max()) if e_total else 0], "max")
    (result_nnz,) = mesh.reduce_ints([nnz_c], "sum")
    scap = _t.quantize_capacity(max(scap, 1))
    ccap = _t.quantize_capacity(max(ccap, 1))
    # src_b indexes the flattened gathered B values (p * lcap_b
    # entries): that space can pass int32 where each matrix does not
    if sb_max >= 2 ** 31:
        raise ValueError(
            f"dist_spgemm: flattened B index space {sb_max + 1} exceeds "
            "int32; reduce per-device B capacity or the device count")

    def padded(arr, cap, fill, dtype):
        out = np.full(cap, fill, dtype)
        out[: len(arr)] = arr
        return torch.from_numpy(out).to(mesh.device)

    engine = None
    if reuse:
        t0 = time.perf_counter()
        engine = _build_engine(
            mesh, (sa_s, sb_s, slots), a.local_capacity, p * lcap_b, ccap,
            np.result_type(_t.to_numpy(a.values[:1]).dtype,
                           _t.to_numpy(b.values[:1]).dtype))
        record_phase("dist_spgemm", "engine_build_s",
                     time.perf_counter() - t0)
    return DistSpgemmPlan(
        src_a=padded(sa_s, scap, 0, np.int32),
        src_b=padded(sb_s, scap, 0, np.int32),
        valid=padded(np.ones(e_total, bool), scap, False, bool),
        slot=padded(slots, scap, ccap, np.int32),
        c_rowptr=torch.from_numpy(np.cumsum(c_rptr).astype(np.int32)).to(
            mesh.device),
        c_colind=padded(cols_s[heads], ccap, 0, np.int32),
        c_nnz=nnz_c, result_nnz=result_nnz, shape=(m, n), mloc=mloc, p=p,
        rank=d, engine=engine)


def dist_spgemm_numeric(plan: DistSpgemmPlan, a: RowBlockCSR,
                        b: RowBlockCSR, mesh: RowMesh) -> RowBlockCSR:
    """Distributed numeric phase, re-runnable with new values of the same
    sparsity: one all-gather of B's values, then this rank's C block by
    its engine (f32 operands) or by the torch numeric."""
    check_mesh_matches(plan.p, mesh, "dist_spgemm_numeric", rank=plan.rank)
    bg = mesh.all_gather(b.values).reshape(-1)
    if plan.engine is not None and a.dtype == b.dtype == torch.float32:
        a_arr = torch.cat([a.values, a.values.new_ones(1)])
        c_values = _rmp.route2_mul_paned(plan.engine, a_arr, bg)
    else:
        # a non-f32 fill would be truncated by the f32 engine
        if mesh.device.type == "cuda":
            warnings.warn(
                "dist_spgemm_numeric: the torch gather/index_add numeric; "
                "f32 operands with dist_spgemm_compute(..., reuse=True) "
                "run the slot fill kernel", UserWarning, stacklevel=2)
        v = a.values[plan.src_a.long()] * bg[plan.src_b.long()]
        v = torch.where(plan.valid, v, torch.zeros_like(v))
        c_values = v.new_zeros(plan.c_capacity + 1).index_add_(
            0, plan.slot.long(), v)[: plan.c_capacity]
    return RowBlockCSR(values=c_values, colind=plan.c_colind,
                       rowptr=plan.c_rowptr, nnz=plan.c_nnz,
                       shape=plan.shape, mloc=plan.mloc, p=plan.p,
                       rank=plan.rank)


def dist_spgemm(a, b, mesh: RowMesh) -> RowBlockCSR:
    """One-shot distributed C = A @ B from global or partitioned
    operands."""
    if not isinstance(a, RowBlockCSR):
        a = partition_rowblock(to_csr(a), mesh)
    if not isinstance(b, RowBlockCSR):
        b = partition_rowblock(to_csr(b), mesh)
    plan = dist_spgemm_compute(a, b, mesh, reuse=False)
    return dist_spgemm_numeric(plan, a, b, mesh)

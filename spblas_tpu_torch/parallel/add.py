"""Distributed SpADD: C = A + B over row-partitioned operands —
counterpart of ``spblas_tpu/parallel/add.py``.

Row-aligned operands need no communication in the numeric phase: each
rank runs the port's two-phase add (``ops/add.py``) on its own row
blocks.  ``dist_add_compute`` plans each rank's structure union once
(the ranks agree on one C capacity by a MAX all-reduce) and keeps the
JAX plan's fields, each rank's ``[rank]`` slice of them bit for bit;
``dist_add_numeric`` refills it with new values as often as the sparsity
stays, each slot's entries summed in the union's order (A's, then B's),
so it gives the JAX scatter's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from spblas_tpu_torch import types as _t
from spblas_tpu_torch.formats.convert import to_csr
from spblas_tpu_torch.ops.add import AddPlan, _add_numeric, add_inspect
from spblas_tpu_torch.parallel.mesh import RowMesh, check_mesh_matches
from spblas_tpu_torch.parallel.rowblock import RowBlockCSR, \
    partition_rowblock


@dataclasses.dataclass(frozen=True)
class DistAddPlan:
    """This rank's plan.  slot_a (lcap_a,), slot_b (lcap_b,): the output
    slot of each operand entry (ccap: padding, dropped); c_rowptr
    (mloc+1,) and c_colind (ccap,): the rank's C structure, c_nnz its
    live entries (a host int).  ``add``: the same union as the port's
    :class:`~spblas_tpu_torch.ops.add.AddPlan`, which the numeric runs.
    No port code reads ``slot_a``/``slot_b``: they are JAX's gather maps,
    kept so the plan stays bit-equal to JAX's slice ``[rank]``."""

    slot_a: torch.Tensor
    slot_b: torch.Tensor
    c_rowptr: torch.Tensor
    c_colind: torch.Tensor
    c_nnz: int
    add: AddPlan
    shape: Tuple[int, int]
    mloc: int
    p: int
    rank: int

    @property
    def c_capacity(self) -> int:
        return int(self.c_colind.shape[0])


def _grow(plan: AddPlan, ccap: int) -> AddPlan:
    """``plan`` at the common C capacity ``ccap`` (empty slots past its
    own)."""
    extra = ccap - plan.c_capacity
    run_len = F.pad(plan.run_len, (0, extra))
    return dataclasses.replace(
        plan, run_len=run_len, run_start=torch.cumsum(run_len, 0) - run_len,
        c_colind=F.pad(plan.c_colind, (0, extra)))


def _slots(plan: AddPlan, pos: torch.Tensor, cap: int) -> torch.Tensor:
    """The output slot of each of an operand's ``cap`` entries (``pos``:
    the live ones' positions in the merged stream), c_capacity past
    them."""
    of_pos = torch.repeat_interleave(
        torch.arange(plan.c_nnz, device=pos.device, dtype=torch.int32),
        plan.run_len[: plan.c_nnz])
    out = torch.full((cap,), plan.c_capacity, dtype=torch.int32,
                     device=pos.device)
    out[: pos.shape[0]] = of_pos[pos]
    return out


def dist_add_compute(a: RowBlockCSR, b: RowBlockCSR, mesh: RowMesh
                     ) -> DistAddPlan:
    """Symbolic phase: this rank's union of the two row blocks."""
    if a.shape != b.shape:
        raise ValueError(f"add shape mismatch {a.shape} vs {b.shape}")
    if a.mloc != b.mloc:
        raise ValueError("operands partitioned with different row blocks")
    check_mesh_matches(a.p, mesh, "dist_add_compute", rank=a.rank)
    if b.p != a.p:
        raise ValueError(
            f"dist_add: a partitioned for p={a.p} but b for p={b.p}")
    info = add_inspect(a.local_csr(), b.local_csr())
    (ccap,) = mesh.reduce_ints([info.result_nnz], "max")
    plan = _grow(info.plan, _t.quantize_capacity(max(ccap, 1)))
    return DistAddPlan(
        slot_a=_slots(plan, plan.a_pos, a.local_capacity),
        slot_b=_slots(plan, plan.b_pos, b.local_capacity),
        c_rowptr=plan.c_rowptr, c_colind=plan.c_colind, c_nnz=plan.c_nnz,
        add=plan, shape=a.shape, mloc=a.mloc, p=a.p, rank=a.rank)


def dist_add_numeric(plan: DistAddPlan, a: RowBlockCSR, b: RowBlockCSR,
                     mesh: RowMesh, alpha=1.0, beta=1.0) -> RowBlockCSR:
    """C = alpha*A + beta*B into the planned structure, purely local (the
    scalars promote the output type, as in the JAX package)."""
    check_mesh_matches(plan.p, mesh, "dist_add_numeric", rank=plan.rank)
    return RowBlockCSR(
        values=_add_numeric(plan.add, a.values, b.values, alpha, beta),
        colind=plan.c_colind, rowptr=plan.c_rowptr, nnz=plan.c_nnz,
        shape=plan.shape, mloc=plan.mloc, p=plan.p, rank=plan.rank)


def dist_add(a, b, mesh: RowMesh, alpha=1.0, beta=1.0) -> RowBlockCSR:
    """One-shot C = alpha*A + beta*B from global or partitioned operands."""
    if not isinstance(a, RowBlockCSR):
        a = partition_rowblock(to_csr(a), mesh)
    if not isinstance(b, RowBlockCSR):
        b = partition_rowblock(to_csr(b), mesh)
    plan = dist_add_compute(a, b, mesh)
    return dist_add_numeric(plan, a, b, mesh, alpha=alpha, beta=beta)

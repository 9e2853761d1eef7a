"""Distribution layer: row-partitioned sparse ops over ``torch.distributed``
— counterpart of ``spblas_tpu/parallel``.

The JAX package runs each op as one ``shard_map`` program over a device
mesh; the port runs it as an SPMD program with one process a rank (as
``torchrun`` starts them), each rank calling the same function on its
own slice of the operands and plans, the collectives on its
:class:`RowMesh`.  Host inspection runs on every rank over the global
operand and keeps the rank's slice, so every plan is bit-equal to the
rank's slice of the JAX package's stacked one.  ``launch`` starts a
local world of ranks (tests, the dry run, ``chip_smoke.py``).

Of the JAX package's ``__all__`` only ``row_sharding`` and ``replicated``
are missing: they name JAX placements (``NamedSharding``s) of a global
array over the mesh, and a rank here holds only its own slice.
"""

from spblas_tpu_torch.parallel.mesh import (
    ROW_AXIS, RowMesh, init_distributed, make_row_mesh, ring_perm,
)
from spblas_tpu_torch.parallel.dist_csr import (
    DistCSR, partition_csr, partition_vector, gather_result, to_local_csr,
)
from spblas_tpu_torch.parallel.rowblock import (
    RowBlockCSR, partition_rowblock, assemble_csr,
)
from spblas_tpu_torch.parallel.spmv import (
    dist_spmv, dist_spmm, partition_spmv, partition_spmv_vector,
    dist_plan_spmv, partition_spmm, partition_spmm_operand,
    dist_plan_spmm,
)
from spblas_tpu_torch.parallel.banded import (
    DistBandPlan, partition_band, partition_band_vector, dist_band_spmv,
    dist_band_spmm,
)
from spblas_tpu_torch.parallel.add import (
    DistAddPlan, dist_add, dist_add_compute, dist_add_numeric,
)
from spblas_tpu_torch.parallel.trsv import (
    DistTrsvPlan, dist_triangular_solve, dist_triangular_solve_inspect,
)
from spblas_tpu_torch.parallel.spgemm import (
    DistSpgemmPlan, dist_spgemm, dist_spgemm_compute, dist_spgemm_numeric,
)
from spblas_tpu_torch.parallel.route_spmv import (
    DistRoutePlan, partition_route, dist_route_spmv,
    DistSellPlan, partition_sell, dist_sell_spmm,
)

__all__ = [
    "ROW_AXIS", "RowMesh", "make_row_mesh", "ring_perm",
    "init_distributed",
    "DistCSR", "partition_csr", "partition_vector", "gather_result",
    "to_local_csr",
    "RowBlockCSR", "partition_rowblock", "assemble_csr",
    "partition_spmv", "partition_spmv_vector", "dist_plan_spmv",
    "partition_spmm", "partition_spmm_operand", "dist_plan_spmm",
    "dist_spmv", "dist_spmm",
    "DistBandPlan", "partition_band", "partition_band_vector",
    "dist_band_spmv", "dist_band_spmm",
    "DistAddPlan", "dist_add", "dist_add_compute", "dist_add_numeric",
    "DistTrsvPlan", "dist_triangular_solve",
    "dist_triangular_solve_inspect",
    "DistSpgemmPlan", "dist_spgemm", "dist_spgemm_compute",
    "dist_spgemm_numeric",
    "DistRoutePlan", "partition_route", "dist_route_spmv",
    "DistSellPlan", "partition_sell", "dist_sell_spmm",
]

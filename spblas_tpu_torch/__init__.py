"""spblas_tpu_torch — the PyTorch and CUDA port of spblas_tpu.

A second package beside the JAX one, grown slice by slice.  It carries
SpMV, SpMM, SpGEMM, SpTRSV, SpADD, transpose and scale end to end: the
CSR/CSC/COO/BSR/DCSR containers and their conversions, the lazy views
and the ``matrix_opt`` plan cache, the matvec and matmul plan ladders
(and ELL plans a caller builds), whose structured and ROUTE rungs run
kernels written by hand for Hopper (``csrc/``), the two-phase SpGEMM
with its ROUTE2-mul and ROUTE v1 engines and the block SpGEMM, and the
level-scheduled triangular solve with its ROUTE2 substitution, on
kernels of the same kind.  The kernels build on their first launch;
importing the package builds nothing.  It imports torch and numpy,
never JAX or ``spblas_tpu``.

Public surface: ``__all__`` of ``spblas_tpu/__init__.py``, and its
``solvers`` module (``cg``, ``power_method``, ``jacobi``).
"""

from spblas_tpu_torch.types import (Config, DEFAULT_CONFIG, index_dtype,
                                    real_dtype)

from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.convert import to_csr, to_csc, to_coo

from spblas_tpu_torch.views import (
    ScaledView, ConjugatedView, OptimizedMatrix,
    scaled, conjugated, transposed, matrix_opt,
    get_ultimate_base, get_scaling_factor, is_conjugated,
)

from spblas_tpu_torch.info import OperationInfo

from spblas_tpu_torch.ops.multiply import (
    multiply, multiply_inspect, multiply_compute, multiply_fill,
)
from spblas_tpu_torch.ops.spmv import spmv
from spblas_tpu_torch.ops.spmm import spmm
from spblas_tpu_torch.ops.spgemm import (
    spgemm, spgemm_chunked, spgemm_compute, spgemm_csc, spgemm_fill,
    SpgemmState,
    multiply_symbolic_compute, multiply_symbolic_fill, multiply_numeric,
    multiply_fused,
)
from spblas_tpu_torch.ops.add import add, add_inspect, add_compute
from spblas_tpu_torch.ops.transpose import transpose, transpose_inspect
from spblas_tpu_torch.ops.scale import scale
from spblas_tpu_torch.ops.triangular_solve import (
    triangular_solve, triangular_solve_inspect,
)
from spblas_tpu_torch import solvers  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "CSR", "CSC", "COO", "BSR", "to_csr", "to_csc", "to_coo",
    "ScaledView", "ConjugatedView", "OptimizedMatrix",
    "scaled", "conjugated", "transposed", "matrix_opt",
    "get_ultimate_base", "get_scaling_factor", "is_conjugated",
    "OperationInfo",
    "multiply", "multiply_inspect", "multiply_compute", "multiply_fill",
    "spmv", "spmm",
    "spgemm", "spgemm_chunked", "spgemm_compute", "spgemm_csc",
    "spgemm_fill", "SpgemmState",
    "multiply_symbolic_compute", "multiply_symbolic_fill",
    "multiply_numeric", "multiply_fused",
    "add", "add_inspect", "add_compute",
    "transpose", "transpose_inspect", "scale",
    "triangular_solve", "triangular_solve_inspect",
    "Config", "DEFAULT_CONFIG", "index_dtype", "real_dtype",
]

"""spblas_tpu_torch — the PyTorch and CUDA port of spblas_tpu.

A second package beside the JAX one, grown slice by slice.  It carries
SpMV, SpMM and SpGEMM end to end: the CSR/CSC/COO/BSR containers, the
lazy views and the ``matrix_opt`` plan cache, the matvec and matmul plan
ladders, whose structured and ROUTE rungs run kernels written by hand
for Hopper (``csrc/``), and the two-phase SpGEMM with its ROUTE2-mul
engines and the block SpGEMM, on kernels of the same kind.  The kernels build on their first launch;
importing the package builds nothing.  It imports torch and numpy,
never JAX or ``spblas_tpu``.

Public surface: the subset of ``spblas_tpu/__init__.py`` ported so far.
"""

from spblas_tpu_torch.types import (Config, DEFAULT_CONFIG, index_dtype,
                                    real_dtype)

from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.convert import to_csr

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

__version__ = "0.1.0"

__all__ = [
    "CSR", "CSC", "COO", "BSR", "to_csr",
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
    "Config", "DEFAULT_CONFIG", "index_dtype", "real_dtype",
]

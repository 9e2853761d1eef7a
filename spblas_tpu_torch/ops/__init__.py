from spblas_tpu_torch.ops.multiply import (multiply, multiply_inspect,
                                           multiply_compute, multiply_fill)
from spblas_tpu_torch.ops.spmv import spmv
from spblas_tpu_torch.ops.spmm import spmm
from spblas_tpu_torch.ops.spgemm import (
    spgemm, spgemm_chunked, spgemm_compute, spgemm_csc, spgemm_fill,
    SpgemmState,
    multiply_symbolic_compute, multiply_symbolic_fill, multiply_numeric,
    multiply_fused,
)

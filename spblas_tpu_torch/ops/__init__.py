from spblas_tpu_torch.ops.multiply import (multiply, multiply_inspect,
                                           multiply_compute, multiply_fill)
from spblas_tpu_torch.ops.spmv import spmv
from spblas_tpu_torch.ops.spmm import spmm

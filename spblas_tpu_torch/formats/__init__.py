from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.dcsr import DCSR
from spblas_tpu_torch.formats.convert import to_csr, to_csc, to_coo

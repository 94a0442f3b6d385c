"""matmul_ms.train: device ms a step of the GEMM kernels (cuBLAS, cuDNN's
implicit GEMM)."""
from portbench.harness import readers


def read(run):
    return readers.matmul_ms(run)

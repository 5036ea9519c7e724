from repro_torch.kernels.gemm.ops import (
    default_block,
    matmul_bias_act,
    matmul_q8_bias_act,
)
from repro_torch.kernels.gemm.ref import matmul_q8_ref, matmul_ref

__all__ = ["default_block", "matmul_bias_act", "matmul_q8_bias_act",
           "matmul_q8_ref", "matmul_ref"]

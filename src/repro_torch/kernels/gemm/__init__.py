from repro_torch.kernels.gemm.ops import (
    default_block,
    matmul16_bias_act,
    matmul_bias_act,
    matmul_q8_bias_act,
)
from repro_torch.kernels.gemm.ref import matmul16_ref, matmul_q8_ref, matmul_ref

__all__ = ["default_block", "matmul16_bias_act", "matmul16_ref",
           "matmul_bias_act", "matmul_q8_bias_act", "matmul_q8_ref",
           "matmul_ref"]

from repro_torch.kernels.im2col_gemm.ops import im2col_conv, pick_blocks
from repro_torch.kernels.im2col_gemm.ref import im2col_conv_ref

__all__ = ["im2col_conv", "im2col_conv_ref", "pick_blocks"]

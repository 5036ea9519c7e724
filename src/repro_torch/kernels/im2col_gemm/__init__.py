from repro_torch.kernels.im2col_gemm.ops import (
    im2col_conv,
    im2col_conv16,
    im2col_conv_q8,
    pick_blocks,
)
from repro_torch.kernels.im2col_gemm.ref import (
    im2col_conv16_ref,
    im2col_conv_q8_ref,
    im2col_conv_ref,
)

__all__ = ["im2col_conv", "im2col_conv16", "im2col_conv16_ref",
           "im2col_conv_q8", "im2col_conv_q8_ref", "im2col_conv_ref",
           "pick_blocks"]

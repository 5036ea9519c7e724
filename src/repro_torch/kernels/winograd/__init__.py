from repro_torch.kernels.winograd.ops import (
    conv2d_winograd_padded_call,
    fused_winograd,
    pick_blocks,
)
from repro_torch.kernels.winograd.ref import fused_winograd_ref

__all__ = [
    "conv2d_winograd_padded_call",
    "fused_winograd",
    "fused_winograd_ref",
    "pick_blocks",
]

from repro_torch.kernels.winograd.ops import (
    FUSED_BLOCKS,
    THREE_PASS_BLOCKS,
    conv2d_winograd_padded_call,
    fused_winograd,
    input_transform,
    output_transform,
    pick_blocks,
    tuple_multiply,
)
from repro_torch.kernels.winograd.ref import (
    fused_winograd_ref,
    input_transform_ref,
    output_transform_ref,
    tuple_multiply_ref,
)

__all__ = [
    "FUSED_BLOCKS",
    "THREE_PASS_BLOCKS",
    "conv2d_winograd_padded_call",
    "fused_winograd",
    "fused_winograd_ref",
    "input_transform",
    "input_transform_ref",
    "output_transform",
    "output_transform_ref",
    "pick_blocks",
    "tuple_multiply",
    "tuple_multiply_ref",
]

"""Plain PyTorch version of the GEMM kernel: the function it must compute."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv_spec import apply_activation


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               activation: str = "linear") -> torch.Tensor:
    """act(a @ b + bias) in fp32."""
    out = a @ b
    if bias is not None:
        out = out + bias
    return apply_activation(out, activation)

"""Plain PyTorch version of the implicit-GEMM conv kernel: explicit im2col
then GEMM (core/im2col.py), with the epilogue."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv_spec import ConvSpec, Epilogue
from repro_torch.core.im2col import conv2d_im2col


def im2col_conv_ref(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
                    bias: Optional[torch.Tensor] = None,
                    activation: str = "linear") -> torch.Tensor:
    """act(conv(x, w) + bias): x (B, H, W, C), w (kh, kw, C, O)."""
    return conv2d_im2col(x, w, spec, Epilogue(bias, activation))

"""Plain PyTorch versions of the implicit-GEMM conv kernels (fp32, 16-bit
and int8): explicit im2col then GEMM (core/im2col.py), with the epilogue."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv_spec import ConvSpec, Epilogue, apply_epilogue
from repro_torch.core.im2col import conv2d_im2col


def im2col_conv_ref(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
                    bias: Optional[torch.Tensor] = None,
                    activation: str = "linear") -> torch.Tensor:
    """act(conv(x, w) + bias): x (B, H, W, C), w (kh, kw, C, O)."""
    return conv2d_im2col(x, w, spec, Epilogue(bias, activation))


def im2col_conv16_ref(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
                      bias: Optional[torch.Tensor] = None,
                      activation: str = "linear") -> torch.Tensor:
    """act(conv(x, w) + bias) for bf16 or fp16 x (B, H, W, C) and w (kh,
    kw, C, O): the operands upcast, the sum and the epilogue in fp32,
    rounded once to x's type, as the kernel rounds."""
    return im2col_conv_ref(x.float(), w.float(), spec, bias,
                           activation).to(x.dtype)


def im2col_conv_q8_ref(x_q: torch.Tensor, w_q: torch.Tensor, spec: ConvSpec,
                       scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       activation: str = "linear") -> torch.Tensor:
    """act(float(conv(x_q, w_q)) * scale + bias): int8 x (B, H, W, C) and
    w (kh, kw, C, O), the sum exact (im2col and GEMM in float64, exact
    while |sum| < 2^53), then the fp32 epilogue in the kernel's order."""
    acc = conv2d_im2col(x_q.double(), w_q.double(), spec).to(torch.int32)
    return apply_epilogue(acc, Epilogue(bias, activation, scale))

"""im2col and conv-as-GEMM in plain torch (NHWC layout).

The paper's im2col+GEMM pipeline (§IV.A), ported from
``repro/core/im2col.py``: patches are ordered (kh, kw, C) along K so a
weight reshaped from HWIO (kh, kw, C, O) multiplies them directly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import ConvSpec, Epilogue, apply_epilogue


def im2col(
    x: torch.Tensor,
    kernel_size: Tuple[int, int],
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (0, 0),
    dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """(B, H, W, C) -> (B, OH, OW, kh*kw*C) patches, K ordered (kh, kw, C)."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    oh = (h + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
    ow = (w + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    dev = x.device
    rows = (torch.arange(oh, device=dev) * sh)[:, None] + (
        torch.arange(kh, device=dev) * dh)[None, :]                 # (OH, kh)
    cols = (torch.arange(ow, device=dev) * sw)[:, None] + (
        torch.arange(kw, device=dev) * dw)[None, :]                 # (OW, kw)
    patches = x[:, rows[:, None, :, None], cols[None, :, None, :], :]
    return patches.reshape(b, oh, ow, kh * kw * c)


def conv2d_im2col(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    epilogue: Optional[Epilogue] = None,
) -> torch.Tensor:
    """x (B, H, W, C), w (kh, kw, C, O) -> (B, OH, OW, O) via im2col + GEMM.

    O is the weights' own: the network executor may pad it past
    ``spec.out_channels`` for the next conv (core/netplan.py).
    """
    b, h, ww, c = x.shape
    kh, kw, wc, o = w.shape
    assert (kh, kw) == spec.kernel_size and wc == c
    oh, ow = spec.out_hw(h, ww)
    patches = im2col(x, spec.kernel_size, spec.stride, spec.padding,
                     spec.dilation)
    k = kh * kw * c
    out = patches.reshape(b * oh * ow, k) @ w.reshape(k, o)
    return apply_epilogue(out, epilogue).reshape(b, oh, ow, o)


def conv2d_direct_1x1(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    epilogue: Optional[Epilogue] = None,
) -> torch.Tensor:
    """1x1 convolution as a plain GEMM (the paper's Direct path for 1x1)."""
    b, _, _, c = x.shape
    assert spec.kernel_size == (1, 1)
    sh, sw = spec.stride
    ph, pw = spec.padding
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    if (sh, sw) != (1, 1):
        x = x[:, ::sh, ::sw, :]
    oh, ow = x.shape[1], x.shape[2]
    out = x.reshape(b * oh * ow, c) @ w.reshape(c, spec.out_channels)
    return apply_epilogue(out, epilogue).reshape(b, oh, ow, spec.out_channels)

"""Convolution specification and per-layer algorithm selection.

The port of ``repro/core/conv_spec.py``: 1x1 kernels run as a direct GEMM,
3x3 stride-1 kernels run Winograd F(6x6,3x3), everything else runs
im2col+GEMM.  Every conv layer carries a ConvSpec and the dispatcher in
core/conv2d.py consults it.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch


class ConvAlgorithm(enum.Enum):
    """Convolution algorithm choices studied by the paper."""

    AUTO = "auto"
    DIRECT = "direct"            # 1x1 -> plain GEMM (no patch expansion)
    IM2COL_GEMM = "im2col_gemm"  # generic path (paper §IV.A)
    WINOGRAD = "winograd"        # F(6x6,3x3), 8x8 tiles (paper §IV.B)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static description of one convolutional layer."""

    in_channels: int
    out_channels: int
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (1, 1)   # symmetric (ph, pw)
    dilation: Tuple[int, int] = (1, 1)
    algorithm: ConvAlgorithm = ConvAlgorithm.AUTO

    @property
    def kh(self) -> int:
        return self.kernel_size[0]

    @property
    def kw(self) -> int:
        return self.kernel_size[1]

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Output spatial dims for an (h, w) input."""
        ph, pw = self.padding
        sh, sw = self.stride
        dh, dw = self.dilation
        eff_kh = (self.kh - 1) * dh + 1
        eff_kw = (self.kw - 1) * dw + 1
        oh = (h + 2 * ph - eff_kh) // sh + 1
        ow = (w + 2 * pw - eff_kw) // sw + 1
        return oh, ow

    def gemm_dims(self, h: int, w: int) -> Tuple[int, int, int]:
        """(M, N, K) of the im2col GEMM for an (h, w) input, as the paper's
        Table IV writes it: M = out channels, N = OH * OW, K = kh*kw*C."""
        oh, ow = self.out_hw(h, w)
        return self.out_channels, oh * ow, self.kh * self.kw * self.in_channels


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Per-layer conv epilogue fused into the kernel's output stage.

    Inference batchnorm is folded into the conv weights + this bias first
    (``models/cnn.fold_batchnorm``), so every conv layer reduces to
    conv + bias + activation, applied on the fp32 accumulator before the
    store.  ``bias`` is an (out_channels,) tensor or None; ``activation``
    is 'linear' | 'relu' | 'leaky'.  ``scale`` is the int8 dequant row: an
    (out_channels,) fp32 tensor multiplied into the int32 accumulator
    before the bias, y = act(acc * scale + bias) (core/quant.py); None for
    an fp32 conv.
    """

    bias: Optional[torch.Tensor] = None
    activation: str = "linear"
    scale: Optional[torch.Tensor] = None


#: Activation codes the CUDA kernels take (``act`` argument of every entry).
ACTIVATION_CODES = {"linear": 0, "relu": 1, "leaky": 2}


def apply_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Darknet's activate_array; the leaky slope is 0.1, not torch's 0.01."""
    if kind == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if kind == "relu":
        return torch.clamp_min(x, 0)
    if kind == "linear":
        return x
    raise ValueError(f"unknown activation {kind!r}")


def apply_epilogue(y: torch.Tensor, epilogue: Optional[Epilogue]) -> torch.Tensor:
    """Plain epilogue: y * scale (int8 dequant, in fp32), + bias, then
    activation, in that order, as the kernels apply it."""
    if epilogue is None:
        return y
    if epilogue.scale is not None:
        y = y.float() * epilogue.scale
    if epilogue.bias is not None:
        y = y + epilogue.bias
    return apply_activation(y, epilogue.activation)


def select_algorithm(spec: ConvSpec) -> ConvAlgorithm:
    """The paper's per-layer selection rule (§VII.A, §II.c).

    - 1x1, stride 1: the im2col matrix equals the input — run a direct GEMM.
    - 3x3, stride 1, no dilation: Winograd F(6,3).
    - everything else: im2col+GEMM.
    """
    if spec.algorithm is not ConvAlgorithm.AUTO:
        return spec.algorithm
    if spec.kernel_size == (1, 1) and spec.stride == (1, 1):
        return ConvAlgorithm.DIRECT
    if (
        spec.kernel_size == (3, 3)
        and spec.stride == (1, 1)
        and spec.dilation == (1, 1)
    ):
        return ConvAlgorithm.WINOGRAD
    return ConvAlgorithm.IM2COL_GEMM


def arithmetic_intensity(m: int, n: int, k: int, bytes_per_elem: int = 4) -> float:
    """AI of a GEMM as the paper defines it (§VI.C):
    2*M*N*K / (bytes * (M*N + K*N + M*K))."""
    return (2.0 * m * n * k) / (bytes_per_elem * (m * n + k * n + m * k))

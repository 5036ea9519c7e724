"""Wrapper of the hand-written implicit-GEMM conv kernel
(csrc/im2col_conv.cu).

``im2col_conv`` computes act(conv(x, w) + bias) on NHWC input whose channel
count is a multiple of ``BC``.  The conv's spatial zero padding is applied
inside the kernel, and out channels and ragged row/column tiles are masked
there, so the only layout the caller owns is the channel multiple.
``impl='cuda'`` launches the kernel on CUDA tensors and raises on anything
else; ``impl='torch'`` runs the plain version (ref.py).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES, ConvSpec
from repro_torch.kernels import _build
from repro_torch.kernels.im2col_gemm.ref import im2col_conv_ref

BC = 8          # in channels per reduction step: C must be a multiple
BO = 64         # out channels per block
PIXELS = 64     # output pixels per block: toh * tow <= PIXELS

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p]


def pick_blocks(oh: int, ow: int) -> Tuple[int, int, int]:
    """(toh, bc, bo) for an OH x OW output map.

    A block computes a toh x tow tile of 64 output pixels: whole rows when a
    row fits (tow = OW, toh = 64 // OW), else 8 x 8 tiles.  The input window
    a tile needs, halo included, is what the block stages in shared memory —
    ((toh-1)*sh + kh) x ((tow-1)*sw + kw) x BC floats, at most 12 KB here —
    instead of the whole padded image the TPU kernel holds.
    """
    toh = min(oh, PIXELS // ow) if ow <= PIXELS else 8
    return max(toh, 1), BC, BO


def tile_width(toh: int, ow: int) -> int:
    """Output columns per block for a row tile of ``toh`` rows."""
    return min(ow, PIXELS // toh)


def im2col_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """x (B, H, W, C), w (kh, kw, C, O) -> (B, OH, OW, O); C % BC == 0.

    ``blocks`` is a (toh, bc, bo) plan tuple; only toh is free (bc and bo
    are the kernel's compiled BC and BO).
    """
    b, h, ww, c = x.shape
    kh, kw, wc, o = w.shape
    if (kh, kw) != spec.kernel_size or wc != c or c % BC:
        raise ValueError(f"im2col_conv: x {tuple(x.shape)}, w {tuple(w.shape)}"
                         f" for {spec} (C must be a multiple of {BC})")
    if spec.dilation != (1, 1):
        raise ValueError("im2col_conv: dilation is not supported")
    oh, ow = spec.out_hw(h, ww)
    toh = blocks[0] if blocks is not None else pick_blocks(oh, ow)[0]
    if (blocks is not None and tuple(blocks[1:]) != (BC, BO)) or not 1 <= toh <= PIXELS:
        raise ValueError(f"im2col_conv: blocks {blocks} (kernel takes "
                         f"(toh <= {PIXELS}, {BC}, {BO}))")
    if impl == "torch":
        return im2col_conv_ref(x, w, spec, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("im2col_conv", x, w, bias)
    out = torch.empty((b, oh, ow, o), device=x.device, dtype=torch.float32)
    if out.numel():
        fn = _build.load("im2col_conv", "repro_im2col_conv", _ARGTYPES)
        (sh, sw), (ph, pw) = spec.stride, spec.padding
        err = fn(x.data_ptr(), w.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), b, h, ww, c, o, oh, ow, kh, kw, sh, sw,
                 ph, pw, toh, tile_width(toh, ow), ACTIVATION_CODES[activation],
                 _build.stream_handle(x))
        _build.check(err, "im2col_conv")
        im2col_conv.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
im2col_conv.launches = 0

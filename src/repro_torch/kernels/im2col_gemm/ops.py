"""Wrappers of the hand-written implicit-GEMM conv kernels
(csrc/im2col_conv.cu, csrc/im2col_conv_q8.cu).

``im2col_conv`` computes act(conv(x, w) + bias) on NHWC input whose channel
count is a multiple of ``BC``; ``im2col_conv_q8`` computes
act(float(conv(x_q, w_q)) * scale + bias) on int8 input whose channel
count is a multiple of ``BC_Q8``, with an exact int32 sum (on the int8
tensor cores, in chunks of ``CHUNK_Q8`` channels).  The conv's spatial
zero padding is applied inside the kernels, and out channels and ragged
row/column tiles are masked there, so the only layout the caller owns is
the channel multiple.  Both kernels split their reduction over the
channel chunks across blocks where the grid alone would leave the card
half empty (``split_k``, each over its own kernel's resident blocks); one
wrapper call is one conv, whatever the number of CUDA kernels it
launches.
``impl='cuda'`` launches the kernel on CUDA tensors and raises on anything
else; ``impl='torch'`` runs the plain version (ref.py).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES, ConvSpec
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_k, split_ranges  # noqa: F401
from repro_torch.kernels.im2col_gemm.ref import (
    im2col_conv_q8_ref,
    im2col_conv_ref,
)

BC = 8          # in channels per reduction step: C must be a multiple
BC_Q8 = 16      # the int8 kernel's channel multiple (16-byte copies)
CHUNK_Q8 = 32   # the int8 kernel's chunk: one m16n8k32 step per tap
BO = 64         # out channels per block
PIXELS = 64     # output pixels per block: toh * tow <= PIXELS
#: Blocks of the fp32 kernel resident on one SM (its launch bounds).
RESIDENT_BLOCKS = 2
#: Blocks of the int8 kernel resident on one SM (its launch bounds'
#: MIN_BLOCKS).
RESIDENT_BLOCKS_Q8 = 2

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
_ARGTYPES_Q8 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 + [ctypes.c_void_p]


def pick_blocks(oh: int, ow: int, dtype: str = "float32") -> Tuple[int, int, int]:
    """(toh, bc, bo) for an OH x OW output map, for the fp32 or the int8
    kernel (which differ only in bc).

    A block computes a toh x tow tile of 64 output pixels: whole rows when a
    row fits (tow = OW, toh = 64 // OW), else 8 x 8 tiles.  The input window
    a tile needs, halo included, is what the block stages in shared memory —
    ((toh-1)*sh + kh) x ((tow-1)*sw + kw) x bc values, at most 12 KB here —
    instead of the whole padded image the TPU kernel holds.
    """
    toh = min(oh, PIXELS // ow) if ow <= PIXELS else 8
    return max(toh, 1), BC_Q8 if dtype == "int8" else BC, BO


def snap_row_tile(toh: int, oh: int) -> int:
    """The row tile a network plan runs (core/netplan.py): the largest
    divisor of OH no bigger than ``toh``, where it keeps at least half the
    tile (a prime OH must not explode the grid into one block per output
    row); else ``toh`` as it is, whose ragged last tile the kernel masks."""
    snapped = min(toh, oh)
    while oh % snapped:
        snapped -= 1
    return toh if snapped < min(toh, oh) / 2 else snapped


def tile_width(toh: int, ow: int) -> int:
    """Output columns per block for a row tile of ``toh`` rows."""
    return min(ow, PIXELS // toh)


def grid_blocks(batch: int, oh: int, ow: int, o: int, toh: int) -> int:
    """Blocks of one conv call (fp32 or int8) before any split: output
    tiles times 64-channel blocks times images."""
    tow = tile_width(toh, ow)
    return batch * -(-oh // toh) * -(-ow // tow) * -(-o // BO)


def call_splits(batch: int, oh: int, ow: int, c: int, o: int,
                toh: int) -> int:
    """``split_k`` for one fp32 conv call: its grid and C / BC chunks."""
    return split_k(grid_blocks(batch, oh, ow, o, toh), c // BC, RESIDENT_BLOCKS)


def call_splits_q8(batch: int, oh: int, ow: int, c: int, o: int,
                   toh: int) -> int:
    """``split_k`` for one int8 conv call: its grid and ceil(C / CHUNK_Q8)
    chunks, over ``RESIDENT_BLOCKS_Q8``."""
    return split_k(grid_blocks(batch, oh, ow, o, toh), -(-c // CHUNK_Q8),
                   RESIDENT_BLOCKS_Q8)


def _conv_geometry(what: str, x: torch.Tensor, w: torch.Tensor,
                   spec: ConvSpec, blocks: Optional[Tuple[int, int, int]],
                   bc: int) -> Tuple[int, int, int]:
    """(OH, OW, toh) of one call; raises on what the kernel does not take."""
    c = x.shape[-1]
    kh, kw, wc, _ = w.shape
    if (kh, kw) != spec.kernel_size or wc != c or c % bc:
        raise ValueError(f"{what}: x {tuple(x.shape)}, w {tuple(w.shape)}"
                         f" for {spec} (C must be a multiple of {bc})")
    if spec.dilation != (1, 1):
        raise ValueError(f"{what}: dilation is not supported")
    oh, ow = spec.out_hw(x.shape[1], x.shape[2])
    toh = blocks[0] if blocks is not None else pick_blocks(oh, ow)[0]
    if (blocks is not None and tuple(blocks[1:]) != (bc, BO)) or not 1 <= toh <= PIXELS:
        raise ValueError(f"{what}: blocks {blocks} (kernel takes "
                         f"(toh <= {PIXELS}, {bc}, {BO}))")
    return oh, ow, toh


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
    are the kernel's compiled BC and BO).  With ``split_k(...) > 1`` the
    partial sums go through a workspace of ``splits * B * OH * OW * O``
    floats from PyTorch's caching allocator.
    """
    oh, ow, toh = _conv_geometry("im2col_conv", x, w, spec, blocks, BC)
    if impl == "torch":
        return im2col_conv_ref(x, w, spec, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("im2col_conv", x, w, bias)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("im2col_conv: x and w must be 16-byte aligned")
    b, h, ww, c = x.shape
    kh, kw, _, o = w.shape
    out = torch.empty((b, oh, ow, o), device=x.device, dtype=torch.float32)
    if out.numel():
        fn = _build.load("im2col_conv", "repro_im2col_conv", _ARGTYPES)
        (sh, sw), (ph, pw) = spec.stride, spec.padding
        splits = call_splits(b, oh, ow, c, o, toh)
        ws = (torch.empty((splits, b * oh * ow, o), device=x.device,
                          dtype=torch.float32) if splits > 1 else None)
        err = fn(x.data_ptr(), w.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 b, h, ww, c, o, oh, ow, kh, kw, sh, sw, ph, pw, toh,
                 tile_width(toh, ow), ACTIVATION_CODES[activation], splits,
                 _build.stream_handle(x))
        _build.check(err, "im2col_conv")
        im2col_conv.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
im2col_conv.launches = 0


def im2col_conv_q8(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    spec: ConvSpec,
    scale: torch.Tensor,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """int8 x_q (B, H, W, C), w_q (kh, kw, C, O) -> fp32 (B, OH, OW, O) =
    act(float(conv) * scale + bias); C % BC_Q8 == 0, ``scale`` (O,).

    ``blocks`` is a (toh, BC_Q8, BO) plan tuple.  Raises when
    K = kh * kw * C could overflow the int32 sum (K * 127^2 >= 2^31).  With
    ``call_splits_q8(...) > 1`` the int32 partial sums go through a
    workspace of ``splits * B * OH * OW * O`` int32 from PyTorch's caching
    allocator.
    """
    oh, ow, toh = _conv_geometry("im2col_conv_q8", x_q, w_q, spec, blocks,
                                 BC_Q8)
    b, h, ww, c = x_q.shape
    kh, kw, _, o = w_q.shape
    if scale.shape != (o,) or (bias is not None and bias.shape != (o,)):
        raise ValueError(f"im2col_conv_q8: scale {tuple(scale.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)} for "
                         f"{o} out channels")
    _build.require_int32_exact("im2col_conv_q8", kh * kw * c)
    if impl == "torch":
        return im2col_conv_q8_ref(x_q, w_q, spec, scale, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("im2col_conv_q8", x_q, w_q, dtype=torch.int8)
    _build.require_cuda_operands("im2col_conv_q8", scale, bias)
    if x_q.data_ptr() % 16:
        raise ValueError("im2col_conv_q8: x must be 16-byte aligned")
    out = torch.empty((b, oh, ow, o), device=x_q.device, dtype=torch.float32)
    if out.numel():
        fn = _build.load("im2col_conv_q8", "repro_im2col_conv_q8",
                         _ARGTYPES_Q8)
        (sh, sw), (ph, pw) = spec.stride, spec.padding
        splits = call_splits_q8(b, oh, ow, c, o, toh)
        ws = (torch.empty((splits, b * oh * ow, o), device=x_q.device,
                          dtype=torch.int32) if splits > 1 else None)
        err = fn(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 b, h, ww, c, o, oh, ow, kh, kw, sh, sw, ph, pw, toh,
                 tile_width(toh, ow), ACTIVATION_CODES[activation], splits,
                 _build.stream_handle(x_q))
        _build.check(err, "im2col_conv_q8")
        im2col_conv_q8.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
im2col_conv_q8.launches = 0

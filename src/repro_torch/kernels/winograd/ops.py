"""Wrapper of the hand-written fused Winograd F(6,3) kernel
(csrc/winograd_fused.cu), and the conv around it.

Pipeline (paper §IV.B): tile -> fused kernel (input transform, tuple
multiply, output transform, bias, activation) -> untile.  The overlapping
8x8 tile extraction and the untiling stay plain torch data movement here,
as in the reference (``repro/kernels/winograd/ops.py``); the offline weight
transform is ``core/winograd.transform_weights``.  ``impl='cuda'`` launches
the kernel on CUDA tensors and raises on anything else; ``impl='torch'``
runs the plain version (ref.py).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES
from repro_torch.core.winograd import OUT_TILE, TILE, _tile_input
from repro_torch.kernels import _build
from repro_torch.kernels.winograd.ref import fused_winograd_ref

BC = 8            # in channels per reduction step: C must be a multiple
THREADS = 256     # bt * bo: one (tile, out channel) pair per thread

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def pick_blocks(t: int, c: int, o: int) -> Tuple[int, int, int]:
    """(bt, bc, bo) for T tiles and C -> O channels.

    Each thread keeps the 64 M accumulators of one (tile, out channel) pair
    in registers, so bt * bo = 256; bo is the out-channel count rounded up
    to a power of two within [16, 64] (fewer idle threads on the 16- and
    32-channel layers), bt the rest.
    """
    bo = 16
    while bo < min(o, 64):
        bo *= 2
    return THREADS // bo, BC, bo


def fused_winograd(
    tiles: torch.Tensor,
    u: torch.Tensor,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(T, 8, 8, C) x (8, 8, C, O) -> (T, 6, 6, O); C % BC == 0."""
    t, _, _, c = tiles.shape
    o = u.shape[-1]
    if tiles.shape[1:3] != (TILE, TILE) or u.shape[:3] != (TILE, TILE, c) or c % BC:
        raise ValueError(f"fused_winograd: tiles {tuple(tiles.shape)}, "
                         f"u {tuple(u.shape)} (C must be a multiple of {BC})")
    bt, bc, bo = blocks if blocks is not None else pick_blocks(t, c, o)
    if bc != BC or bt * bo != THREADS or bo < 16:
        raise ValueError(f"fused_winograd: blocks {(bt, bc, bo)} (kernel takes "
                         f"bt * bo = {THREADS}, bo >= 16, bc = {BC})")
    if impl == "torch":
        return fused_winograd_ref(tiles, u, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("fused_winograd", tiles, u, bias)
    out = torch.empty((t, OUT_TILE, OUT_TILE, o), device=tiles.device,
                      dtype=torch.float32)
    if out.numel():
        fn = _build.load("winograd_fused", "repro_winograd_fused", _ARGTYPES)
        err = fn(tiles.data_ptr(), u.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), t, c, o, bt, bo, ACTIVATION_CODES[activation],
                 _build.stream_handle(tiles))
        _build.check(err, "fused_winograd")
        fused_winograd.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
fused_winograd.launches = 0


def conv2d_winograd_padded_call(
    x_sp: torch.Tensor,
    u: torch.Tensor,
    oh: int,
    ow: int,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """The Winograd conv on spatially padded, channel-aligned input.

    ``x_sp`` (B, H+2ph, W+2pw, Cp) carries the conv's spatial padding and
    Cp % BC == 0; ``u`` (8, 8, Cp, O) is the transformed weight.  Returns
    (B, OH, OW, O): the 6-multiple tail rows and columns hold act(bias), not
    conv output, so they are cropped here.
    """
    b = x_sp.shape[0]
    o = u.shape[-1]
    tiles, nth, ntw = _tile_input(x_sp, oh, ow)      # (B, nTH, nTW, 8, 8, Cp)
    t = b * nth * ntw
    tiles = tiles.reshape(t, TILE, TILE, x_sp.shape[-1])
    y = fused_winograd(tiles, u, blocks, bias, activation, impl)
    y = y.reshape(b, nth, ntw, OUT_TILE, OUT_TILE, o).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, nth * OUT_TILE, ntw * OUT_TILE, o)
    return y[:, :oh, :ow, :]

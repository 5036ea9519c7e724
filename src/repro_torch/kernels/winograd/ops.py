"""Wrappers of the hand-written Winograd F(6,3) kernels, and the conv
around them.

Pipeline (paper §IV.B): tile -> input transform -> tuple multiply ->
output transform (+ bias, activation) -> untile, in one of two
realizations: the fused kernel (csrc/winograd_fused.cu: V and M never
leave the chip) or the 3-pass pipeline (csrc/winograd_3pass.cu: one kernel
per stage, V and M through device memory).  The overlapping 8x8 tile
extraction and the untiling stay plain torch data movement here, as in the
reference (``repro/kernels/winograd/ops.py``); the offline weight
transform is ``core/winograd.transform_weights``.  ``impl='cuda'``
launches the kernels on CUDA tensors and raises on anything else;
``impl='torch'`` runs the plain versions (ref.py).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES
from repro_torch.core.winograd import OUT_TILE, TILE, _tile_input
from repro_torch.kernels import _build
from repro_torch.kernels.winograd.ref import (
    fused_winograd_ref,
    input_transform_ref,
    output_transform_ref,
    tuple_multiply_ref,
)

BC = 8            # fused kernel: in channels per reduction step (C % BC == 0)
#: The fused kernel's compiled tile (bt, bc, bo): 16 tiles x 32 out
#: channels per block (512 threads, one (tile, out channel) pair each in
#: the output transform), in-channel steps of 8.
FUSED_BLOCKS: Tuple[int, int, int] = (16, BC, 32)
#: The 3-pass tuple multiply's compiled tile (bt, bc, bo): 64 tiles x 64
#: out channels per block, in-channel steps of 16.
THREE_PASS_BLOCKS: Tuple[int, int, int] = (64, 16, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
_INPUT_ARGTYPES = [_P, _P, _I, _I, _P]
_TUPLE_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]
_OUTPUT_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]


def pick_blocks(t: int, c: int, o: int,
                fused: bool = True) -> Tuple[int, int, int]:
    """(bt, bc, bo) for T tiles and C -> O channels, for the realization
    that runs: each kernel's compiled tile, whatever the shape.

    Fused: ``FUSED_BLOCKS``; the block keeps the 64 positions' M of its
    16 x 32 (tile, out channel) pairs as tensor-core accumulators and
    stages each chunk of U once for its 16 tiles.  3-pass: the tuple
    multiply's tile, ``THREE_PASS_BLOCKS``; the two transforms take one
    (tile, channel) pair per thread and no block.
    """
    return FUSED_BLOCKS if fused else THREE_PASS_BLOCKS


def _check_impl(impl: str) -> None:
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")


def fused_winograd(
    tiles: torch.Tensor,
    u: torch.Tensor,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(T, 8, 8, C) x (8, 8, C, O) -> (T, 6, 6, O); C % BC == 0, C > 0.

    ``blocks`` is ``FUSED_BLOCKS`` (or None); the products run as 3xTF32
    on the tensor cores.
    """
    t, _, _, c = tiles.shape
    o = u.shape[-1]
    if tiles.shape[1:3] != (TILE, TILE) or u.shape[:3] != (TILE, TILE, c) or c % BC:
        raise ValueError(f"fused_winograd: tiles {tuple(tiles.shape)}, "
                         f"u {tuple(u.shape)} (C must be a multiple of {BC})")
    bt, bc, bo = blocks if blocks is not None else pick_blocks(t, c, o)
    if (bt, bc, bo) != FUSED_BLOCKS:
        raise ValueError(f"fused_winograd: blocks {(bt, bc, bo)} (the kernel "
                         f"takes its compiled tile {FUSED_BLOCKS})")
    _check_impl(impl)
    if impl == "torch":
        return fused_winograd_ref(tiles, u, bias, activation)
    _build.require_cuda_operands("fused_winograd", tiles, u, bias)
    if tiles.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("fused_winograd: tiles and u must be 16-byte aligned")
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


def input_transform(tiles: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """V = B^T d B: (T, 8, 8, C) -> (8, 8, T, C), position-major."""
    t, _, _, c = tiles.shape
    if tiles.shape[1:3] != (TILE, TILE):
        raise ValueError(f"input_transform: tiles {tuple(tiles.shape)}")
    _check_impl(impl)
    if impl == "torch":
        return input_transform_ref(tiles)
    _build.require_cuda_operands("input_transform", tiles)
    v = torch.empty((TILE, TILE, t, c), device=tiles.device,
                    dtype=torch.float32)
    if v.numel():
        fn = _build.load("winograd_3pass", "repro_winograd_input_transform",
                         _INPUT_ARGTYPES)
        err = fn(tiles.data_ptr(), v.data_ptr(), t, c,
                 _build.stream_handle(tiles))
        _build.check(err, "input_transform")
        input_transform.launches += 1
    return v


def tuple_multiply(v: torch.Tensor, u: torch.Tensor,
                   impl: str = "cuda") -> torch.Tensor:
    """M[p] = V[p] @ U[p]: (64, T, C) x (64, C, O) -> (64, T, O), in the
    kernel's compiled tile ``THREE_PASS_BLOCKS``."""
    p, t, c = v.shape
    o = u.shape[-1]
    if p != TILE * TILE or u.shape[:2] != (p, c):
        raise ValueError(f"tuple_multiply: v {tuple(v.shape)}, "
                         f"u {tuple(u.shape)}")
    _check_impl(impl)
    if impl == "torch":
        return tuple_multiply_ref(v, u)
    _build.require_cuda_operands("tuple_multiply", v, u)
    m = torch.empty((p, t, o), device=v.device, dtype=torch.float32)
    if m.numel():
        fn = _build.load("winograd_3pass", "repro_winograd_tuple_multiply",
                         _TUPLE_ARGTYPES)
        err = fn(v.data_ptr(), u.data_ptr(), m.data_ptr(), t, c, o,
                 _build.stream_handle(v))
        _build.check(err, "tuple_multiply")
        tuple_multiply.launches += 1
    return m


def output_transform(
    m: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """Y = act(A^T M A + bias): (8, 8, T, O) -> (T, 6, 6, O)."""
    _, _, t, o = m.shape
    if m.shape[:2] != (TILE, TILE) or (bias is not None and bias.shape != (o,)):
        raise ValueError(f"output_transform: m {tuple(m.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    _check_impl(impl)
    if impl == "torch":
        return output_transform_ref(m, bias, activation)
    _build.require_cuda_operands("output_transform", m, bias)
    y = torch.empty((t, OUT_TILE, OUT_TILE, o), device=m.device,
                    dtype=torch.float32)
    if y.numel():
        fn = _build.load("winograd_3pass", "repro_winograd_output_transform",
                         _OUTPUT_ARGTYPES)
        err = fn(m.data_ptr(), bias.data_ptr() if bias is not None else None,
                 y.data_ptr(), t, o, ACTIVATION_CODES[activation],
                 _build.stream_handle(m))
        _build.check(err, "output_transform")
        output_transform.launches += 1
    return y


#: Kernel launches since the count was last set to 0.
input_transform.launches = 0
tuple_multiply.launches = 0
output_transform.launches = 0


def conv2d_winograd_padded_call(
    x_sp: torch.Tensor,
    u: torch.Tensor,
    oh: int,
    ow: int,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
    fused: bool = True,
) -> torch.Tensor:
    """The Winograd conv on spatially padded, channel-aligned input.

    ``x_sp`` (B, H+2ph, W+2pw, Cp) carries the conv's spatial padding and
    Cp % BC == 0; ``u`` (8, 8, Cp, O) is the transformed weight.  ``fused``
    picks the realization: the fused kernel, or the three 3-pass kernels
    (``blocks`` is then ``THREE_PASS_BLOCKS`` or None).  Returns
    (B, OH, OW, O): the 6-multiple tail rows and columns hold act(bias), not
    conv output, so they are cropped here.
    """
    b, cp = x_sp.shape[0], x_sp.shape[-1]
    o = u.shape[-1]
    tiles, nth, ntw = _tile_input(x_sp, oh, ow)      # (B, nTH, nTW, 8, 8, Cp)
    t = b * nth * ntw
    tiles = tiles.reshape(t, TILE, TILE, cp)
    if fused:
        y = fused_winograd(tiles, u, blocks, bias, activation, impl)
    else:
        if blocks is not None and tuple(blocks) != THREE_PASS_BLOCKS:
            raise ValueError(f"3-pass Winograd: blocks {tuple(blocks)} (the "
                             f"tuple multiply takes {THREE_PASS_BLOCKS})")
        v = input_transform(tiles, impl)                 # (8, 8, T, Cp)
        m = tuple_multiply(v.reshape(TILE * TILE, t, cp),
                           u.reshape(TILE * TILE, cp, o), impl)
        y = output_transform(m.reshape(TILE, TILE, t, o), bias, activation,
                             impl)
    y = y.reshape(b, nth, ntw, OUT_TILE, OUT_TILE, o).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, nth * OUT_TILE, ntw * OUT_TILE, o)
    return y[:, :oh, :ow, :]

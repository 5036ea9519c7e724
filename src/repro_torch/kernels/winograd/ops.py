"""Wrappers of the hand-written Winograd F(6,3) kernels, and the conv
around them.

Pipeline (paper §IV.B): tile -> input transform -> tuple multiply ->
output transform (+ bias, activation) -> untile, in one of two
realizations: the fused kernel (csrc/winograd_fused.cu: V and M never
leave the chip) or the 3-pass pipeline (csrc/winograd_3pass.cu: one kernel
per stage, V and M through device memory).  bf16 and fp16 operands run
their own kernels (csrc/winograd_fused_16.cu, csrc/winograd_3pass_16.cu:
the transforms in fp32, the products on the 16-bit tensor cores), through
the wrappers whose names end in 16; each wrapper takes its own operand
types and raises on any other.  The overlapping 8x8 tile
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
from repro_torch.core.winograd import OUT_TILE, TILE, SplitWeights, _tile_input
from repro_torch.kernels import _build
from repro_torch.kernels.winograd.ref import (
    fused_winograd16_ref,
    fused_winograd_ref,
    input_transform16_ref,
    input_transform_ref,
    output_transform16_ref,
    output_transform_ref,
    tuple_multiply16_ref,
    tuple_multiply_ref,
)
from repro_torch.util import HALF_DTYPES

BC = 8            # fused kernel: in channels per reduction step (C % BC == 0)
#: The fused kernel's compiled tile (bt, bc, bo): 16 tiles x 32 out
#: channels per block (512 threads, one (tile, out channel) pair each in
#: the output transform), in-channel steps of 8.
FUSED_BLOCKS: Tuple[int, int, int] = (16, BC, 32)
#: The 3-pass tuple multiply's compiled tile (bt, bc, bo): 64 tiles x 64
#: out channels per block, in-channel steps of 16.
THREE_PASS_BLOCKS: Tuple[int, int, int] = (64, 16, 64)
#: The 16-bit kernels' channel multiple (16-byte copies of 8 values).
BC_16 = 8
#: The 16-bit fused kernel's compiled tile: 16 tiles x 32 out channels per
#: block, in-channel steps of 16 (one m16n8k16 step).
FUSED_BLOCKS_16: Tuple[int, int, int] = (16, 16, 32)
#: The 16-bit tuple multiply's compiled tile: 64 tiles x 64 out channels
#: per block, in-channel steps of 32 (csrc/hmma16.cuh).
THREE_PASS_BLOCKS_16: Tuple[int, int, int] = (64, 32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
_INPUT_ARGTYPES = [_P, _P, _I, _I, _P]
_TUPLE_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]
_OUTPUT_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]
_ARGTYPES_16 = [_P] * 5 + [_I] * 7 + [_P]
_INPUT_ARGTYPES_16 = [_P, _P, _I, _I, _I, _P]
_TUPLE_ARGTYPES_16 = [_P] * 4 + [_I] * 4 + [_P]
_OUTPUT_ARGTYPES_16 = [_P, _P, _P, _I, _I, _I, _I, _P]


def pick_blocks(t: int, c: int, o: int, fused: bool = True,
                dtype: str = "float32") -> Tuple[int, int, int]:
    """(bt, bc, bo) for T tiles and C -> O channels, for the realization
    that runs in ``dtype``: each kernel's compiled tile, whatever the shape
    (``FUSED_BLOCKS_16`` and ``THREE_PASS_BLOCKS_16`` in bf16 and fp16).

    Fused: ``FUSED_BLOCKS``; the block keeps the 64 positions' M of its
    16 x 32 (tile, out channel) pairs as tensor-core accumulators and
    stages each chunk of U once for its 16 tiles.  3-pass: the tuple
    multiply's tile, ``THREE_PASS_BLOCKS``; the two transforms take one
    (tile, channel) pair per thread and no block.
    """
    if dtype in HALF_DTYPES:
        return FUSED_BLOCKS_16 if fused else THREE_PASS_BLOCKS_16
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
    _build.require_dtype("fused_winograd", torch.float32, tiles, u, bias)
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
    _build.require_dtype("input_transform", torch.float32, tiles)
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
    _build.require_dtype("tuple_multiply", torch.float32, v, u)
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
    _build.require_dtype("output_transform", torch.float32, m, bias)
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


def fused_winograd16(
    tiles: torch.Tensor,
    u: torch.Tensor,
    inv_scale: torch.Tensor,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """bf16 or fp16 (T, 8, 8, C) x split U (2, 8, 8, C, O) -> (T, 6, 6, O)
    in their type; C % BC_16 == 0, C > 0, ``inv_scale`` fp32 (64,),
    ``bias`` fp32 (O,) or None (core/winograd.py::split_transformed makes
    ``u`` and ``inv_scale``).

    ``blocks`` is ``FUSED_BLOCKS_16`` (or None).  V is split into hi and lo
    parts of the operands' type and each product is three 16-bit products
    summed in fp32 on the tensor cores; the output is rounded once.
    """
    t, _, _, c = tiles.shape
    o = u.shape[-1]
    if (tiles.shape[1:3] != (TILE, TILE)
            or u.shape[:4] != (2, TILE, TILE, c) or c % BC_16 or not c
            or inv_scale.shape != (TILE * TILE,)):
        raise ValueError(f"fused_winograd_16: tiles {tuple(tiles.shape)}, u "
                         f"{tuple(u.shape)}, inv_scale "
                         f"{tuple(inv_scale.shape)} (C must be a positive "
                         f"multiple of {BC_16})")
    if blocks is not None and tuple(blocks) != FUSED_BLOCKS_16:
        raise ValueError(f"fused_winograd_16: blocks {tuple(blocks)} (the "
                         f"kernel takes its compiled tile {FUSED_BLOCKS_16})")
    _check_impl(impl)
    dtype = _build.require_16bit("fused_winograd_16", tiles, u)
    _build.require_dtype("fused_winograd_16", torch.float32, inv_scale, bias)
    if impl == "torch":
        return fused_winograd16_ref(tiles, u, inv_scale, bias, activation)
    _build.require_cuda_operands("fused_winograd_16", tiles, u, dtype=dtype)
    _build.require_cuda_operands("fused_winograd_16", inv_scale, bias)
    if tiles.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("fused_winograd_16: tiles and u must be 16-byte "
                         "aligned")
    out = torch.empty((t, OUT_TILE, OUT_TILE, o), device=tiles.device,
                      dtype=dtype)
    if out.numel():
        bt, _, bo = FUSED_BLOCKS_16
        fn = _build.load("winograd_fused_16", "repro_winograd16_fused",
                         _ARGTYPES_16)
        err = fn(tiles.data_ptr(), u.data_ptr(), inv_scale.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), t, c, o, bt, bo, ACTIVATION_CODES[activation],
                 _build.DTYPE16_CODES[dtype], _build.stream_handle(tiles))
        _build.check(err, "fused_winograd_16")
        fused_winograd16.launches += 1
    return out


def input_transform16(tiles: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """V = B^T d B in fp32 on bf16 or fp16 tiles: (T, 8, 8, C) -> (8, 8,
    T, C), rounded to their type."""
    t, _, _, c = tiles.shape
    if tiles.shape[1:3] != (TILE, TILE):
        raise ValueError(f"input_transform_16: tiles {tuple(tiles.shape)}")
    _check_impl(impl)
    dtype = _build.require_16bit("input_transform_16", tiles)
    if impl == "torch":
        return input_transform16_ref(tiles)
    _build.require_cuda_operands("input_transform_16", tiles, dtype=dtype)
    v = torch.empty((TILE, TILE, t, c), device=tiles.device, dtype=dtype)
    if v.numel():
        fn = _build.load("winograd_3pass_16",
                         "repro_winograd16_input_transform",
                         _INPUT_ARGTYPES_16)
        err = fn(tiles.data_ptr(), v.data_ptr(), t, c,
                 _build.DTYPE16_CODES[dtype], _build.stream_handle(tiles))
        _build.check(err, "input_transform_16")
        input_transform16.launches += 1
    return v


def tuple_multiply16(v: torch.Tensor, u: torch.Tensor,
                     inv_scale: torch.Tensor,
                     impl: str = "cuda") -> torch.Tensor:
    """M[p] = V[p] @ U[p] on bf16 or fp16 V (64, T, C) and split U (2, 64,
    C, O) (hi and lo of U * 2^k, ``inv_scale`` (64,) = 2^-k), the two
    products summed in fp32, scaled back and rounded to V's type: (64, T,
    O), in the kernel's compiled tile ``THREE_PASS_BLOCKS_16``; C % BC_16
    == 0 under ``impl='cuda'``."""
    p, t, c = v.shape
    o = u.shape[-1]
    if (p != TILE * TILE or u.shape[:3] != (2, p, c)
            or inv_scale.shape != (p,)):
        raise ValueError(f"tuple_multiply_16: v {tuple(v.shape)}, "
                         f"u {tuple(u.shape)}, inv_scale "
                         f"{tuple(inv_scale.shape)}")
    _check_impl(impl)
    dtype = _build.require_16bit("tuple_multiply_16", v, u)
    _build.require_dtype("tuple_multiply_16", torch.float32, inv_scale)
    if impl == "torch":
        return tuple_multiply16_ref(v, u, inv_scale)
    _build.require_cuda_operands("tuple_multiply_16", v, u, dtype=dtype)
    _build.require_cuda_operands("tuple_multiply_16", inv_scale)
    if c % BC_16 or v.data_ptr() % 16:
        raise ValueError(f"tuple_multiply_16: C must be a multiple of "
                         f"{BC_16} and V 16-byte aligned, got C = {c}")
    m = torch.empty((p, t, o), device=v.device, dtype=dtype)
    if m.numel():
        fn = _build.load("winograd_3pass_16", "repro_winograd16_tuple_multiply",
                         _TUPLE_ARGTYPES_16)
        err = fn(v.data_ptr(), u.data_ptr(), inv_scale.data_ptr(),
                 m.data_ptr(), t, c, o, _build.DTYPE16_CODES[dtype],
                 _build.stream_handle(v))
        _build.check(err, "tuple_multiply_16")
        tuple_multiply16.launches += 1
    return m


def output_transform16(
    m: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """Y = act(A^T M A + bias) in fp32 on bf16 or fp16 M: (8, 8, T, O) ->
    (T, 6, 6, O), rounded to its type; ``bias`` fp32 (O,) or None."""
    _, _, t, o = m.shape
    if m.shape[:2] != (TILE, TILE) or (bias is not None and bias.shape != (o,)):
        raise ValueError(f"output_transform_16: m {tuple(m.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    _check_impl(impl)
    dtype = _build.require_16bit("output_transform_16", m)
    _build.require_dtype("output_transform_16", torch.float32, bias)
    if impl == "torch":
        return output_transform16_ref(m, bias, activation)
    _build.require_cuda_operands("output_transform_16", m, dtype=dtype)
    _build.require_cuda_operands("output_transform_16", bias)
    y = torch.empty((t, OUT_TILE, OUT_TILE, o), device=m.device, dtype=dtype)
    if y.numel():
        fn = _build.load("winograd_3pass_16",
                         "repro_winograd16_output_transform",
                         _OUTPUT_ARGTYPES_16)
        err = fn(m.data_ptr(), bias.data_ptr() if bias is not None else None,
                 y.data_ptr(), t, o, ACTIVATION_CODES[activation],
                 _build.DTYPE16_CODES[dtype], _build.stream_handle(m))
        _build.check(err, "output_transform_16")
        output_transform16.launches += 1
    return y


#: Kernel launches since the count was last set to 0.
fused_winograd16.launches = 0
input_transform16.launches = 0
tuple_multiply16.launches = 0
output_transform16.launches = 0


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
    Cp % BC == 0; ``u`` (8, 8, Cp, O) is the transformed weight (for bf16
    or fp16 ``x_sp``, which runs the 16-bit kernels, a ``SplitWeights`` of
    its type).  ``fused`` picks the realization: the fused kernel, or the
    three 3-pass kernels (``blocks`` is then that realization's compiled
    tile or None).  Returns
    (B, OH, OW, O): the 6-multiple tail rows and columns hold act(bias), not
    conv output, so they are cropped here.
    """
    b, cp = x_sp.shape[0], x_sp.shape[-1]
    o = u.shape[-1]
    tiles, nth, ntw = _tile_input(x_sp, oh, ow)      # (B, nTH, nTW, 8, 8, Cp)
    t = b * nth * ntw
    tiles = tiles.reshape(t, TILE, TILE, cp)
    half = x_sp.dtype in _build.DTYPE16_CODES
    if half and not isinstance(u, SplitWeights):
        raise ValueError("16-bit Winograd takes split weights "
                         "(core/winograd.py::split_transformed)")
    if fused and half:
        y = fused_winograd16(tiles, u.hl, u.inv_scale, blocks, bias,
                             activation, impl)
    elif fused:
        y = fused_winograd(tiles, u, blocks, bias, activation, impl)
    else:
        want = THREE_PASS_BLOCKS_16 if half else THREE_PASS_BLOCKS
        if blocks is not None and tuple(blocks) != want:
            raise ValueError(f"3-pass Winograd: blocks {tuple(blocks)} (the "
                             f"tuple multiply takes {want})")
        if half:
            v = input_transform16(tiles, impl)           # (8, 8, T, Cp)
            m = tuple_multiply16(v.reshape(TILE * TILE, t, cp),
                                 u.hl.reshape(2, TILE * TILE, cp, o),
                                 u.inv_scale, impl)
            y = output_transform16(m.reshape(TILE, TILE, t, o), bias,
                                   activation, impl)
        else:
            v = input_transform(tiles, impl)             # (8, 8, T, Cp)
            m = tuple_multiply(v.reshape(TILE * TILE, t, cp),
                               u.reshape(TILE * TILE, cp, o), impl)
            y = output_transform(m.reshape(TILE, TILE, t, o), bias,
                                 activation, impl)
    y = y.reshape(b, nth, ntw, OUT_TILE, OUT_TILE, o).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, nth * OUT_TILE, ntw * OUT_TILE, o)
    return y[:, :oh, :ow, :]

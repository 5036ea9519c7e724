"""Plain PyTorch versions of the Winograd kernels, written with the
transform matrices of core/winograd.py.

The three stages of the 3-pass pipeline are the plain definition; the
fused kernel's plain version is their composition, so both realizations
share it.  The 16-bit versions upcast their bf16 or fp16 operands, compute
in fp32 and round to the operands' type where the 16-bit kernels round:
V, M and the output in the 3-pass pipeline, the output in the fused kernel
(whose V is split into two 16-bit parts and whose M stays fp32); U comes
split into hi and lo parts (core/winograd.py::split_transformed) and both
are multiplied, as the kernels multiply them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv_spec import apply_activation
from repro_torch.core.winograd import AT, BT, TILE, _const

#: The 16-bit fused kernel's in-channel chunk (one m16n8k16 step): the unit
#: its split of C counts in.
SPLIT_CHUNK_16 = 16


def input_transform_ref(tiles: torch.Tensor) -> torch.Tensor:
    """V = B^T d B: (T, 8, 8, C) -> (8, 8, T, C)."""
    bt = _const(BT, tiles)
    return torch.einsum("ai,bj,tijc->abtc", bt, bt, tiles)


def tuple_multiply_ref(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """M[p] = V[p] @ U[p]: (64, T, C) x (64, C, O) -> (64, T, O)."""
    return torch.matmul(v, u)


def output_transform_ref(m: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         activation: str = "linear") -> torch.Tensor:
    """Y = act(A^T M A + bias): (8, 8, T, O) -> (T, 6, 6, O)."""
    at = _const(AT, m)
    y = torch.einsum("xa,yb,abto->txyo", at, at, m)
    if bias is not None:
        y = y + bias
    return apply_activation(y, activation)


def fused_winograd_ref(tiles: torch.Tensor, u: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       activation: str = "linear") -> torch.Tensor:
    """(T, 8, 8, C) x (8, 8, C, O) -> act(A^T M A + bias): (T, 6, 6, O)."""
    t, c, o = tiles.shape[0], tiles.shape[-1], u.shape[-1]
    v = input_transform_ref(tiles).reshape(TILE * TILE, t, c)
    m = tuple_multiply_ref(v, u.reshape(TILE * TILE, c, o))
    return output_transform_ref(m.reshape(TILE, TILE, t, o), bias, activation)


def input_transform16_ref(tiles: torch.Tensor) -> torch.Tensor:
    """V = B^T d B in fp32 on bf16 or fp16 tiles, rounded to their type."""
    return input_transform_ref(tiles.float()).to(tiles.dtype)


def _split(x: torch.Tensor, dtype: torch.dtype):
    """fp32 x as hi + lo of ``dtype``, in fp32."""
    hi = x.to(dtype)
    return hi.float(), (x - hi.float()).to(dtype).float()


def tuple_multiply16_ref(v: torch.Tensor, u: torch.Tensor,
                         inv_scale: torch.Tensor) -> torch.Tensor:
    """M[p] = (V[p] @ U hi[p] + V[p] @ U lo[p]) * inv_scale[p] in fp32,
    rounded to v's type: v (64, T, C), u (2, 64, C, O) (the kernel's two
    products of split U, core/winograd.py::split_transformed)."""
    vf = v.float()
    m = vf @ u[0].float() + vf @ u[1].float()
    return (m * inv_scale.reshape(-1, 1, 1)).to(v.dtype)


def output_transform16_ref(m: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           activation: str = "linear") -> torch.Tensor:
    """Y = act(A^T M A + bias) in fp32 on bf16 or fp16 M, rounded to its
    type."""
    return output_transform_ref(m.float(), bias, activation).to(m.dtype)


def fused_winograd16_ref(tiles: torch.Tensor, u: torch.Tensor,
                         inv_scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         activation: str = "linear",
                         splits: int = 1) -> torch.Tensor:
    """The fused kernel's function on bf16 or fp16 tiles and split U (2,
    8, 8, C, O): V in fp32, split into hi + lo of the tiles' type, M[p] =
    (V lo U hi + V hi U lo + V hi U hi)[p] * inv_scale[p] in fp32 (the
    kernel's three products), the output transform in fp32, rounded.

    With ``splits`` > 1, as the kernel splits C: split s takes the
    16-channel chunks [s n / splits, (s + 1) n / splits) of the n =
    ceil(C / 16), its fp32 partial output A^T M_s A is summed with the
    others in split order, then the bias and the activation, then one
    rounding."""
    t, c, o = tiles.shape[0], tiles.shape[-1], u.shape[-1]
    vh, vl = _split(input_transform_ref(tiles.float()).reshape(
        TILE * TILE, t, c), tiles.dtype)
    uh = u[0].float().reshape(TILE * TILE, c, o)
    ul = u[1].float().reshape(TILE * TILE, c, o)
    scale = inv_scale.reshape(-1, 1, 1)
    if splits == 1:
        m = (vl @ uh + vh @ ul + vh @ uh) * scale
        return output_transform_ref(m.reshape(TILE, TILE, t, o), bias,
                                    activation).to(tiles.dtype)
    chunks = -(-c // SPLIT_CHUNK_16)
    if not 1 <= splits <= chunks:
        raise ValueError(f"splits must be in [1, {chunks}], got {splits}")
    y = None
    for s in range(splits):
        lo = s * chunks // splits * SPLIT_CHUNK_16
        hi = min((s + 1) * chunks // splits * SPLIT_CHUNK_16, c)
        m = (vl[..., lo:hi] @ uh[:, lo:hi] + vh[..., lo:hi] @ ul[:, lo:hi]
             + vh[..., lo:hi] @ uh[:, lo:hi]) * scale
        part = output_transform_ref(m.reshape(TILE, TILE, t, o))
        y = part if y is None else y + part
    if bias is not None:
        y = y + bias
    return apply_activation(y, activation).to(tiles.dtype)

"""Plain PyTorch versions of the Winograd kernels, written with the
transform matrices of core/winograd.py.

The three stages of the 3-pass pipeline are the plain definition; the
fused kernel's plain version is their composition, so both realizations
share it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv_spec import apply_activation
from repro_torch.core.winograd import AT, BT, TILE, _const


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

"""Plain PyTorch version of the fused Winograd kernel: the three stages
written out with the transform matrices of core/winograd.py."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv_spec import apply_activation
from repro_torch.core.winograd import AT, BT, _const


def fused_winograd_ref(tiles: torch.Tensor, u: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       activation: str = "linear") -> torch.Tensor:
    """(T, 8, 8, C) x (8, 8, C, O) -> act(A^T M A + bias): (T, 6, 6, O)."""
    bt, at = _const(BT, tiles), _const(AT, tiles)
    v = torch.einsum("ai,bj,tijc->abtc", bt, bt, tiles)      # V = B^T d B
    m = torch.matmul(v, u)                                  # (8, 8, T, O)
    y = torch.einsum("xa,yb,abto->txyo", at, at, m)         # Y = A^T M A
    if bias is not None:
        y = y + bias
    return apply_activation(y, activation)

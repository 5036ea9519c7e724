"""Tiny shared helpers used across core and kernels."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ceil_to(x: int, q: int) -> int:
    """Round ``x`` up to the next multiple of ``q``."""
    return -(-x // q) * q


def pad_bias_row(bias: Optional[torch.Tensor], n_padded: int) -> Optional[torch.Tensor]:
    """(O,) bias -> (n_padded,) bias, zero-padded on the tail.

    The CUDA kernels read the bias as a flat (O,) vector, so unlike the TPU
    reference no (1, N) row shape is needed; only the tail pad remains.
    """
    if bias is None:
        return None
    n = bias.shape[0]
    return F.pad(bias, (0, n_padded - n)) if n_padded != n else bias

"""Block-wise int8 quantization of optimizer moments (8-bit Adam): the
port of ``repro/optim/quantized_state.py``.

A moment is stored as int8 with one fp32 scale per block of ``BLOCK``
elements of its flattened values (zero-padded to a whole block): scale =
max |block| / 127, q = round(x / max(scale, 1e-12)) clipped to +-127.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
and scales equal the reference's on the same fp32 values.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

BLOCK = 256


class QTensor:
    """int8 payload (-1, BLOCK) and per-block fp32 scales (-1,); the
    original shape kept as plain data."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, shape):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)

    # A tree node of repro_torch.tree: children named as the reference's
    # pytree flattening names them.
    def tree_children(self):
        return [("0", self.q), ("1", self.scale)]

    def tree_rebuild(self, values) -> "QTensor":
        return QTensor(values[0], values[1], self.shape)

    def __repr__(self) -> str:
        return f"QTensor(shape={self.shape})"


def _pad_len(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def quantize(x: torch.Tensor) -> QTensor:
    shape: Tuple[int, ...] = tuple(x.shape)
    flat = x.reshape(-1).to(torch.float32)
    pad = _pad_len(flat.numel()) - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = scale.clamp_min(1e-12)
    q = torch.round(blocks / safe[:, None]).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale, shape=shape)


def dequantize(t: QTensor) -> torch.Tensor:
    flat = (t.q.to(torch.float32) * t.scale[:, None]).reshape(-1)
    return flat[:math.prod(t.shape)].reshape(t.shape)

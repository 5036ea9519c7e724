"""Synthetic image batches for the CNN examples: the port of
``repro/data/images.py`` (smooth waves plus noise, NHWC fp32), drawn from
a CPU generator seeded from (seed, step), then moved to the device."""
from __future__ import annotations

import torch

from repro_torch.data.tokens import generator


def image_batch(step: int, batch: int, h: int, w: int, channels: int = 3,
                seed: int = 0, device=None) -> torch.Tensor:
    gen = generator(seed, step)
    yy = torch.linspace(0, 6.28, h)[None, :, None, None]
    xx = torch.linspace(0, 6.28, w)[None, None, :, None]
    phase = torch.rand((batch, 1, 1, channels), generator=gen) * 6.28
    img = torch.sin(yy + phase) * torch.cos(2 * xx - phase)
    noise = torch.randn((batch, h, w, channels), generator=gen)
    return (img + 0.1 * noise).to(device=device, dtype=torch.float32)

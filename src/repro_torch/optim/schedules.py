"""Learning-rate schedules: the port of ``repro/optim/schedules.py``.

Each is a pure function of the step counter, a device tensor, returning
an fp32 device tensor: nothing is read back to the host, so a train step
that calls one can be captured as a CUDA graph.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``final_frac``
    of it at ``total_steps``."""
    def fn(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = ((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn

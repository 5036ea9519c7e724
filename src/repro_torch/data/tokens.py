"""Deterministic synthetic data: the port of ``repro/data/tokens.py``.

A batch is a pure function of (seed, step): it is drawn from a CPU
``torch.Generator`` seeded from (seed, step, tag) alone, then moved to the
device, so every device and every restart regenerates any step's data
(no data-loader state in a checkpoint beyond the step counter).  The bits
differ from ``jax.random``'s; the structure is the reference's: a noisy
affine Markov chain over the vocab (``tokens[t+1] = (7 tokens[t] + 31) %
V`` with probability 0.8, else a uniform draw), labels the stream shifted
by one, audio targets with a mask at 0.08, vision patches from a normal,
the shapes and dtypes of ``configs.input_specs``.  The chain has learnable
structure, so training on it reduces the loss.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finalizer: one 64-bit integer to another, well mixed."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def generator(seed: int, step: int, tag: int = 0) -> torch.Generator:
    """A CPU generator seeded from (seed, step, tag) alone (the reference
    folds step and tag into its key)."""
    s = _mix(_mix(_mix(seed) ^ step) ^ tag)
    return torch.Generator().manual_seed(s & ((1 << 63) - 1))


def markov_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int,
                  noise: float = 0.2) -> torch.Tensor:
    """(batch, seq) int32: tokens[t+1] = (a tokens[t] + c) % vocab with
    probability 1 - noise, else a uniform draw; the first token follows a
    uniform start token, as the reference's scan."""
    a, c = 7, 31
    tok = torch.randint(0, vocab, (batch,), generator=gen)
    flips = torch.rand((batch, seq), generator=gen) < noise
    rand = torch.randint(0, vocab, (batch, seq), generator=gen)
    out = torch.empty((batch, seq), dtype=torch.int64)
    for t in range(seq):
        tok = torch.where(flips[:, t], rand[:, t], (a * tok + c) % vocab)
        out[:, t] = tok
    return out.to(torch.int32)


def batch_for(cfg: ModelConfig, shape: ShapeSpec, step: int, seed: int = 0,
              device=None) -> Dict[str, torch.Tensor]:
    """One global batch matching ``configs.input_specs``, on ``device``."""
    b, s = shape.global_batch, shape.seq_len
    gen = generator(seed, step)

    if shape.kind == "decode":
        out = {"tokens": torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                                       dtype=torch.int32)}
    elif cfg.frontend == "audio_frames":
        out = {"frames": torch.randn((b, s, cfg.frontend_dim), generator=gen)}
        if shape.kind == "train":
            out["targets"] = torch.randint(0, cfg.vocab_size, (b, s),
                                           generator=gen, dtype=torch.int32)
            out["mask"] = torch.rand((b, s), generator=gen) < 0.08
    else:
        s_text = s - cfg.num_patches if cfg.frontend == "vision_patches" else s
        stream = markov_tokens(gen, b, s_text + 1, cfg.vocab_size)
        out = {"tokens": stream[:, :-1].contiguous()}
        if cfg.frontend == "vision_patches":
            out["patch_embeds"] = torch.randn(
                (b, cfg.num_patches, cfg.frontend_dim),
                generator=generator(seed, step, 1))
        if shape.kind == "train":
            out["labels"] = stream[:, 1:].contiguous()
    return {k: v.to(device) for k, v in out.items()}

"""Plain PyTorch version of the flash-attention kernel: the port of
``repro/kernels/flash_attention/ref.py::attention_ref``.

A masked softmax in fp32 with the reference's casts: scores from fp32
copies of q and k, divided by sqrt(hd), the tanh softcap, the finite
``NEG_INF`` mask, the probabilities cast to v's type before the product
with v, the output in q's type.  Layouts are the kernel's: q (B, S, H, hd),
k and v (B, Sk, KV, hd), query head h on KV head h // (H // KV).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def attention_mask(s: int, sk: int, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """(S, Sk) validity of (query, key) pairs; positions start at 0."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Sk, KV, hd) -> (B, S, H, hd) in q's dtype.

    Runs one (batch, KV head) group at a time, so the fp32 scores it holds
    are (H // KV, S, Sk), not (B, H, S, Sk).
    """
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    mask = attention_mask(s, sk, causal, window, q.device)
    out = torch.empty_like(q)
    for bi in range(b):
        for j in range(kv):
            qg = q[bi, :, j * g:(j + 1) * g].float().transpose(0, 1)  # (G, S, hd)
            kj = k[bi, :, j].float()                                  # (Sk, hd)
            scores = (qg @ kj.T) / math.sqrt(hd)
            if logit_cap > 0:
                scores = torch.tanh(scores / logit_cap) * logit_cap
            scores = torch.where(mask, scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
            o = probs @ v[bi, :, j].float()                           # (G, S, hd)
            out[bi, :, j * g:(j + 1) * g] = o.transpose(0, 1).to(q.dtype)
    return out

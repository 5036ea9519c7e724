"""Plain PyTorch versions of the flash-attention kernels: the port of
``repro/kernels/flash_attention/ref.py::attention_ref``, the same forward
returning the row statistic the backward reads (``attention_ref_lse``),
and the backward from it (``attention_bwd_ref``); the pairs a mask keeps
(``unmasked_pairs``), which the kernels' bounds count.

The forward is a masked softmax in fp32 with the reference's casts: scores
from fp32 copies of q and k, divided by sqrt(hd), the tanh softcap, the
finite ``NEG_INF`` mask, the probabilities cast to v's type before the
product with v, the output in q's type.  Layouts are the kernel's: q (B,
S, H, hd), k and v (B, Sk, KV, hd), query head h on KV head h // (H //
KV).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

NEG_INF = -2.3819763e38
LOG2E = 1.4426950408889634


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


def unmasked_pairs(s: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs an attention call must compute: keys below
    Sk, at or before the query (causal) and inside its window; the pairs
    ``attention_mask`` keeps, counted without building it."""
    q = np.arange(s)
    hi = np.minimum(q, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _scaled(qg: torch.Tensor, kj: torch.Tensor, logit_cap: float):
    """(the scaled score y = q.k / sqrt(hd), the softcapped score s~ of
    each pair: y, or tanh(y / cap) * cap) in fp32."""
    y = (qg @ kj.T) / math.sqrt(qg.shape[-1])
    return y, (torch.tanh(y / logit_cap) * logit_cap if logit_cap > 0 else y)


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      logit_cap: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, S, H, hd) in q's dtype, lse (B, H, S) fp32): the forward
    and each row's log-sum-exp of its valid softcapped scores, in base 2
    (the natural one times log2 e), as the kernel writes it.

    Runs one (batch, KV head) group at a time, so the fp32 scores it holds
    are (H // KV, S, Sk), not (B, H, S, Sk).
    """
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    mask = attention_mask(s, sk, causal, window, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for bi in range(b):
        for j in range(kv):
            qg = q[bi, :, j * g:(j + 1) * g].float().transpose(0, 1)  # (G, S, hd)
            _, scores = _scaled(qg, k[bi, :, j].float(), logit_cap)
            scores = torch.where(mask, scores, NEG_INF)
            lse[bi, j * g:(j + 1) * g] = torch.logsumexp(scores, -1) * LOG2E
            probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
            o = probs @ v[bi, :, j].float()                           # (G, S, hd)
            out[bi, :, j * g:(j + 1) * g] = o.transpose(0, 1).to(q.dtype)
    return out, lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Sk, KV, hd) -> (B, S, H, hd) in q's dtype."""
    return attention_ref_lse(q, k, v, causal, window, logit_cap)[0]


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      logit_cap: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes, step by step as the backward
    kernel computes them, in fp32 (in float64 for float64 inputs), one
    (batch, KV head) group at a time: p = exp2(s~ log2 e - lse) on a valid
    pair (else 0); dv = p^T dout; dp = dout v^T; D = rowsum(dout o out);
    ds = p (dp - D) / sqrt(hd) times 1 - tanh^2(y / cap) with a softcap;
    dq = ds k; dk = ds^T q, dk and dv summed over the group's query heads.

    fp32 inputs take D as rowsum(p o dp) / rowsum(p): the form ``jax.vjp``
    of the reference's softmax takes (there the row sum is 1), over the
    row sum, which an lse from another forward (the kernel's) leaves 1
    only to fp32's rounding (a row with no valid key takes D = 0).  It equals rowsum(dout o out) in exact
    arithmetic, but where a row's gradient cancels (a causal first row:
    one key) it gives D = dp and dq = 0, as jax's, where rowsum(dout o
    out) keeps the rounding of two fp32 sums of the same hd products in
    other orders.  The others keep the kernel's form: a 16-bit out is
    rounded to 8 or 11 bits and the kernel's D reads it so (as SDPA's
    backward does), which p o dp would miss by more than the bf16 row
    gate; float64 copies of fp32 inputs (lse too) give the kernel's steps
    to float64's rounding, which the card's fp32 gates hold the kernel
    against (there out is a one-key row's v, so rowsum(dout o out)
    cancels it).
    """
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    exact_d = q.dtype == torch.float32
    mask = attention_mask(s, sk, causal, window, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        for j in range(kv):
            heads = slice(j * g, (j + 1) * g)
            qg = q[bi, :, heads].to(acc).transpose(0, 1)            # (G, S, hd)
            dog = dout[bi, :, heads].to(acc).transpose(0, 1)
            kj, vj = k[bi, :, j].to(acc), v[bi, :, j].to(acc)       # (Sk, hd)
            y, scores = _scaled(qg, kj, logit_cap)
            p = torch.where(mask, torch.exp2(
                scores * LOG2E - lse[bi, heads, :, None].to(acc)), 0.0)
            dv[bi, :, j] = torch.einsum("gqk,gqd->kd", p, dog).to(v.dtype)
            dp = dog @ vj.T                                         # (G, S, Sk)
            if exact_d:
                # A row with no valid key has p = 0: D = 0, not 0 / 0.
                rowdot = ((p * dp).sum(-1, keepdim=True)            # (G, S, 1)
                          / p.sum(-1, keepdim=True).clamp_min(torch.finfo(acc).tiny))
            else:
                og = out[bi, :, heads].to(acc).transpose(0, 1)
                rowdot = (dog * og).sum(-1, keepdim=True)
            ds = p * (dp - rowdot) / math.sqrt(hd)
            if logit_cap > 0:
                ds = ds * (1 - torch.tanh(y / logit_cap).square())
            dq[bi, :, heads] = (ds @ kj).transpose(0, 1).to(q.dtype)
            dk[bi, :, j] = torch.einsum("gqk,gqd->kd", ds, qg).to(k.dtype)
    return dq, dk, dv

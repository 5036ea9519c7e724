"""Grouped-query attention: prefill through the flash-attention kernel,
decode against ring-buffer KV caches.  The port of
``repro/models/attention.py``.

Supports GQA/MQA (any KV dividing H), RoPE, QKV bias (qwen1.5), the
attention logit softcap and local sliding windows (gemma2), and
bidirectional (encoder) masks.  A prefill attention under ``impl='cuda'``
is one launch of the hand-written kernel
(``kernels/flash_attention/csrc/flash_attention.cu``) at every length: the
reference's choice between its naive and chunked versions
(``attn_chunked_threshold``) bounds memory on the TPU, and both compute
the kernel's function.  Under ``impl='torch'`` the kernel's plain version
runs.  Decode attention against the ring cache stays plain PyTorch
(``_sdpa``), as the reference computes it outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, normal_init, softcap

NEG_INF = -2.3819763e38  # matches XLA's finite mask value

Params = Dict[str, torch.Tensor]


def init_attention(generator: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qkv_bias: bool,
                   dtype: torch.dtype, device=None) -> Params:
    def w(*shape):
        return normal_init(generator, shape, dtype=dtype, device=device)

    p = {
        "wq": w(d_model, num_heads * head_dim),
        "wk": w(d_model, num_kv_heads * head_dim),
        "wv": w(d_model, num_kv_heads * head_dim),
        "wo": w(num_heads * head_dim, d_model),
    }
    if qkv_bias:
        for name, n in (("bq", num_heads), ("bk", num_kv_heads),
                        ("bv", num_kv_heads)):
            p[name] = torch.zeros((n * head_dim,), dtype=dtype, device=device)
    return p


def _qkv(params: Params, x: torch.Tensor, num_heads: int, num_kv_heads: int,
         head_dim: int):
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv_heads, head_dim),
            v.reshape(b, s, num_kv_heads, head_dim))


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """(..., Sq, Sk) boolean validity mask from absolute positions."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, logit_cap: float) -> torch.Tensor:
    """q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), mask (B?,Sq,Sk) -> (B,Sq,KV,G,hd):
    scores in fp32, probabilities cast to v's dtype, output in q's."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    scores = softcap(scores / math.sqrt(hd), logit_cap)
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def ring_capacity(capacity: int, window: int) -> int:
    """Ring capacity of a layer's cache: a local layer keeps at most its
    window."""
    return capacity if window <= 0 else min(window, capacity)


def attention_block(
    params: Params,
    x: torch.Tensor,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    causal: bool,
    window: int,
    logit_cap: float,
    rope_theta: float,
    cache: Optional[Params] = None,
    cache_pos: Optional[torch.Tensor] = None,
    fill_capacity: Optional[int] = None,
    live: Optional[torch.Tensor] = None,
    impl: str = "cuda",
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full attention sub-block: qkv -> rope -> attention -> out-proj.

    Prefill (``cache`` None): positions 0..S-1, attention through
    ``flash_attention(..., impl=impl)``.  Decode: x is (B, 1, d), ``cache``
    holds the {'k', 'v', 'slot_pos'} ring buffers and ``cache_pos`` the
    absolute position of the new token, a scalar or a (B,) vector (each row
    at its own position, writing its own ring slot); ``live`` (B,) bool:
    the rows whose state may advance (None: every row).  The cache is
    updated in place and returned: each row's slot is written, every row
    attends to it, and a row that is not live gets its old slot back.
    The reference returns a new cache; writing one slot a row in place
    keeps the cache at fixed addresses, which a CUDA graph of the decode
    step needs, and copies nothing else.  ``fill_capacity``: prefill that
    also returns a cache of that capacity filled with this call's K/V.
    """
    b, s, _ = x.shape
    g = num_heads // num_kv_heads
    q, k, v = _qkv(params, x, num_heads, num_kv_heads, head_dim)

    if cache is not None:
        pos = torch.as_tensor(cache_pos, dtype=torch.int64,
                              device=x.device).reshape(-1).expand(b)
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)
        cap = cache["k"].shape[1]
        slot = pos % cap
        rows = torch.arange(b, device=x.device)
        new = {"k": k[:, 0], "v": v[:, 0],
               "slot_pos": pos.to(cache["slot_pos"].dtype)}
        old = ({name: cache[name][rows, slot] for name in new}
               if live is not None else None)
        for name, t in new.items():
            cache[name][rows, slot] = t
        k_pos = cache["slot_pos"]                             # (B, Sk)
        # Written slots at or before each row's position (and in its window).
        mask = (k_pos >= 0)[:, None, :] & _mask(pos[:, None], k_pos, True,
                                                window)       # (B, 1, Sk)
        qh = q.reshape(b, 1, num_kv_heads, g, head_dim)
        out = _sdpa(qh, cache["k"], cache["v"], mask, logit_cap)
        if old is not None:
            # Rows that are not live keep their old state (continuous
            # batching); their output above saw the new token, as the
            # reference's does.
            for name, t in new.items():
                keep = live.reshape((-1,) + (1,) * (t.ndim - 1))
                cache[name][rows, slot] = torch.where(keep, t, old[name])
        return out.reshape(b, 1, num_heads * head_dim) @ params["wo"], cache

    positions = torch.arange(s, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal, window, logit_cap, impl=impl)
    out = out.reshape(b, s, num_heads * head_dim) @ params["wo"]

    new_cache = None
    if fill_capacity is not None:
        cap = ring_capacity(fill_capacity, window)
        # Keep the last ``cap`` positions in ring layout (slot = pos % cap);
        # unwritten slots stay zero with position -1.
        keep = min(s, cap)
        keep_pos = positions[s - keep:]
        slots = keep_pos % cap
        new_cache = init_kv_cache(b, cap, num_kv_heads, head_dim, k.dtype,
                                  x.device)
        new_cache["k"][:, slots] = k[:, s - keep:]
        new_cache["v"][:, slots] = v[:, s - keep:]
        new_cache["slot_pos"][:, slots] = keep_pos.to(torch.int32)
    return out, new_cache


def init_kv_cache(batch: int, capacity: int, num_kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device=None) -> Params:
    return {
        "k": torch.zeros((batch, capacity, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "slot_pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                               device=device),
    }

"""The LM assembly for dense attention stacks: the port of
``repro/models/transformer.py``, its ``attn``/``local`` subset.

A model is a cycled ``layer_pattern`` of attention blocks ('attn' global,
'local' sliding window), each followed by an MLP, with optional post-norms
(gemma2) and a sqrt(d) embed scale.  Parameters are plain dicts of tensors:
``{"embed": {"table"}, "layers": [one dict per layer, in order],
"final_norm"}`` (plus ``"head"`` when embeddings are untied).  The
reference stacks full periods of the pattern for ``jax.lax.scan``; here the
layers are a plain list run by a Python loop, and ``params_from_numpy``
unstacks the reference's tree into it.  Caches are a list too, one
``{"k", "v", "slot_pos"}`` ring per layer.

MoE, rglru, mLSTM/sLSTM and the audio and vision frontends are not ported
yet: a config that needs one raises ``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    apply_mlp,
    embed,
    init_embedding,
    init_mlp,
    normal_init,
    rms_norm,
    softcap,
    torch_dtype,
    unembed,
)

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

#: Block types the port runs.
PORTED_BLOCKS = ("attn", "local")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config that needs an unported block."""
    missing = sorted(set(cfg.pattern_layers) - set(PORTED_BLOCKS))
    if cfg.num_experts:
        missing.append("moe")
    if cfg.frontend != "none":
        missing.append(cfg.frontend)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port runs "
            f"dense {'/'.join(PORTED_BLOCKS)} stacks (ROADMAP.md, queue 1, "
            f"item 7)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# Per-layer init / apply


def _init_layer(cfg: ModelConfig, generator: torch.Generator, btype: str,
                device) -> Params:
    dt, d = _dtype(cfg), cfg.d_model

    def norm():
        return torch.zeros((d,), dtype=torch.float32, device=device)

    p: Params = {"norm1": norm()}
    p["mixer"] = attn_lib.init_attention(
        generator, d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
        cfg.qkv_bias, dt, device)
    if cfg.use_post_norm:
        p["post_norm1"] = norm()
    if cfg.d_ff > 0 and cfg.mlp_type != "none":
        p["norm2"] = norm()
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.mlp_type, dt, device)
        if cfg.use_post_norm:
            p["post_norm2"] = norm()
    return p


def _apply_layer(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    btype: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
    fill_capacity: Optional[int] = None,
    live: Optional[torch.Tensor] = None,
    impl: str = "cuda",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, new_cache = attn_lib.attention_block(
        p["mixer"], h,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        causal=cfg.causal and not cfg.encoder_only,
        window=cfg.local_window if btype == "local" else 0,
        logit_cap=cfg.attn_logit_softcap,
        rope_theta=cfg.rope_theta,
        cache=cache,
        cache_pos=cache_pos,
        fill_capacity=fill_capacity,
        live=live,
        impl=impl,
    )
    if cfg.use_post_norm:
        out = rms_norm(out, p["post_norm1"], cfg.norm_eps)
    x = x + out
    if "mlp" in p:
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        out2 = apply_mlp(p["mlp"], h2, cfg.mlp_type)
        if cfg.use_post_norm:
            out2 = rms_norm(out2, p["post_norm2"], cfg.norm_eps)
        x = x + out2
    return x, new_cache


# ---------------------------------------------------------------------------
# Parameters


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters from ``generator`` (drawn on its device), placed
    on ``device`` (the generator's by default)."""
    check_supported(cfg)
    device = generator.device if device is None else device
    dt = _dtype(cfg)
    params: Params = {"embed": init_embedding(generator, cfg.vocab_size,
                                              cfg.d_model, dt, device)}
    if not cfg.tie_embeddings:
        params["head"] = normal_init(generator, (cfg.d_model, cfg.vocab_size),
                                     dtype=dt, device=device)
    params["layers"] = [_init_layer(cfg, generator, bt, device)
                        for bt in cfg.pattern_layers]
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                       device=device)
    return params


def _period_split(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """The reference's stacking: (periods, pattern, unrolled tail)."""
    pat = cfg.layer_pattern
    if not cfg.scan_layers:
        return 0, (), cfg.pattern_layers
    n_periods = cfg.num_layers // len(pat)
    if n_periods < 2:
        return 0, (), cfg.pattern_layers
    return n_periods, pat, cfg.pattern_layers[n_periods * len(pat):]


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def layers_from_tree(cfg: ModelConfig, tree: Params) -> List[Any]:
    """The per-layer subtrees of a reference parameter or cache tree, in
    layer order: ``tree["period"]["j:btype"]`` leaves are stacked
    ``(n_periods, ...)`` by ``jax.vmap`` and are unstacked period by
    period; ``tree["tail"]["j:btype"]`` holds the remaining layers."""
    n_periods, pat, tail = _period_split(cfg)
    layers = []
    for i in range(n_periods):
        for j, bt in enumerate(pat):
            layers.append(tree_map(lambda a, i=i: a[i], tree["period"][f"{j}:{bt}"]))
    for j, bt in enumerate(tail):
        layers.append(tree["tail"][f"{j}:{bt}"])
    return layers


def _tensor(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (bfloat16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(cfg: ModelConfig, tree: Params, device=None) -> Params:
    """The reference's parameter tree as numpy arrays (the output of
    ``jax.tree_util.tree_map(np.asarray, tf.init_params(cfg, key))``) as
    the port's parameters on ``device``, dtypes kept, layers unstacked in
    layer order."""
    check_supported(cfg)
    params: Params = {k: tree_map(lambda a: _tensor(a, device), tree[k])
                      for k in ("embed", "head", "final_norm") if k in tree}
    params["layers"] = [tree_map(lambda a: _tensor(a, device), layer)
                        for layer in layers_from_tree(cfg, tree)]
    return params


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)


def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = embed(params["embed"], tokens, scale_by_dim=cfg.embed_scale)
    return x.to(_dtype(cfg))


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   impl: str = "cuda") -> torch.Tensor:
    """Trunk forward: final-norm hidden states (B, S, d)."""
    x = _embed_tokens(cfg, params, tokens)
    for p, bt in zip(params["layers"], cfg.pattern_layers):
        x, _ = _apply_layer(cfg, p, x, bt, impl=impl)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def apply_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        logits = x @ params["head"]
    else:
        logits = unembed(params["embed"], x)
    return softcap(logits, cfg.final_logit_softcap)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            impl: str = "cuda") -> torch.Tensor:
    """Full-sequence forward (prefill): (B, S) tokens -> (B, S, V) logits
    in ``cfg.dtype``.  Every attention runs ``flash_attention`` with
    ``impl``."""
    return apply_head(cfg, params, forward_hidden(cfg, params, tokens, impl))


def prefill_with_cache(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                       capacity: int, impl: str = "cuda") -> Tuple[torch.Tensor, Cache]:
    """Forward over the prompt, returning (last-token logits (B, V), a
    decode-ready cache of the given capacity)."""
    x = _embed_tokens(cfg, params, tokens)
    cache: Cache = []
    for p, bt in zip(params["layers"], cfg.pattern_layers):
        x, c = _apply_layer(cfg, p, x, bt, fill_capacity=capacity, impl=impl)
        cache.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return apply_head(cfg, params, x[:, -1:, :])[:, 0, :], cache


# ---------------------------------------------------------------------------
# Decode


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None) -> Cache:
    """Empty ring caches, one per layer (a local layer's holds its window)."""
    check_supported(cfg)
    return [
        attn_lib.init_kv_cache(
            batch,
            attn_lib.ring_capacity(capacity,
                                   cfg.local_window if bt == "local" else 0),
            cfg.num_kv_heads, cfg.resolved_head_dim, _dtype(cfg), device)
        for bt in cfg.pattern_layers
    ]


def reset_cache_rows(cache: Cache, fresh: Cache, row) -> None:
    """Reinitialize batch row(s) ``row`` of ``cache`` from row 0 of
    ``fresh`` (a batch-1 cache from ``init_cache``), in place (the
    reference returns a new cache)."""
    for layer, init in zip(cache, fresh):
        for k, t in layer.items():
            t[row] = init[k][0]


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos, live: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode with cache update.  ``tokens`` (B, 1); ``pos`` the
    absolute position of the new token, a scalar or (B,) (per row, for
    continuous batching); ``live`` (B,) bool: the rows whose state may
    advance (None: every row).  Returns (logits (B, V), ``cache``), the
    cache updated in place (``attention_block``; the reference returns a
    new one): one ring slot a live row changes, at the same addresses, so
    a CUDA graph of the step replays against it."""
    x = _embed_tokens(cfg, params, tokens)
    for p, bt, c in zip(params["layers"], cfg.pattern_layers, cache):
        x, _ = _apply_layer(cfg, p, x, bt, cache=c, cache_pos=pos, live=live)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return apply_head(cfg, params, x)[:, 0, :], cache

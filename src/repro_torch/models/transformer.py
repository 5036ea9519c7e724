"""The model assembly: the port of ``repro/models/transformer.py``, every
block type and frontend of its ten configs.

A model is a cycled ``layer_pattern`` of mixer blocks ('attn' global,
'local' sliding window, 'rglru', 'mlstm', 'slstm'), each followed by an
MLP, or an MoE (with arctic's parallel dense MLP) when the config has
experts, with optional post-norms (gemma2) and a sqrt(d) embed scale.
Inputs are (B, S) tokens, or the reference's model-input dict:
``{"frames"}`` (audio: projected, no embedding, untied head) or
``{"tokens", "patch_embeds"}`` (vision: projected patches prepended to
the token embeddings, positions over the whole sequence).

Parameters are plain dicts of tensors: ``{"embed": {"table"}, "layers":
[one dict per layer, in order], "final_norm"}`` (plus ``"head"`` when
embeddings are untied, ``"frontend_proj"`` with a frontend).  The
reference stacks full periods of the pattern for ``jax.lax.scan``; here
the layers are a plain list run by a Python loop, and
``params_from_numpy`` unstacks the reference's tree into it.  Caches are
a list too, one dict per layer: a ``{"k", "v", "slot_pos"}`` ring for
attention, the recurrent state for the others.  Decode updates every
cache in place, so a CUDA graph of the step replays against fixed
addresses.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
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
from repro_torch.tree import tree_map

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]
#: (B, S) tokens, or a model-input dict ({"frames"} or {"tokens",
#: "patch_embeds"}).
Inputs = Union[torch.Tensor, Dict[str, torch.Tensor]]

AUX_KEYS = ("load_balance", "router_z", "dropped_frac")


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
    if btype in ("attn", "local"):
        p["mixer"] = attn_lib.init_attention(
            generator, d, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias, dt, device)
    elif btype == "rglru":
        p["mixer"] = rglru_lib.init_rglru_block(
            generator, d, cfg.resolved_d_rnn, cfg.conv_width, dt, device)
    elif btype == "mlstm":
        p["mixer"] = xlstm_lib.init_mlstm_block(generator, d, cfg.num_heads,
                                                dt, device)
    elif btype == "slstm":
        p["mixer"] = xlstm_lib.init_slstm_block(generator, d, cfg.num_heads,
                                                dt, device)
    else:
        raise ValueError(f"unknown block type {btype}")
    if cfg.use_post_norm:
        p["post_norm1"] = norm()

    if cfg.num_experts:
        p["norm2"] = norm()
        p["moe"] = moe_lib.init_moe(generator, d, cfg.d_ff, cfg.num_experts,
                                    dt, device)
        if cfg.moe_dense_ff:
            p["dense_mlp"] = init_mlp(generator, d, cfg.moe_dense_ff,
                                      "swiglu", dt, device)
        if cfg.use_post_norm:
            p["post_norm2"] = norm()
    elif cfg.d_ff > 0 and cfg.mlp_type != "none":
        p["norm2"] = norm()
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.mlp_type, dt, device)
        if cfg.use_post_norm:
            p["post_norm2"] = norm()
    return p


def _write_state(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                 live: Optional[torch.Tensor]) -> None:
    """Write a recurrent block's new state into ``cache`` in place; rows
    where ``live`` is False keep their old state (the reference's
    ``_mask_state_update``: a slot-local admission step must not fold its
    garbage tokens into the other rows' state)."""
    for name, old in cache.items():
        t = new[name]
        if live is not None:
            t = torch.where(live.reshape((-1,) + (1,) * (t.ndim - 1)), t, old)
        old.copy_(t)


def _apply_mixer(cfg: ModelConfig, p: Params, h: torch.Tensor, btype: str,
                 cache, cache_pos, fill_capacity, live, impl):
    fill = fill_capacity is not None
    if btype in ("attn", "local"):
        return attn_lib.attention_block(
            p, h,
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
    if btype == "rglru":
        out, new = rglru_lib.apply_rglru_block(p, h, cache=cache,
                                               fill_state=fill)
    elif btype == "mlstm":
        out, new = xlstm_lib.apply_mlstm_block(p, h, cfg.num_heads,
                                               cache=cache, fill_state=fill)
    else:
        out, new = xlstm_lib.apply_slstm_block(p, h, cfg.num_heads,
                                               cache=cache, fill_state=fill)
    if cache is not None:
        _write_state(cache, new, live)
        new = cache
    return out, new


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
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
           Dict[str, torch.Tensor]]:
    """One block: (x, its cache (updated in place in decode, new in a
    filling prefill), its MoE aux losses)."""
    aux: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, new_cache = _apply_mixer(cfg, p["mixer"], h, btype, cache,
                                  cache_pos, fill_capacity, live, impl)
    if cfg.use_post_norm:
        out = rms_norm(out, p["post_norm1"], cfg.norm_eps)
    x = x + out
    if "moe" in p:
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        out2, aux = moe_lib.apply_moe(
            p["moe"], h2, cfg.top_k, cfg.capacity_factor,
            sharded_dispatch=cfg.moe_sharded_dispatch)
        if "dense_mlp" in p:
            out2 = out2 + apply_mlp(p["dense_mlp"], h2, "swiglu")
        if cfg.use_post_norm:
            out2 = rms_norm(out2, p["post_norm2"], cfg.norm_eps)
        x = x + out2
    elif "mlp" in p:
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        out2 = apply_mlp(p["mlp"], h2, cfg.mlp_type)
        if cfg.use_post_norm:
            out2 = rms_norm(out2, p["post_norm2"], cfg.norm_eps)
        x = x + out2
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Parameters


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters from ``generator`` (drawn on its device), placed
    on ``device`` (the generator's by default)."""
    device = generator.device if device is None else device
    dt = _dtype(cfg)

    def w(*shape):
        return normal_init(generator, shape, dtype=dt, device=device)

    params: Params = {}
    if cfg.frontend == "audio_frames":
        params["frontend_proj"] = w(cfg.frontend_dim, cfg.d_model)
        params["head"] = w(cfg.d_model, cfg.vocab_size)
    else:
        params["embed"] = init_embedding(generator, cfg.vocab_size,
                                         cfg.d_model, dt, device)
        if cfg.frontend == "vision_patches":
            params["frontend_proj"] = w(cfg.frontend_dim, cfg.d_model)
        if not cfg.tie_embeddings:
            params["head"] = w(cfg.d_model, cfg.vocab_size)
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
    layer order: every leaf is carried across."""
    params: Params = {k: tree_map(lambda a: _tensor(a, device), tree[k])
                      for k in ("embed", "frontend_proj", "head",
                                "final_norm") if k in tree}
    params["layers"] = [tree_map(lambda a: _tensor(a, device), layer)
                        for layer in layers_from_tree(cfg, tree)]
    return params


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)


def _embed_inputs(cfg: ModelConfig, params: Params, inputs: Inputs
                  ) -> torch.Tensor:
    """(B, S, d) in ``cfg.dtype``: embedded tokens, projected audio
    frames, or projected vision patches before the embedded tokens."""
    dt = _dtype(cfg)
    batch = inputs if isinstance(inputs, dict) else {"tokens": inputs}
    if cfg.frontend == "audio_frames":
        x = batch["frames"].to(dt) @ params["frontend_proj"]
    else:
        x = embed(params["embed"], batch["tokens"], scale_by_dim=cfg.embed_scale)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            patches = batch["patch_embeds"].to(dt) @ params["frontend_proj"]
            x = torch.cat([patches, x], dim=1)
    return x.to(dt)


def _save_2d_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of 2-D matrix products (every
    projection and MLP matmul), recompute the rest, batched products (the
    MoE experts' bmm) included: ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``'s counterpart."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ModelConfig, fn):
    """``fn`` under the config's rematerialization (the reference's
    ``_remat_wrap``): "none" as is, "full" keeps only its inputs and
    recomputes the rest in the backward, "dots" keeps the 2-D products'
    outputs too.  Only memory differs between the three, not numbers.
    Applied only where a backward can follow (grad enabled), so the
    inference and serving paths run as before."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    kwargs = {}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_2d_products)
    elif cfg.remat != "full":
        raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kwargs)


def forward_hidden(cfg: ModelConfig, params: Params, inputs: Inputs,
                   impl: str = "cuda"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Trunk forward: (final-norm hidden states (B, S, d), the MoE aux
    losses summed over layers: load_balance, router_z, dropped_frac; 0
    without experts).

    As the reference scans full periods of the layer pattern under its
    remat policy and runs the tail plainly, each period of
    ``len(cfg.layer_pattern)`` layers here is one ``_remat_wrap``ped call
    (where the reference stacks periods, ``_period_split``), the tail
    layers are not wrapped."""
    x = _embed_inputs(cfg, params, inputs)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = tuple(zero for _ in AUX_KEYS)
    layers, types = params["layers"], cfg.pattern_layers
    n_periods, pat, _ = _period_split(cfg)

    def run(first, count):
        def fn(x, *aux):
            aux = list(aux)
            for i in range(first, first + count):
                x, _, a = _apply_layer(cfg, layers[i], x, types[i], impl=impl)
                for j, k in enumerate(AUX_KEYS):
                    if k in a:
                        aux[j] = aux[j] + a[k]
            return (x, *aux)
        return fn

    for i in range(n_periods):
        x, *aux = _remat_wrap(cfg, run(i * len(pat), len(pat)))(x, *aux)
    x, *aux = run(n_periods * len(pat), len(types) - n_periods * len(pat))(x, *aux)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps),
            dict(zip(AUX_KEYS, aux)))


def apply_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        logits = x @ params["head"]
    else:
        logits = unembed(params["embed"], x)
    return softcap(logits, cfg.final_logit_softcap)


def forward(cfg: ModelConfig, params: Params, inputs: Inputs,
            impl: str = "cuda") -> torch.Tensor:
    """Full-sequence forward (prefill): (B, S) tokens or a model-input
    dict -> (B, S, V) logits in ``cfg.dtype``.  Every attention runs
    ``flash_attention`` with ``impl``."""
    return apply_head(cfg, params, forward_hidden(cfg, params, inputs, impl)[0])


def prefill_with_cache(cfg: ModelConfig, params: Params, inputs: Inputs,
                       capacity: int, impl: str = "cuda") -> Tuple[torch.Tensor, Cache]:
    """Forward over the prompt, returning (last-token logits (B, V), a
    decode-ready cache of the given capacity: each attention layer's ring
    filled with the prompt's K/V, each recurrent layer's end-of-prompt
    state)."""
    x = _embed_inputs(cfg, params, inputs)
    cache: Cache = []
    for p, bt in zip(params["layers"], cfg.pattern_layers):
        x, c, _ = _apply_layer(cfg, p, x, bt, fill_capacity=capacity,
                               impl=impl)
        cache.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return apply_head(cfg, params, x[:, -1:, :])[:, 0, :], cache


# ---------------------------------------------------------------------------
# Decode


def _init_layer_cache(cfg: ModelConfig, btype: str, batch: int, capacity: int,
                      device) -> Dict[str, torch.Tensor]:
    dt = _dtype(cfg)
    if btype in ("attn", "local"):
        return attn_lib.init_kv_cache(
            batch,
            attn_lib.ring_capacity(capacity,
                                   cfg.local_window if btype == "local" else 0),
            cfg.num_kv_heads, cfg.resolved_head_dim, dt, device)
    if btype == "rglru":
        return rglru_lib.init_rglru_cache(batch, cfg.resolved_d_rnn,
                                          cfg.conv_width, dt, device)
    hd = cfg.d_model // cfg.num_heads
    if btype == "mlstm":
        return xlstm_lib.init_mlstm_cache(batch, cfg.num_heads, hd,
                                          device=device)
    return xlstm_lib.init_slstm_cache(batch, cfg.num_heads, hd, device=device)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None) -> Cache:
    """Empty caches, one per layer: an attention layer's ring (a local
    layer's holds its window), a recurrent layer's initial state."""
    return [_init_layer_cache(cfg, bt, batch, capacity, device)
            for bt in cfg.pattern_layers]


def reset_cache_rows(cache: Cache, fresh: Cache, row) -> None:
    """Reinitialize batch row(s) ``row`` of ``cache`` from row 0 of
    ``fresh`` (a batch-1 cache from ``init_cache``), in place (the
    reference returns a new cache).  A recurrent state is read whole at
    every step, so a freshly admitted request must not inherit the last
    occupant's: every leaf of every layer is reset."""
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
    cache updated in place (the reference returns a new one): one ring
    slot a live row, and each recurrent state where it lies, so a CUDA
    graph of the step replays against it."""
    x = embed(params["embed"], tokens, scale_by_dim=cfg.embed_scale)
    x = x.to(_dtype(cfg))
    for p, bt, c in zip(params["layers"], cfg.pattern_layers, cache):
        x, _, _ = _apply_layer(cfg, p, x, bt, cache=c, cache_pos=pos, live=live)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return apply_head(cfg, params, x)[:, 0, :], cache

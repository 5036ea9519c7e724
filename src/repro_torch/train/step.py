"""Loss and train/serve step builders: the port of ``repro/train/step.py``.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params', opt_state', metrics)``: the loss of every family (next-token LM,
masked audio prediction, VLM text after the patches; MoE aux losses on
top), its gradients by autograd through the model (every prefill
attention through ``flash_attention``'s autograd.Function, whose backward
is the flash backward kernel under ``impl='cuda'``), gradient accumulation
over microbatches (fp32 sums divided by ``grad_accum``), then
``adamw.update``.  Plain functions on tensors; the parameters are the
port's tree, ``impl`` picks the kernels or their plain versions as in
``models/transformer.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

AUX_LB_COEF = 0.01
AUX_Z_COEF = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (optionally masked) positions; logits (..., V) any
    dtype, summed in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _chunked_ce(cfg: ModelConfig, params, hidden: torch.Tensor,
                labels: torch.Tensor, mask: Optional[torch.Tensor],
                chunk: int) -> torch.Tensor:
    """CE computing the logits one sequence chunk at a time (the reference
    scans the chunks), then the remainder positions (s % chunk) directly."""
    b, s, _ = hidden.shape
    n = s // chunk
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        logits = tf.apply_head(cfg, params, hidden[:, part]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, part].long()[..., None])[..., 0]
        mf = (mask[:, part].float() if mask is not None
              else torch.ones_like(logz))
        tot = tot + ((logz - gold) * mf).sum()
        cnt = cnt + mf.sum()
    if s % chunk:
        rest = slice(n * chunk, s)
        m = mask[:, rest] if mask is not None else None
        rem = cross_entropy(tf.apply_head(cfg, params, hidden[:, rest]),
                            labels[:, rest], m)
        mf = m.float().sum() if m is not None else float(b * (s - n * chunk))
        tot, cnt = tot + rem * mf, cnt + mf
    return tot / cnt.clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            impl: str = "cuda") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Task loss per family: (total loss, metrics).  ``total_loss`` adds
    the MoE aux losses (``AUX_LB_COEF`` load balance, ``AUX_Z_COEF``
    router z) to ``loss``; MoE configs report ``moe_dropped_frac``."""
    hidden, aux = tf.forward_hidden(cfg, params, batch, impl)
    if cfg.frontend == "audio_frames":
        loss = cross_entropy(tf.apply_head(cfg, params, hidden),
                             batch["targets"], batch.get("mask"))
    else:
        if cfg.frontend == "vision_patches":
            hidden = hidden[:, cfg.num_patches:]
        if cfg.loss_vocab_chunk:
            loss = _chunked_ce(cfg, params, hidden, batch["labels"], None,
                               cfg.loss_vocab_chunk)
        else:
            loss = cross_entropy(tf.apply_head(cfg, params, hidden),
                                 batch["labels"])
    total = loss
    if cfg.num_experts:
        total = (total + AUX_LB_COEF * aux["load_balance"]
                 + AUX_Z_COEF * aux["router_z"])
    metrics = {"loss": loss, "total_loss": total}
    if cfg.num_experts:
        metrics["moe_dropped_frac"] = aux["dropped_frac"]
    return total, metrics


def value_and_grad(cfg: ModelConfig, params, batch, impl: str = "cuda"):
    """((total loss, metrics), gradients as the params' tree), metrics
    detached.  A leaf the loss does not reach (xLSTM's ``_hd`` shape
    marker) gets a zero gradient, as under ``jax.value_and_grad``."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
        it = iter(leaves)
        live = tree_lib.tree_map(lambda _: next(it), params)
        total, metrics = loss_fn(cfg, live, batch, impl)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = iter(torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads))
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_lib.tree_map(lambda _: next(grads), params))


def accumulated_grads(cfg: ModelConfig, params, batch, grad_accum: int = 1,
                      impl: str = "cuda"):
    """(metrics, gradients) of one step's batch: with ``grad_accum`` > 1
    the batch is split along its first axis into that many microbatches,
    one forward and backward each, their gradients summed in fp32 and
    divided by ``grad_accum`` (metrics: the mean loss); else the
    gradients come in the params' dtype."""
    if grad_accum <= 1:
        (_, metrics), grads = value_and_grad(cfg, params, batch, impl)
        return metrics, grads
    rows = next(iter(batch.values())).shape[0]
    if rows % grad_accum:
        raise ValueError(f"a batch of {rows} does not split into "
                         f"{grad_accum} microbatches")
    micro = [{k: v.chunk(grad_accum)[i] for k, v in batch.items()}
             for i in range(grad_accum)]
    g_sum, loss_sum = None, 0.0
    for mb in micro:
        (_, m), g = value_and_grad(cfg, params, mb, impl)
        g_sum = (tree_lib.tree_map(lambda x: x.float(), g)
                 if g_sum is None else
                 tree_lib.tree_map(lambda a, b: a.add_(b), g_sum, g))
        loss_sum = loss_sum + m["loss"]
        del g
    grads = tree_lib.tree_map(lambda g: g / grad_accum, g_sum)
    return {"loss": loss_sum / grad_accum}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    grad_accum: int = 1, impl: str = "cuda") -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    ``accumulated_grads`` over ``grad_accum`` microbatches, then
    ``adamw.update``."""

    def train_step(params, opt_state, batch):
        metrics, grads = accumulated_grads(cfg, params, batch, grad_accum, impl)
        new_params, new_opt, opt_metrics = adamw.update(opt_cfg, grads,
                                                        opt_state, params)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, impl: str = "cuda") -> Callable:
    """prefill_step(params, batch) -> last-position logits (B, V)."""
    def prefill_step(params, batch):
        return tf.forward(cfg, params, batch, impl)[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode: (params, cache, tokens, pos) -> (logits, cache),
    the cache updated in place."""
    def serve_step(params, cache, tokens, pos):
        return tf.decode_step(cfg, params, cache, tokens, pos)

    return serve_step

"""Mixture-of-Experts layer: top-k routing, capacity-bounded dispatch and
the expert products.  The port of ``repro/models/moe.py``.

The dispatch is the reference's, step for step, with every shape fixed by
(T, k, E, capacity) alone: no ``nonzero``, no boolean indexing and no
host read of a device value, so a forward with MoE layers is captured
whole into one CUDA graph (and so is a decode step).  The three expert
products are batched matmuls (``torch.bmm``), as the reference computes
them in ``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal_init

Params = Dict[str, torch.Tensor]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype: torch.dtype, device=None) -> Params:
    def w(shape, dt=dtype):
        return normal_init(generator, shape, dtype=dt, device=device)

    return {
        "router": w((d_model, num_experts), torch.float32),
        "w_gate": w((num_experts, d_model, d_ff)),
        "w_up": w((num_experts, d_model, d_ff)),
        "w_down": w((num_experts, d_ff, d_model)),
    }


def capacity(tokens: int, top_k: int, capacity_factor: float,
             num_experts: int) -> int:
    """Copies an expert keeps: ``max(int(T k cf / E), k)``."""
    return max(int(tokens * top_k * capacity_factor / num_experts), top_k)


def route(params: Params, tokens: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(router logits (T, E), probabilities, gate weights (T, k)
    renormalised, expert indices (T, k)): the router and its softmax in
    fp32, then top-k."""
    logits = tokens.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_w, gate_idx


def apply_moe(params: Params, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, sharded_dispatch: bool = False,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y (B, S, d), aux losses).

    Token copies beyond an expert's capacity are dropped (their combine
    weight contributes nothing).  A copy's rank in its expert is the
    GShard cumsum over the experts' one-hot, in token order.  Kept copies
    go to slot ``expert * cap + rank``, which no other kept copy shares;
    dropped ones all go to one waste row ``E * cap`` that is never read
    back (several copies write it, and which one lands does not matter).
    ``sharded_dispatch`` is accepted and changes nothing: in the reference
    it only places the dispatch buffers under SPMD sharding, and on one
    device its result is this one."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    cap = capacity(t, top_k, capacity_factor, e)

    tokens = x.reshape(t, d)
    logits, probs, gate_w, gate_idx = route(params, tokens, top_k)

    flat_idx = gate_idx.reshape(-1)                               # (T k,)
    experts = torch.arange(e, device=x.device)
    # The one-hot held (E, T k), so that the cumsum runs along the
    # contiguous dim: a scan down the columns of (T k, E) runs E threads
    # through T k rows on the card.
    onehot = (experts[:, None] == flat_idx).to(torch.int32)       # (E, T k)
    rank = torch.cumsum(onehot, dim=1) - 1
    rank = rank.gather(0, flat_idx[None, :])[0]
    keep = rank < cap

    src = tokens.repeat_interleave(top_k, dim=0)                  # (T k, d)
    slot = torch.where(keep, flat_idx * cap + rank, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=tokens.dtype, device=x.device)
    buf.index_copy_(0, slot, src)
    expert_in = buf[:e * cap].reshape(e, cap, d)

    gate = F.silu(torch.bmm(expert_in, params["w_gate"]))
    up = torch.bmm(expert_in, params["w_up"])
    expert_out = torch.bmm(gate * up, params["w_down"])

    out_flat = torch.cat([expert_out.reshape(e * cap, d),
                          expert_out.new_zeros((1, d))])
    gathered = out_flat.index_select(0, slot)
    gathered = gathered * (gate_w.reshape(-1, 1)
                           * keep[:, None]).to(gathered.dtype)
    y = gathered.reshape(t, top_k, d).sum(dim=1).reshape(b, s, d)

    # Switch-style load-balancing aux loss and the router z-loss.
    density = (gate_idx[:, :1] == experts).float().mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = {
        "load_balance": e * (density * mean_prob).sum(),
        "router_z": torch.logsumexp(logits, dim=-1).square().mean(),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return y, aux

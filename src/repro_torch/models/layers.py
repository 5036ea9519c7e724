"""Shared LM building blocks: the port of ``repro/models/layers.py``.

Plain functions on tensors; parameters are dicts of tensors with the
reference's keys.  Every random draw takes an explicit ``torch.Generator``
and every tensor an explicit device.  Where bf16 parity is easy to lose the
reference's casts are kept: norms compute in fp32, RoPE angles are fp32,
the embed scale is rounded to the table's dtype before the multiply, and
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers


def normal_init(generator: torch.Generator, shape, scale: float = 0.02,
                dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """``scale`` times a standard normal draw, cast to ``dtype``; drawn on
    the generator's device and moved to ``device``."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (scale * x).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32, times ``1 + scale`` (scales start at zero), cast
    back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, hd); positions broadcastable to (..., S).  Rotates the
    split halves of hd (not interleaved pairs) by fp32 angles."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    angles = angles[..., None, :]                               # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             mlp_type: str, dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    if mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": normal_init(generator, (d_model, d_ff), dtype=dtype, device=device),
            "w_up": normal_init(generator, (d_model, d_ff), dtype=dtype, device=device),
            "w_down": normal_init(generator, (d_ff, d_model), dtype=dtype, device=device),
        }
    return {
        "w_up": normal_init(generator, (d_model, d_ff), dtype=dtype, device=device),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": normal_init(generator, (d_ff, d_model), dtype=dtype, device=device),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              mlp_type: str) -> torch.Tensor:
    """Feed-forward block: gated (swiglu, geglu) or plain gelu."""
    if mlp_type in ("swiglu", "geglu"):
        act_fn = F.silu if mlp_type == "swiglu" else gelu
        gate = act_fn(x @ params["w_gate"])
        up = x @ params["w_up"]
        return (gate * up) @ params["w_down"]
    h = gelu(x @ params["w_up"] + params["b_up"])
    return h @ params["w_down"] + params["b_down"]


# ---------------------------------------------------------------------------
# Embeddings / head


def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return {"table": normal_init(generator, (vocab, d_model), dtype=dtype,
                                 device=device)}


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
          scale_by_dim: bool = False) -> torch.Tensor:
    x = params["table"][tokens]
    if scale_by_dim:
        # sqrt(d) rounded to the table's dtype first, as the reference,
        # on the host: a scalar copied to the card would synchronize, which
        # a CUDA graph capture refuses.
        x = x * torch.tensor(math.sqrt(params["table"].shape[-1]),
                             dtype=x.dtype).item()
    return x


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def unembed(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The tied head: x @ table.T in x's dtype."""
    return x @ params["table"].T.to(x.dtype)

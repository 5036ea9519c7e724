"""RG-LRU recurrent block (Griffin / RecurrentGemma): the port of
``repro/models/rglru.py``.

Linear diagonal recurrence with input-dependent gates, in fp32:
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  per-channel decay
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as a log-depth doubling scan over the
sequence (``linear_scan``: ceil(log2 S) rounds of whole-tensor ops, the
function of the reference's ``jax.lax.associative_scan``); decode takes
one step.  The block wraps the LRU Griffin-style: a width-4 causal
depthwise conv on the recurrent branch, a GeLU gate branch, their product
and the output projection.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gelu, normal_init

_C = 8.0  # Griffin's fixed decay temperature

Params = Dict[str, torch.Tensor]


def init_rglru_block(generator: torch.Generator, d_model: int, d_rnn: int,
                     conv_width: int, dtype: torch.dtype, device=None) -> Params:
    def w(*shape):
        return normal_init(generator, shape, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    p = {
        "w_y": w(d_model, d_rnn),       # recurrent branch in
        "w_gate": w(d_model, d_rnn),    # gate branch in
        "w_out": w(d_rnn, d_model),
        "conv_w": w(conv_width, d_rnn),
        "conv_b": zeros(d_rnn),
        "w_a": w(d_rnn, d_rnn),
        "b_a": zeros(d_rnn),
        "w_x": w(d_rnn, d_rnn),
        "b_x": zeros(d_rnn),
    }
    # Lambda ~ U[0, 1): decay a in about [0.9, 0.999] at r = 1.
    p["lam"] = torch.rand((d_rnn,), generator=generator,
                          device=generator.device).to(device)
    return p


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x (B, S, D), w (W, D).  Prefill:
    ``state`` None, zeros padded on the left.  Decode: ``state`` holds the
    last W - 1 inputs (B, W - 1, D).  Returns (out, the last W - 1
    inputs)."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    new_state = xp[:, xp.shape[1] - (width - 1):] if width > 1 else None
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out + b, new_state


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over dim 1 of (B, S, D) ``a`` and ``b``
    (h_{-1} = ``h0``, or 0), as a doubling scan: after the round of
    offset 2^j each position holds the composition of the 2^(j+1) steps
    ending there, (A, H) with A the product of the a's and H the
    recurrence from 0.  ``h0`` is folded in as a virtual step 0 (a = 1,
    b = h0), as the reference does.  Returns (h (B, S, D), h_{S-1})."""
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None], b], dim=1)
    s = a.shape[1]
    offset = 1
    while offset < s:
        # (A, H) at t composed with (A, H) at t - offset: the earlier
        # segment first.
        b = torch.cat([b[:, :offset], a[:, offset:] * b[:, :-offset]
                       + b[:, offset:]], dim=1)
        a = torch.cat([a[:, :offset], a[:, offset:] * a[:, :-offset]], dim=1)
        offset *= 2
    if h0 is not None:
        b = b[:, 1:]
    return b, b[:, -1]


def apply_rglru_block(params: Params, x: torch.Tensor,
                      cache: Optional[Params] = None, fill_state: bool = False,
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d_model) -> (out, new cache).  ``cache`` = {'h': (B, d_rnn)
    fp32, 'conv': (B, W - 1, d_rnn)} for decode; ``fill_state``: prefill
    that returns the end-of-sequence state as a fresh cache.  The new
    cache is new tensors; the caller writes them into its own."""
    y = x @ params["w_y"]
    gate = gelu(x @ params["w_gate"])

    conv_state = cache["conv"] if cache is not None else None
    y, new_conv = causal_conv1d(y, params["conv_w"], params["conv_b"],
                                conv_state)

    yf = y.float()
    r = torch.sigmoid(yf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(yf @ params["w_x"].float() + params["b_x"].float())
    a = torch.exp(-_C * F.softplus(params["lam"]) * r)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * yf)

    h0 = cache["h"] if cache is not None else None
    if x.shape[1] == 1 and h0 is not None:
        h_last = a[:, 0] * h0 + gated_in[:, 0]
        hs = h_last[:, None]
    else:
        hs, h_last = linear_scan(a, gated_in, h0)

    out = (hs.to(x.dtype) * gate) @ params["w_out"]
    new_cache = None
    if cache is not None or fill_state:
        new_cache = {"h": h_last, "conv": new_conv}
    return out, new_cache


def init_rglru_cache(batch: int, d_rnn: int, conv_width: int,
                     dtype: torch.dtype, device=None) -> Params:
    return {
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                            device=device),
    }

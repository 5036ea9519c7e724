"""xLSTM blocks: mLSTM (matrix memory, linear-attention form) and sLSTM
(scalar memory, sequential exponential-gating recurrence).  The port of
``repro/models/xlstm.py``.

mLSTM runs in the reference's three forms, chosen by its rule
(``apply_mlstm_block``), since they round differently:
  - parallel (quadratic, decay-masked attention) for prefill;
  - chunkwise recurrent (parallel within a chunk, (C, n, m) state across
    chunks) when the state is asked for, or for long sequences;
  - a single recurrent step for decode.
sLSTM is sequential: a Python loop over time on block-diagonal (per-head)
recurrent weights.  Under a CUDA graph its S steps' launches are captured
once and replayed.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal_init, rms_norm

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM


def init_mlstm_block(generator: torch.Generator, d_model: int, num_heads: int,
                     dtype: torch.dtype, device=None) -> Params:
    hd = d_model // num_heads

    def w(shape, dt=dtype):
        return normal_init(generator, shape, dtype=dt, device=device)

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    return {
        "w_up": w((d_model, 2 * d_model)),
        "w_q": w((d_model, d_model)),
        "w_k": w((d_model, d_model)),
        "w_v": w((d_model, d_model)),
        "w_i": w((d_model, num_heads), torch.float32),
        "b_i": full(num_heads, 0.0),
        "w_f": w((d_model, num_heads), torch.float32),
        "b_f": full(num_heads, 3.0),  # open forget gates
        "w_down": w((d_model, d_model)),
        "out_norm": full(d_model, 0.0),
        "_hd": full(hd, 0.0),  # shape marker, carried like every leaf
    }


def _causal(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def mlstm_parallel(q, k, v, log_f, log_i) -> torch.Tensor:
    """Stabilized quadratic form.  q, k, v (B, S, H, hd); gates (B, S, H)
    fp32."""
    s, hd = q.shape[1], q.shape[-1]
    lf_cum = torch.cumsum(log_f, dim=1)                           # (B, S, H)
    # dtilde_ij = lf_cum_i - lf_cum_j + log_i_j for j <= i.
    dt = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + log_i[:, None, :, :]
    dt = torch.where(_causal(s, q.device)[None, :, :, None], dt, -math.inf)
    m = dt.amax(dim=2)                                            # (B, S, H)
    d = torch.exp(dt - m[:, :, None, :])                          # (B, Si, Sj, H)
    scores = torch.einsum("bihd,bjhd->bijh", q.float(), k.float()) \
        / math.sqrt(hd)
    w = scores * d
    norm = torch.maximum(w.sum(dim=2).abs(), torch.exp(-m))       # (B, S, H)
    out = torch.einsum("bijh,bjhd->bihd", w, v.float())
    return (out / norm[..., None]).to(q.dtype)


def mlstm_step(state: State, q, k, v, log_f, log_i
               ) -> Tuple[State, torch.Tensor]:
    """One recurrent step.  state = (C (B, H, hd, hd), n (B, H, hd),
    m (B, H)); q, k, v (B, H, hd); gates (B, H) fp32."""
    c_prev, n_prev, m_prev = state
    hd = q.shape[-1]
    m_new = torch.maximum(log_f + m_prev, log_i)
    f_sc = torch.exp(log_f + m_prev - m_new)[..., None]
    i_sc = torch.exp(log_i - m_new)[..., None]
    kf, vf = k.float(), v.float()
    c_new = f_sc[..., None] * c_prev + i_sc[..., None] * (
        vf[..., :, None] * kf[..., None, :])                     # (B, H, hd_v, hd_k)
    n_new = f_sc * n_prev + i_sc * kf
    qf = q.float() / math.sqrt(hd)
    num = torch.einsum("bhvk,bhk->bhv", c_new, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qf).abs(),
                        torch.exp(-m_new))
    out = (num / den[..., None]).to(q.dtype)
    return (c_new, n_new, m_new), out


def mlstm_chunked(q, k, v, log_f, log_i, state: State, chunk: int
                  ) -> Tuple[torch.Tensor, State]:
    """Chunkwise recurrent: a loop over S / chunk chunks, quadratic within
    each.  Cross-chunk contributions flow through the (C, n, m) state as
    in the stabilized recurrent form; within a chunk the parallel form,
    extended with the carried state."""
    b, s, h, hd = q.shape
    c_prev, n_prev, m_prev = state
    causal = _causal(chunk, q.device)[None, :, :, None]
    outs = []
    for c0 in range(0, s, chunk):
        qc, kc, vc = (t[:, c0:c0 + chunk] for t in (q, k, v))
        lf, li = log_f[:, c0:c0 + chunk], log_i[:, c0:c0 + chunk]
        lf_cum = torch.cumsum(lf, dim=1)                          # (B, c, H)
        # Intra-chunk decay matrix.
        dt = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + li[:, None, :, :]
        dt = torch.where(causal, dt, -math.inf)
        # Inter: position i sees the state with weight lf_cum_i + m_prev.
        inter_logw = lf_cum + m_prev[:, None, :]                  # (B, c, H)
        m = torch.maximum(dt.amax(dim=2), inter_logw)             # (B, c, H)
        d = torch.exp(dt - m[:, :, None, :])
        qf = qc.float() / math.sqrt(hd)
        kf, vf = kc.float(), vc.float()
        scores = torch.einsum("bihd,bjhd->bijh", qf, kf) * d
        inter_w = torch.exp(inter_logw - m)                       # (B, c, H)
        num = torch.einsum("bijh,bjhd->bihd", scores, vf) + inter_w[..., None] \
            * torch.einsum("bhvk,bihk->bihv", c_prev, qf)
        den_intra = scores.sum(dim=2)                             # (B, c, H)
        den_inter = inter_w * torch.einsum("bhk,bihk->bih", n_prev, qf)
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m))
        outs.append((num / den[..., None]).to(qc.dtype))

        # The state at the chunk's end.
        lf_tot = lf_cum[:, -1]                                    # (B, H)
        m_new = torch.maximum(lf_tot + m_prev,
                              (lf_tot[:, None] - lf_cum + li).amax(dim=1))
        w_state = torch.exp(lf_tot + m_prev - m_new)              # (B, H)
        w_in = torch.exp(lf_tot[:, None] - lf_cum + li - m_new[:, None])
        c_prev = w_state[..., None, None] * c_prev + torch.einsum(
            "bjh,bjhv,bjhk->bhvk", w_in, vf, kf)
        n_prev = w_state[..., None] * n_prev + torch.einsum(
            "bjh,bjhk->bhk", w_in, kf)
        m_prev = m_new
    return torch.cat(outs, dim=1), (c_prev, n_prev, m_prev)


def mlstm_form(s: int, decoding: bool, fill_state: bool,
               chunk_threshold: int = 4096, chunk: int = 256) -> str:
    """The reference's rule for the form a call runs: 'step' when
    decoding, 'chunked' when the state is asked for or S is long and a
    multiple of ``chunk``, else 'parallel'."""
    if decoding:
        return "step"
    if fill_state or (s > chunk_threshold and s % chunk == 0):
        return "chunked"
    return "parallel"


def apply_mlstm_block(params: Params, x: torch.Tensor, num_heads: int,
                      cache: Optional[Params] = None,
                      chunk_threshold: int = 4096, chunk: int = 256,
                      fill_state: bool = False,
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) -> (out, new cache).  ``cache`` = {'c', 'n', 'm'} for
    decode; ``fill_state`` returns the end-of-sequence state (prefill)."""
    b, s, d = x.shape
    hd = d // num_heads
    up = x @ params["w_up"]
    u, g = up.chunk(2, dim=-1)
    q = (u @ params["w_q"]).reshape(b, s, num_heads, hd)
    k = (u @ params["w_k"]).reshape(b, s, num_heads, hd)
    v = (u @ params["w_v"]).reshape(b, s, num_heads, hd)
    uf = u.float()
    log_i = uf @ params["w_i"] + params["b_i"]                    # (B, S, H)
    log_f = F.logsigmoid(uf @ params["w_f"] + params["b_f"])

    new_cache = None
    form = mlstm_form(s, cache is not None and s == 1, fill_state,
                      chunk_threshold, chunk)
    if form == "step":
        state, out = mlstm_step((cache["c"], cache["n"], cache["m"]),
                                q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                                log_i[:, 0])
        out = out[:, None]
        new_cache = dict(zip("cnm", state))
    elif form == "chunked":
        state = _init_mlstm_state(b, num_heads, hd, x.device)
        out, state = mlstm_chunked(q, k, v, log_f, log_i, state,
                                   chunk if s % chunk == 0 else s)
        if fill_state:
            new_cache = dict(zip("cnm", state))
    else:
        out = mlstm_parallel(q, k, v, log_f, log_i)

    out = rms_norm(out.reshape(b, s, d), params["out_norm"])
    out = out * F.silu(g)
    return out @ params["w_down"], new_cache


def _init_mlstm_state(b: int, h: int, hd: int, device=None) -> State:
    return (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((b, h, hd), dtype=torch.float32, device=device),
            torch.zeros((b, h), dtype=torch.float32, device=device))


def init_mlstm_cache(batch: int, num_heads: int, head_dim: int,
                     device=None) -> Params:
    """The zero state (m = 0, as the reference's)."""
    return dict(zip("cnm", _init_mlstm_state(batch, num_heads, head_dim,
                                             device)))


# ---------------------------------------------------------------------------
# sLSTM


def init_slstm_block(generator: torch.Generator, d_model: int, num_heads: int,
                     dtype: torch.dtype, device=None) -> Params:
    hd = d_model // num_heads

    def w(*shape):
        return normal_init(generator, shape, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "w_in": w(d_model, 4 * d_model),
        "b_in": zeros(4 * d_model),
        # Block-diagonal recurrent weights: per head (hd -> 4 hd).
        "r": w(num_heads, hd, 4 * hd),
        "w_out": w(d_model, d_model),
        "out_norm": zeros(d_model),
    }


def slstm_step(state, z_t: torch.Tensor, r: torch.Tensor):
    """One sLSTM step.  state = (c, n, m, h), each (B, H, hd) fp32; z_t
    (B, 4, H, hd) the input's gate pre-activations; r (H, hd, 4 hd)
    fp32."""
    c, n, m, h = state
    b, nh, hd = h.shape
    rec = torch.einsum("bhk,hkf->bhf", h, r).reshape(b, nh, 4, hd)
    zz = z_t.transpose(0, 1) + rec.permute(2, 0, 1, 3)            # (4, B, H, hd)
    z_g, i_g, f_g, o_g = zz[0], zz[1], zz[2], zz[3]
    z_g = torch.tanh(z_g)
    o_g = torch.sigmoid(o_g)
    log_f = F.logsigmoid(f_g)
    m_new = torch.maximum(log_f + m, i_g)
    i_sc = torch.exp(i_g - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c_new = f_sc * c + i_sc * z_g
    n_new = f_sc * n + i_sc
    h_new = o_g * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, m_new, h_new


def apply_slstm_block(params: Params, x: torch.Tensor, num_heads: int,
                      cache: Optional[Params] = None, fill_state: bool = False,
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Sequential sLSTM.  x (B, S, d); ``cache`` = {'c', 'n', 'm', 'h'}
    for decode."""
    b, s, d = x.shape
    hd = d // num_heads
    zin = (x @ params["w_in"]).float() + params["b_in"]           # (B, S, 4d)
    zin = zin.reshape(b, s, 4, num_heads, hd)

    if cache is not None:
        state = tuple(cache[name] for name in "cnmh")
    else:
        zero = torch.zeros((b, num_heads, hd), dtype=torch.float32,
                           device=x.device)
        state = (zero, zero, zero - 10.0, zero)

    r = params["r"].float()
    hs = []
    for t in range(s):
        state = slstm_step(state, zin[:, t], r)
        hs.append(state[3])
    out = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = rms_norm(out, params["out_norm"])
    out = out @ params["w_out"]
    new_cache = None
    if cache is not None or fill_state:
        new_cache = dict(zip("cnmh", state))
    return out, new_cache


def init_slstm_cache(batch: int, num_heads: int, head_dim: int,
                     device=None) -> Params:
    """The zero state, m = -10 (as the reference's)."""
    zero = torch.zeros((batch, num_heads, head_dim), dtype=torch.float32,
                       device=device)
    return {"c": zero, "n": zero.clone(), "m": zero - 10.0, "h": zero.clone()}

#!/usr/bin/env python3
"""The flash-attention kernel's bf16 arithmetic replayed on the CPU, held
against its plain version, to size the bf16 tolerance.

``replay`` follows the bf16 kernel, ``kernels/flash_attention/csrc/
flash_attention_bf16.cuh``, step by step: 64-key tiles, fp32 scores, then
in base 2 with log2 e folded into the scale — x = s * (scale * log2 e), or
with the softcap x = tanh(s * (scale / cap)) * (cap * log2 e), each
bracket one fp32 constant and tanh(y) = 1 - 2 / (exp2(2 y log2 e) + 1) —
the mask (-inf), the running max m of x and sum l, p = exp2(x - m)
rounded to bf16 before P.V, the output acc / l rounded to bf16 (exp2 here
is exact to fp32; the kernel's SFU exp2 is within about 2^-22 of it).  The plain version (``attention_ref``) rounds the
normalized p / l instead, so the two round each weight apart.  For each
case the script prints the largest per-element error over its two
candidate gates (2^-6 |ref| + 1e-3, and 3e-2 max(1, max|ref|)), and the
largest per-row relative error (one query row of one head: the norm of the
difference over the norm of the plain row).  Then the same for a few
deliberate faults in the replay, which a gate should catch:

  noround   p not rounded to bf16 before P.V;
  late      the second half of the rows 3 % off;
  lastkey   the last key of every tile dropped;
  nocap     the softcap left out;
  mod       query head h on KV head h % KV instead of h // G.

    PYTHONPATH=src python scripts/flash_bf16_replay.py [--seed 0]
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ref import attention_mask, attention_ref

BK = 64
LOG2E = np.float32(1.4426950408889634)
FAULTS = (None, "noround", "late", "lastkey", "nocap", "mod")
# (S, H, KV, hd, causal, window, cap, q scale): Llama's grouping, Gemma2's
# local and global layers, a non-causal case, the softcap saturated.
CASES = [(512, 8, 2, 64, True, 0, 0.0, 1.0),
         (640, 4, 2, 128, True, 256, 50.0, 1.0),
         (640, 4, 2, 128, True, 0, 50.0, 1.0),
         (300, 4, 2, 64, False, 0, 0.0, 1.0),
         (512, 4, 2, 128, True, 0, 50.0, 8.0)]


def replay(q, k, v, causal, window, cap, fault=None):
    """The kernel's arithmetic on (B, S, H, hd) q and (B, Sk, KV, hd) k, v."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    mask = attention_mask(s, sk, causal, window)
    scale = np.float32(1.0 / math.sqrt(hd))
    capped = cap > 0 and fault != "nocap"
    # The kernel's two fp32 constants (flash_bf16::launch).
    x_scale = float(scale / np.float32(cap) if capped else scale * LOG2E)
    cap_out = float(np.float32(cap) * LOG2E) if capped else 0.0
    out = torch.empty_like(q)
    for bi in range(b):
        for hh in range(h):
            kh = hh % kv if fault == "mod" else hh // (h // kv)
            qq, kk, vv = (q[bi, :, hh].float(), k[bi, :, kh].float(),
                          v[bi, :, kh].float())
            m = torch.full((s,), -math.inf)
            l, acc = torch.zeros(s), torch.zeros(s, hd)
            for k0 in range(0, sk, BK):
                valid = mask[:, k0:k0 + BK].clone()
                if fault == "lastkey":
                    valid[:, -1] = False
                if not valid.any():
                    continue        # the kernel skips fully masked tiles
                x = (qq @ kk[k0:k0 + BK].T) * x_scale
                if capped:    # tanh(y) = 1 - 2 / (exp2(2 y log2 e) + 1)
                    x = (1 - 2 / (torch.exp2(2 * float(LOG2E) * x) + 1)) * cap_out
                x = torch.where(valid, x, -math.inf)
                m_new = torch.maximum(m, x.max(1).values)
                # A row with no valid key yet takes 0 as its max: p = 0.
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m - m_use)
                p = torch.exp2(x - m_use[:, None])
                l = l * alpha + p.sum(1)
                if fault != "noround":
                    p = p.to(v.dtype).float()
                acc = acc * alpha[:, None] + p @ vv[k0:k0 + BK]
                m = m_new
            o = acc / l.clamp_min(1e-37)[:, None]
            if fault == "late":
                o[s // 2:] *= 1.03
            out[bi, :, hh] = o.to(q.dtype)
    return out


def errors(got, ref):
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    elem = float((d / (2 ** -6 * ref.abs() + 1e-3)).max())
    flat = float(d.max() / (3e-2 * max(1.0, float(ref.abs().max()))))
    row = float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    return elem, flat, row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    g = torch.Generator().manual_seed(args.seed)
    print("case | fault | elem err / (2^-6|ref| + 1e-3) | "
          "max err / (3e-2 max(1,max|ref|)) | max row rel err")
    for s, h, kv, hd, causal, window, cap, scale in CASES:
        q = (torch.randn(1, s, h, hd, generator=g) * scale).bfloat16()
        k, v = (torch.randn(1, s, kv, hd, generator=g).bfloat16()
                for _ in range(2))
        ref = attention_ref(q, k, v, causal, window, cap)
        case = (f"S={s} H={h} KV={kv} hd={hd} causal={causal} "
                f"window={window} cap={cap} q*{scale:g}")
        for fault in FAULTS:
            elem, flat, row = errors(replay(q, k, v, causal, window, cap, fault),
                                     ref)
            print(f"{case} | {fault or 'none'} | {elem:.4f} | {flat:.4f} | "
                  f"{row:.5f}")


if __name__ == "__main__":
    main()

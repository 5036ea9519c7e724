#!/usr/bin/env python3
"""The flash-attention kernel's bf16 arithmetic replayed on the CPU, held
against its plain version, to size the bf16 tolerance.

``replay`` follows ``kernels/flash_attention/csrc/flash_attention.cu`` step
by step: 64-key tiles, fp32 scores, the softcap and the mask, the running
max m and sum l, p = exp(s - m) rounded to bf16 before P.V, the output
acc / l rounded to bf16.  The plain version (``attention_ref``) rounds the
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

import torch

from repro_torch.kernels.flash_attention.ref import (
    NEG_INF,
    attention_mask,
    attention_ref,
)

BK = 64
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
    out = torch.empty_like(q)
    for bi in range(b):
        for hh in range(h):
            kh = hh % kv if fault == "mod" else hh // (h // kv)
            qq, kk, vv = (q[bi, :, hh].float(), k[bi, :, kh].float(),
                          v[bi, :, kh].float())
            m = torch.full((s,), NEG_INF)
            l, acc = torch.zeros(s), torch.zeros(s, hd)
            for k0 in range(0, sk, BK):
                valid = mask[:, k0:k0 + BK].clone()
                if fault == "lastkey":
                    valid[:, -1] = False
                if not valid.any():
                    continue        # the kernel skips fully masked tiles
                sc = qq @ kk[k0:k0 + BK].T / math.sqrt(hd)
                if cap > 0 and fault != "nocap":
                    sc = torch.tanh(sc / cap) * cap
                sc = torch.where(valid, sc, NEG_INF)
                m_new = torch.maximum(m, sc.max(1).values)
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(sc - m_new[:, None]), 0.0)
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

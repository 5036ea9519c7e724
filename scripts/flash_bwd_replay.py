#!/usr/bin/env python3
"""Replay the bf16 flash-attention backward kernel's arithmetic on the CPU
and size the gates that ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold it to (``FLASH_BWD_ROW_RTOL``).

The kernel (``kernels/flash_attention/csrc/flash_attention_bwd.cu``)
reads bf16 q, k, v, o and dO, converts them to fp32, recomputes p =
exp2(x - lse) and ds from the saved lse in fp32, sums dv and dk over its
key tile's (head, query tile) pairs and dq over its query tile's key
tiles in fp32, and rounds each result once to bf16.  This replay runs the
same tile loops with fp32 products (the kernel sums each product's hd
terms one FMA at a time; the matmul here sums them in another order) and
rounds once at the end; the plain version (``attention_bwd_ref``) sums
the same fp32 products over whole rows and rounds once too.  So the two
differ by the sums' order and by one bf16 rounding each: at most about
one unit of bf16's last place (2^-8 of a value), which this prints as the
per-element error over max(1, max|ref|) and the per-row relative error
(rows floored at 1e-2 of the largest row's norm, as the gates), at
Llama-3.2-1B's grouping, Gemma2-27B's window with its softcap and its
saturated case (q x 8), a ragged non-causal case and hd 256 with a
window.

    PYTHONPATH=src python scripts/flash_bwd_replay.py
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import (
    LOG2E,
    attention_bwd_ref,
    attention_mask,
    attention_ref_lse,
)

CASES = {
    # (B, S, Sk, H, KV, hd, causal, window, cap, q scale)
    "llama grouping": (1, 512, 512, 8, 2, 64, True, 0, 0.0, 1.0),
    "gemma2 window + softcap": (1, 512, 512, 4, 2, 128, True, 128, 50.0, 1.0),
    "gemma2 softcap saturated": (1, 512, 512, 4, 2, 128, True, 0, 50.0, 8.0),
    "non-causal ragged": (2, 300, 213, 4, 2, 64, False, 0, 0.0, 1.0),
    "hd 256 window": (1, 256, 256, 2, 1, 256, True, 64, 0.0, 1.0),
}


def tiles(hd: int):
    """The kernel's (BQ, BK): 64 and 64 up to hd 128, 32 and 32 above."""
    return (64, 64) if hd <= 128 else (32, 32)


def replay(q, k, v, o, do, lse, causal, window, cap):
    """The backward kernel's loops in fp32, one bf16 rounding at the end."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    bq, bk = tiles(hd)
    scale = 1 / math.sqrt(hd)
    mask = attention_mask(s, sk, causal, window)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    rowdot = (dof * of).sum(-1)                                   # (B, S, H)
    dq = torch.zeros(qf.shape)
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(vf.shape)

    def p_ds(bi, hh, qs, ks):
        y = qf[bi, qs, hh] @ kf[bi, ks, hh // g].T * scale
        sc = torch.tanh(y / cap) * cap if cap > 0 else y
        p = torch.where(mask[qs, ks], torch.exp2(sc * LOG2E - lse[bi, hh, qs, None]),
                        0.0)
        dp = dof[bi, qs, hh] @ vf[bi, ks, hh // g].T
        ds = p * (dp - rowdot[bi, qs, hh, None]) * scale
        if cap > 0:
            ds = ds * (1 - torch.tanh(y / cap).square())
        return p, ds

    for bi in range(b):
        for j in range(kv):
            for k0 in range(0, sk, bk):
                ks = slice(k0, min(k0 + bk, sk))
                for hh in range(j * g, (j + 1) * g):
                    for q0 in range(0, s, bq):
                        qs = slice(q0, min(q0 + bq, s))
                        p, ds = p_ds(bi, hh, qs, ks)
                        dv[bi, ks, j] += p.T @ dof[bi, qs, hh]
                        dk[bi, ks, j] += ds.T @ qf[bi, qs, hh]
        for hh in range(h):
            for q0 in range(0, s, bq):
                qs = slice(q0, min(q0 + bq, s))
                for k0 in range(0, sk, bk):
                    ks = slice(k0, min(k0 + bk, sk))
                    dq[bi, qs, hh] += p_ds(bi, hh, qs, ks)[1] @ kf[bi, ks, hh // g]
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def errors(got, ref, floor=1e-2):
    got, ref = got.float(), ref.float()
    elem = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    norm = ref.norm(dim=-1)
    row = float(((got - ref).norm(dim=-1)
                 / norm.clamp_min(floor * float(norm.max()))).max())
    return elem, row


def main() -> None:
    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for name, (b, s, sk, h, kv, hd, causal, window, cap, qs) in CASES.items():
        q = (torch.randn(b, s, h, hd, generator=g) * qs).bfloat16()
        k, v = (torch.randn(b, sk, kv, hd, generator=g).bfloat16() for _ in range(2))
        do = torch.randn(b, s, h, hd, generator=g).bfloat16()
        o, lse = attention_ref_lse(q, k, v, causal, window, cap)
        got = replay(q, k, v, o, do, lse, causal, window, cap)
        ref = attention_bwd_ref(q, k, v, o, do, lse, causal, window, cap)
        parts = []
        for label, a, r in zip(("dq", "dk", "dv"), got, ref):
            elem, row = errors(a, r)
            worst = max(worst, row)
            parts.append(f"{label} elem {elem:.3g} row {row:.3g}")
        print(f"{name}: " + "; ".join(parts), flush=True)
    print(f"worst per-row relative error {worst:.4g}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Replay the bf16 flash-attention backward kernel's arithmetic on the CPU
and size the gates that ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold it to (``FLASH_BWD_TOL``, ``FLASH_BWD_ROW_RTOL``).

The kernel (``kernels/flash_attention/csrc/flash_attention_bwd_bf16.cuh``)
reads bf16 q, k, v and dO, recomputes s, dp, p = exp2(x - lse) and ds
from the saved lse in fp32 (the tensor cores' sums of exact bf16
products), rounds p and ds to bf16 where they become the A operand of
dv += p^T dO, dk += ds^T q and dq += ds k, sums in fp32, and rounds dq,
dk and dv once to bf16.  Its dk/dv blocks own BK keys and loop over the
(head, query tile) pairs of their group; with a head split
(``ops.bwd_head_split``) each group's fp32 partial is summed in group
order before the one rounding.  Its dq blocks own 64 rows and loop over
the key tiles of flash_common.cuh's kv_tiles.  This replay runs the same
tiles in that order with the same roundings; within a tile the matmul
sums in another order than the tensor cores.  The plain version
(``attention_bwd_ref``) keeps p and ds in fp32 and sums whole rows, so
the two differ by the bf16 rounding of p and ds (about 2^-9 of each
term) and by one rounding of the result: this prints the per-element
error over max(1, max|ref|) and the per-row relative error (rows floored
at 1e-2 of the largest row's norm, as the gates), at Llama-3.2-1B's
grouping, Gemma2-27B's window with its softcap and its saturated case
(q x 8), a ragged non-causal case, and hd 256 MQA with a window and the
head split.

    PYTHONPATH=src python scripts/flash_bwd_replay.py
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import bwd_head_split
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
    "hd 256 mqa window split": (1, 256, 256, 8, 1, 256, True, 64, 0.0, 1.0),
}


def tiles(hd: int):
    """The kernel's tiles (``Cfg<HD>``): keys a dk/dv block, query rows a
    tile of its loop; rows a dq block, keys a tile of its loop."""
    return (32 if hd == 256 else 64, 64 if hd <= 80 else 32, 64,
            64 if hd <= 64 else 32)


def _bf16(t):
    return t.bfloat16().float()


def replay(q, k, v, o, do, lse, causal, window, cap, split=None):
    """The backward kernel's loops: fp32 sums, p and ds rounded to bf16
    before the products, one bf16 rounding at the end.  ``split`` (the
    head groups of the dk/dv launch) defaults to ``bwd_head_split``'s."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    bk, bq_t, bq, bk_t = tiles(hd)
    split = bwd_head_split(b, kv, sk, g, hd) if split is None else split
    gs = g // split
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
                q_begin = k0 if causal else 0
                q_end = min(s, k0 + bk - 1 + window) if window > 0 else s
                dk_sum, dv_sum = torch.zeros(2, ks.stop - k0, hd)
                for z in range(split):
                    dk_part, dv_part = torch.zeros(2, ks.stop - k0, hd)
                    for hh in range(j * g + z * gs, j * g + (z + 1) * gs):
                        for q0 in range(q_begin // bq_t * bq_t, q_end, bq_t):
                            qs = slice(q0, min(q0 + bq_t, s))
                            p, ds = p_ds(bi, hh, qs, ks)
                            dv_part += _bf16(p).T @ dof[bi, qs, hh]
                            dk_part += _bf16(ds).T @ qf[bi, qs, hh]
                    dk_sum += dk_part
                    dv_sum += dv_part
                dk[bi, ks, j], dv[bi, ks, j] = dk_sum, dv_sum
        for hh in range(h):
            for q0 in range(0, s, bq):
                qs = slice(q0, min(q0 + bq, s))
                q_last = min(q0 + bq - 1, s - 1)
                k_end = min(sk, q_last + 1) if causal else sk
                k_begin = max(0, q0 - window + 1) if window > 0 else 0
                for k0 in range(k_begin // bk_t * bk_t, k_end, bk_t):
                    ks = slice(k0, min(k0 + bk_t, sk))
                    ds = p_ds(bi, hh, qs, ks)[1]
                    dq[bi, qs, hh] += _bf16(ds) @ kf[bi, ks, hh // g]
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def errors(got, ref, floor=1e-2):
    """(max |got - ref| over max(1, max|ref|), the largest per-row error
    over the row's norm floored at ``floor`` of the largest row's)."""
    got, ref = got.float(), ref.float()
    elem = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    norm = ref.norm(dim=-1)
    row = float(((got - ref).norm(dim=-1)
                 / norm.clamp_min(floor * float(norm.max()))).max())
    return elem, row


def main() -> None:
    g = torch.Generator().manual_seed(0)
    worst_elem = worst_row = 0.0
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
            worst_elem, worst_row = max(worst_elem, elem), max(worst_row, row)
            parts.append(f"{label} elem {elem:.3g} row {row:.3g}")
        split = bwd_head_split(b, kv, sk, h // kv, hd)
        print(f"{name} (split {split}): " + "; ".join(parts), flush=True)
    print(f"worst per-element error {worst_elem:.4g}, "
          f"per-row {worst_row:.4g}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Replay the flash-attention backward kernel's arithmetic on the CPU, in
bf16 (default) or fp32 (``--fp32``), and size the gates that
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold it to
(``FLASH_BWD_TOL``, ``FLASH_BWD_ROW_RTOL``).

bf16.  The kernel (``kernels/flash_attention/csrc/flash_attention_bwd_bf16.cuh``)
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

fp32 (``replay_fp32``).  The kernel (``flash_attention_bwd_fp32.cuh``)
runs every product as 3xTF32: each operand split into hi + lo
(``scripts/tf32x3_replay.py``'s ``split``), per k8 step lo.hi, hi.lo,
then hi.hi added to an fp32 accumulator (``scripts/flash_fp32_replay.py``'s
``mma``).  s and dp are summed over the head dim in partials of JD k8
steps, each added to the tile's scores in fp32; dv, dk (JQ k8 steps of
query rows) and dq (JK of keys) in partials of a tile, each added to the
accumulator in fp32.  The A operand of dv, dk and dq comes from the s/dp
accumulators with each k8 step's rows (or keys) in the order 0, 2, 4, 6,
1, 3, 5, 7, the B operand's rows likewise.  The head split sums the
groups' partials in group order from 0.  exp2 and tanh are exact to fp32
here (the kernel's SFU ex2.approx is within about 2^-22), and mma.sync's
own rounding of each sum (not to nearest) is not modelled: numpy sums
each k8 step in fp32.  ``terms`` 2 drops the hi.lo correction, 1 is
plain TF32; either fails the gates.

    PYTHONPATH=src python scripts/flash_bwd_replay.py [--fp32]
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ops import bwd_head_split
from repro_torch.kernels.flash_attention.ref import (
    LOG2E,
    attention_bwd_ref,
    attention_mask,
    attention_ref_lse,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from flash_fp32_replay import PERM, mma  # noqa: E402

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


def tiles_fp32(hd: int):
    """The fp32 kernel's tiles (``Cfg<HD>`` of flash_attention_bwd_fp32.cuh):
    dk/dv: keys a block, query rows a tile, k8 steps of a dv/dk partial and
    of an s/dp partial; dq: rows a block, keys a tile, k8 steps of a dq
    partial and of an s/dp partial."""
    bq_t = 64 if hd <= 64 else 16 if hd == 128 else 32
    bk_t = 32 if hd <= 80 else 16
    return (32 if hd == 256 else 64, bq_t, bq_t // 8,
            4 if hd % 32 == 0 else 2, 64, bk_t, bk_t // 8, 1)


def _rows(x, r0, n, total):
    """Rows [r0, r0 + n) of x, zero past ``total`` (the kernel's copies)."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    m = max(0, min(n, total - r0))
    out[:m] = x[r0:r0 + m]
    return out


def _scores(a, b, jd, terms):
    """a (M, hd) . b (N, hd)^T summed over the head dim in partials of
    ``jd`` k8 steps, each added to the result in fp32."""
    out = np.zeros((a.shape[0], b.shape[0]), np.float32)
    step = 8 * jd
    for d0 in range(0, a.shape[1], step):
        out = out + mma(np.zeros_like(out), a[:, d0:d0 + step],
                        b[:, d0:d0 + step].T, terms)
    return out


def _acc_times(acc, a, b, j, terms):
    """acc + a (M, K) . b (K, N), each k8 step's K in the order PERM, in
    partials of ``j`` k8 steps added to acc in fp32."""
    step = 8 * j
    for c0 in range(0, a.shape[1], step):
        idx = np.concatenate([c + PERM for c in range(c0, c0 + step, 8)])
        acc = acc + mma(np.zeros_like(acc), a[:, idx], b[idx], terms)
    return acc


def replay_fp32(q, k, v, o, do, lse, causal, window, cap, split=None,
                terms=3):
    """The fp32 kernel's loops on float32 q, k, v, o, do (torch or numpy)
    and lse (B, H, S): returns (dq, dk, dv) as float32 torch tensors.
    ``split`` defaults to ``bwd_head_split``'s."""
    q, k, v, o, do, lse = (np.asarray(t, np.float32) for t in
                           (q, k, v, o, do, lse))
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    bk, bq_t, jq, jd_kv, bq, bk_t, jk, jd_q = tiles_fp32(hd)
    split = bwd_head_split(b, kv, sk, g, hd) if split is None else split
    gs = g // split
    f32 = np.float32
    scale = f32(1.0 / math.sqrt(hd))
    log2e = f32(LOG2E)
    x_scale = scale / f32(cap) if cap > 0 else scale * log2e
    cap_out = f32(cap) * log2e
    valid = attention_mask(s, sk, causal, window).numpy()
    rowdot = (do * o).sum(-1, dtype=np.float32)                   # (B, S, H)

    def p_ds(st, dpt, lse_r, d_r, ok):
        """p and ds from s and dp (any layout), the rows' lse and D and the
        validity, as bwd_x and the kernels compute them in fp32."""
        x = st * x_scale
        dfac = np.full_like(x, scale)
        if cap > 0:
            u = f32(2) / (np.exp2(f32(2) * log2e * x) + f32(1))
            dfac = scale * (u * (f32(2) - u))
            x = (f32(1) - u) * cap_out
        p = np.where(ok, np.exp2(x - lse_r), f32(0)).astype(np.float32)
        return p, (p * (dpt - d_r) * dfac).astype(np.float32)

    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    for bi in range(b):
        for j in range(kv):
            for k0 in range(0, sk, bk):
                kt, vt = (_rows(t[bi, :, j], k0, bk, sk) for t in (k, v))
                q_begin = k0 if causal else 0
                q_end = min(s, k0 + bk - 1 + window) if window > 0 else s
                dk_sum, dv_sum = np.zeros((2, bk, hd), np.float32)
                for z in range(split):
                    dk_acc, dv_acc = np.zeros((2, bk, hd), np.float32)
                    for hh in range(j * g + z * gs, j * g + (z + 1) * gs):
                        for q0 in range(q_begin // bq_t * bq_t, q_end, bq_t):
                            qt, ot = (_rows(t[bi, :, hh], q0, bq_t, s)
                                      for t in (q, do))
                            rows = np.arange(q0, q0 + bq_t)
                            keys = np.arange(k0, k0 + bk)
                            ok = np.zeros((bk, bq_t), bool)
                            kin, rin = keys < sk, rows < s
                            ok[np.ix_(kin, rin)] = valid[np.ix_(
                                rows[rin], keys[kin])].T
                            lse_r = _rows(lse[bi, hh], q0, bq_t, s)[None]
                            d_r = _rows(rowdot[bi, :, hh], q0, bq_t, s)[None]
                            pt, dst = p_ds(_scores(kt, qt, jd_kv, terms),
                                           _scores(vt, ot, jd_kv, terms),
                                           lse_r, d_r, ok)
                            dv_acc = _acc_times(dv_acc, pt, ot, jq, terms)
                            dk_acc = _acc_times(dk_acc, dst, qt, jq, terms)
                    dk_sum = dk_sum + dk_acc
                    dv_sum = dv_sum + dv_acc
                n = min(bk, sk - k0)
                dk[bi, k0:k0 + n, j], dv[bi, k0:k0 + n, j] = dk_sum[:n], dv_sum[:n]
        for hh in range(h):
            j = hh // g
            for q0 in range(0, s, bq):
                qt, ot = (_rows(t[bi, :, hh], q0, bq, s) for t in (q, do))
                lse_r = _rows(lse[bi, hh], q0, bq, s)[:, None]
                d_r = _rows(rowdot[bi, :, hh], q0, bq, s)[:, None]
                rows = np.arange(q0, q0 + bq)
                q_last = min(q0 + bq - 1, s - 1)
                k_end = min(sk, q_last + 1) if causal else sk
                k_begin = max(0, q0 - window + 1) if window > 0 else 0
                acc = np.zeros((bq, hd), np.float32)
                for k0 in range(k_begin // bk_t * bk_t, k_end, bk_t):
                    kt, vt = (_rows(t[bi, :, j], k0, bk_t, sk) for t in (k, v))
                    keys = np.arange(k0, k0 + bk_t)
                    ok = np.zeros((bq, bk_t), bool)
                    kin, rin = keys < sk, rows < s
                    ok[np.ix_(rin, kin)] = valid[np.ix_(rows[rin], keys[kin])]
                    ds = p_ds(_scores(qt, kt, jd_q, terms),
                              _scores(ot, vt, jd_q, terms), lse_r, d_r, ok)[1]
                    acc = _acc_times(acc, ds, kt, jk, terms)
                n = min(bq, s - q0)
                dq[bi, q0:q0 + n, hh] = acc[:n]
    return tuple(torch.from_numpy(t) for t in (dq, dk, dv))


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 kernel's 3xTF32 arithmetic (terms 3, 2, 1)")
    args = ap.parse_args()
    g = torch.Generator().manual_seed(0)
    worst_elem = worst_row = 0.0
    for name, (b, s, sk, h, kv, hd, causal, window, cap, qs) in CASES.items():
        q = torch.randn(b, s, h, hd, generator=g) * qs
        k, v = (torch.randn(b, sk, kv, hd, generator=g) for _ in range(2))
        do = torch.randn(b, s, h, hd, generator=g)
        if not args.fp32:
            q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        o, lse = attention_ref_lse(q, k, v, causal, window, cap)
        ref = attention_bwd_ref(q, k, v, o, do, lse, causal, window, cap)
        split = bwd_head_split(b, kv, sk, h // kv, hd)
        for terms in (3, 2, 1) if args.fp32 else (3,):
            got = (replay_fp32(q, k, v, o, do, lse, causal, window, cap,
                               terms=terms) if args.fp32 else
                   replay(q, k, v, o, do, lse, causal, window, cap))
            parts = []
            for label, a, r in zip(("dq", "dk", "dv"), got, ref):
                elem, row = errors(a, r)
                if terms == 3:
                    worst_elem = max(worst_elem, elem)
                    worst_row = max(worst_row, row)
                parts.append(f"{label} elem {elem:.3g} row {row:.3g}")
            label = f", terms {terms}" if args.fp32 else ""
            print(f"{name} (split {split}{label}): " + "; ".join(parts),
                  flush=True)
    print(f"worst per-element error {worst_elem:.4g}, "
          f"per-row {worst_row:.4g}")


if __name__ == "__main__":
    main()

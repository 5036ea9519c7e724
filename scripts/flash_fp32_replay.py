#!/usr/bin/env python3
"""The fp32 flash-attention kernel's 3xTF32 arithmetic replayed on the CPU,
held against the plain version at the fp32 gates.

``replay`` follows ``kernels/flash_attention/csrc/flash_attention_fp32.cuh``
step by step, in numpy float32: kv tiles of ``BK`` keys (32 at hd <= 64,
16 at hd 128; zero past Sk); S = Q.K^T as three TF32 products per fp32
product (each operand split into hi = tf32(x) and lo = tf32(x - hi),
``scripts/tf32x3_replay.py``'s ``split``), per k8 step of hd lo.hi, hi.lo,
then hi.hi into the tile's fp32 accumulator; then in base 2 with log2 e
folded into the scale, x = s * (scale * log2 e), or with the softcap x =
tanh(s * (scale / cap)) * (cap * log2 e), each bracket one fp32 constant
and tanh(y) = 1 - 2 / (exp2(2 y log2 e) + 1); the mask (-inf), the running
max m of x (0 for a row with no valid key yet), p = exp2(x - m) in fp32,
l = l alpha + sum p; O = O alpha, then O += P.V as three TF32 products
per k8 step of keys, each step's keys in the kernel's order 0, 2, 4, 6, 1,
3, 5, 7, ``JC`` steps (16 keys) summed into a zeroed partial that is then
added to O; out = O / max(l, 1e-37).  exp2 here is exact to fp32 (the
kernel's SFU ex2.approx is within about 2^-22 of it), and l sums each
tile's p in another order than the kernel's threads.

``terms`` drops correction terms of both products, to show the margin:

  3   the kernel: lo.hi, hi.lo, hi.hi;
  2   the hi.lo correction dropped (K's and V's rounding left in);
  1   plain TF32: hi.hi only.

For each case the script prints, for each ``terms``, the largest
per-element error over the gate 2e-4 max(1, max|ref|) and the largest
per-row error (one query row of one head: the norm of the difference over
the norm of the plain row) over the gate 1e-4, against the plain version
(``attention_ref``) on standard-normal inputs:

    PYTHONPATH=src python scripts/flash_fp32_replay.py [--seed 0]
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tf32x3_replay import K_STEP, split  # noqa: E402

LOG2E = np.float32(1.4426950408889634)
#: P.V's order of the keys of each k8 step (A column c is key PERM[c]).
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])
#: k8 steps of P.V summed into one partial before it is added to O
#: (``Cfg<HD>::JC``).
JC = 2
ELEM_TOL = 2e-4
ROW_RTOL = 1e-4
# (S, H, KV, hd, causal, window, cap, q scale): Llama's grouping, Gemma2's
# local and global layers, a non-causal case with a ragged Sk, the softcap
# saturated.
CASES = [(512, 8, 2, 64, True, 0, 0.0, 1.0),
         (640, 4, 2, 128, True, 256, 50.0, 1.0),
         (640, 4, 2, 128, True, 0, 50.0, 1.0),
         (300, 4, 2, 64, False, 0, 0.0, 1.0),
         (512, 4, 2, 128, True, 0, 50.0, 8.0)]


def block_keys(hd: int) -> int:
    """Keys per kv tile (``Cfg<HD>::BK``)."""
    return 32 if hd <= 64 else 16


def pairs(a, b, terms: int):
    """The (A, B) operand pairs of each k8 step, in the kernel's order."""
    (ah, al), (bh, bl) = split(a), split(b)
    return {3: ((al, bh), (ah, bl), (ah, bh)), 2: ((al, bh), (ah, bh)),
            1: ((ah, bh),)}[terms]


def mma(acc, a, b, terms: int):
    """acc + A (M, K) . B (K, N), K in k8 steps, as the kernel sums it."""
    ops = pairs(a, b, terms)
    for k in range(0, a.shape[1], K_STEP):
        for x, y in ops:
            acc = acc + x[:, k:k + K_STEP] @ y[k:k + K_STEP]
    return acc


def valid_pairs(s: int, sk: int, causal: bool, window: int) -> np.ndarray:
    qp, kp = np.arange(s)[:, None], np.arange(sk)[None, :]
    mask = np.ones((s, sk), bool)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def replay(q, k, v, causal=True, window=0, cap=0.0, terms=3):
    """The kernel's arithmetic on float32 (B, S, H, hd) q and (B, Sk, KV,
    hd) k, v; query head h reads KV head h // (H // KV)."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    bk = block_keys(hd)
    skp = -(-sk // bk) * bk
    mask = np.zeros((s, skp), bool)
    mask[:, :sk] = valid_pairs(s, sk, causal, window)
    kpad = np.zeros((b, skp, kv, hd), np.float32)
    vpad = np.zeros_like(kpad)
    kpad[:, :sk], vpad[:, :sk] = k, v
    f32 = np.float32
    scale = f32(1.0 / math.sqrt(hd))
    # The kernel's two constants (flash_common.cuh, make_launch).
    x_scale = scale / f32(cap) if cap > 0 else scale * LOG2E
    cap_out = f32(cap) * LOG2E
    out = np.empty((b, s, h, hd), np.float32)
    for bi in range(b):
        for hh in range(h):
            kh = hh // (h // kv)
            qq = q[bi, :, hh].astype(np.float32)
            m = np.full(s, -np.inf, np.float32)
            l = np.zeros(s, np.float32)
            acc = np.zeros((s, hd), np.float32)
            for k0 in range(0, skp, bk):
                valid = mask[:, k0:k0 + bk]
                if not valid.any():
                    continue     # the kernel skips tiles with no valid pair
                kt, vt = kpad[bi, k0:k0 + bk, kh], vpad[bi, k0:k0 + bk, kh]
                x = mma(np.zeros((s, bk), np.float32), qq, kt.T, terms)
                x = x * x_scale
                if cap > 0:
                    y = np.exp2(f32(2) * LOG2E * x)
                    x = (f32(1) - f32(2) / (y + f32(1))) * cap_out
                x = np.where(valid, x, -np.inf).astype(np.float32)
                m_new = np.maximum(m, x.max(1))
                m_use = np.where(m_new == -np.inf, f32(0), m_new)
                alpha = np.exp2(m - m_use)
                p = np.exp2(x - m_use[:, None])
                l = l * alpha + p.sum(1, dtype=np.float32)
                acc = acc * alpha[:, None]
                for j0 in range(0, bk, JC * K_STEP):
                    part = np.zeros_like(acc)
                    for j in range(j0, j0 + JC * K_STEP, K_STEP):
                        keys = j + PERM
                        part = mma(part, p[:, keys], vt[keys], terms)
                    acc = acc + part
                m = m_new
            out[bi, :, hh] = acc * (f32(1) / np.maximum(l, f32(1e-37)))[:, None]
    return out


def errors(got, ref):
    """(max |got - ref| over ELEM_TOL max(1, max|ref|), max row error over
    ROW_RTOL): at most 1 where the gates hold."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    elem = np.abs(got - ref).max() / (ELEM_TOL * max(1.0, np.abs(ref).max()))
    row = (np.linalg.norm(got - ref, axis=-1)
           / np.linalg.norm(ref, axis=-1)).max() / ROW_RTOL
    return float(elem), float(row)


def main() -> None:
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    print("case | terms | max err / (2e-4 max(1, max|ref|)) | "
          "max row err / 1e-4")
    for s, h, kv, hd, causal, window, cap, qs in CASES:
        q = (rng.standard_normal((1, s, h, hd)) * qs).astype(np.float32)
        k, v = (rng.standard_normal((1, s, kv, hd)).astype(np.float32)
                for _ in range(2))
        sk = s if causal else s - 23     # a ragged Sk where not causal
        k, v = k[:, :sk], v[:, :sk]
        ref = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal, window, cap).numpy()
        case = (f"S={s} Sk={sk} H={h} KV={kv} hd={hd} causal={causal} "
                f"window={window} cap={cap} q*{qs:g}")
        for terms in (3, 2, 1):
            elem, row = errors(replay(q, k, v, causal, window, cap, terms), ref)
            print(f"{case} | {terms} | {elem:.4f} | {row:.4f}")


if __name__ == "__main__":
    main()

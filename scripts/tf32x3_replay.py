#!/usr/bin/env python3
"""The fp32 tensor-core GEMM core's 3xTF32 arithmetic replayed on the CPU,
held against a float64 product, to size what the 1e-4 gate can see.

``replay`` follows ``src/repro_torch/kernels/csrc/sgemm_3xtf32.cuh`` (the
core of the fp32 GEMM and of the 3-pass tuple multiply): each operand is
split into hi = tf32(x) and lo = tf32(x - hi), tf32 rounding to 10
mantissa bits with ties away from zero (``cvt.rna.tf32.f32``); K runs in
k8 steps, and per step the three products lo.hi, hi.lo and hi.hi (each a
sum of eight exact products, in fp32) are added to the fp32 accumulator in
that order.  ``terms`` drops terms to show what the gate catches:

  3   the kernel: lo.hi, hi.lo, hi.hi;
  2   the hi.lo correction dropped (B's rounding left in);
  1   plain TF32: hi.hi only.

For each shape the script prints the max error relative to max(1,
max|ref|) of each, beside a plain fp32 product (numpy's float32 matmul),
on standard-normal operands as ``chip_smoke.py`` makes them:

    PYTHONPATH=src python scripts/tf32x3_replay.py [--seed 0]
"""
from __future__ import annotations

import argparse

import numpy as np

K_STEP = 8
# (M, K, N): YOLOv3-tiny 416 b1's L13 and L21, VGG-16 224 L7's tuple
# multiply (one position), VGG-16 L0's (C = 8).
SHAPES = [(169, 1024, 256), (676, 256, 255), (100, 256, 256), (1444, 8, 64)]


def tf32(x: np.ndarray) -> np.ndarray:
    """Round fp32 to TF32 (10 mantissa bits), ties away from zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    """(hi, lo): x = hi + lo + (at most 2^-22 |x|), both TF32."""
    x = x.astype(np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def replay(a: np.ndarray, b: np.ndarray, terms: int = 3) -> np.ndarray:
    """A (M, K) . B (K, N) in fp32 as the kernel sums it."""
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = {3: ((al, bh), (ah, bl), (ah, bh)), 2: ((al, bh), (ah, bh)),
             1: ((ah, bh),)}[terms]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], K_STEP):
        for x, y in pairs:
            acc += x[:, k:k + K_STEP] @ y[k:k + K_STEP]
    return acc


def rel_error(got: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    """max |got - A.B| over max(1, max|A.B|), A.B in float64."""
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    print("shape (M, K, N): 3xTF32 | hi.lo dropped | plain TF32 | fp32, "
          "max error / max(1, max|ref|)")
    for m, k, n in SHAPES:
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
        errs = [rel_error(replay(a, b, t), a, b) for t in (3, 2, 1)]
        errs.append(rel_error(a @ b, a, b))
        print(f"({m}, {k}, {n}): " + " | ".join(f"{e:.2e}" for e in errs))


if __name__ == "__main__":
    main()

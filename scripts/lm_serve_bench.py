#!/usr/bin/env python3
"""Tokens per second of the LM serving engine on the card, as a user calls
it: ``repro_torch.compile(cfg, params).serve(batch_size=4, capacity=128)``
answers 6 requests (8 prompt tokens, 12 new, greedy) of Llama-3.2-1B at
full width with random weights made from ``--seed``, the load that
``chip_smoke.py``'s serving line drives.  One untimed drain, then
``--reps`` timed drains, each a ``run()`` between two synchronizations;
prints the card's name and power limit, each drain's seconds, and the
median's tokens/s.

The script uses only the facade and ``submit``/``run``, so the same file
times two trees of the port in one session on one card (run it from each
tree's root, alternately):

    PYTHONPATH=src python scripts/lm_serve_bench.py [--reps 7] [--label x]
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

import repro_torch
from repro_torch import configs
from repro_torch.models import transformer as tf

BATCH, CAPACITY, REQUESTS, PROMPT, NEW = 4, 128, 6, 8, 12


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = configs.get_config("llama3.2-1b")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    params = tf.init_params(cfg, g)
    engine = repro_torch.compile(cfg, params).serve(batch_size=BATCH,
                                                    capacity=CAPACITY)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=PROMPT)
               for _ in range(REQUESTS)]
    seconds, tokens = [], None
    for rep in range(args.reps + 1):
        uids = [engine.submit(p, max_new_tokens=NEW) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = [res[u] for u in uids]
        if tokens is None:
            tokens = out
        elif out != tokens:
            raise AssertionError("a drain's tokens differ from the first's")
        if rep:
            seconds.append(dt)
    total = sum(len(t) for t in tokens)
    med = statistics.median(seconds)
    print(f"{smi}")
    print(f"lm_serve_bench {args.label}: {cfg.name} batch={BATCH} "
          f"capacity={CAPACITY}, {REQUESTS} requests, {total} tokens a drain;"
          f" drains (s) " + " ".join(f"{s:.4f}" for s in seconds)
          + f"; median {med:.4f} s, {total / med:.1f} tokens/s")


if __name__ == "__main__":
    main()

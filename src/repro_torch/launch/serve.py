"""Serving launcher: batched decode with the continuous-batching engine.
The port of ``repro/launch/serve.py``, with the same flags plus
``--device``.

On the card (the default)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b

On the CPU, through the plain versions::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --smoke --device cpu

Weights are random, from seed 0.  Prints the tokens/s line, then each
request's tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch import configs
from repro_torch.models import transformer as tf


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card (default); cpu: the plain versions")
    args = ap.parse_args(argv)

    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no serving")
    opts = repro_torch.ExecutionOptions(
        impl="cuda" if args.device == "cuda" else "torch", device=args.device)
    generator = torch.Generator(device=args.device).manual_seed(0)
    params = tf.init_params(cfg, generator)
    engine = repro_torch.compile(cfg, params, opts).serve(
        args.batch, args.capacity, temperature=args.temperature)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=args.prompt_len)
        engine.submit(prompt, max_new_tokens=args.new_tokens)
    t0 = time.monotonic()
    results = engine.run()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.monotonic() - t0
    total = sum(len(v) for v in results.values())
    print(f"[serve] {len(results)} requests, {total} tokens "
          f"in {dt:.2f}s ({total / max(dt, 1e-9):.1f} tok/s) on {args.device}")
    for uid, toks in sorted(results.items()):
        print(f"  req {uid}: {toks}")


if __name__ == "__main__":
    main()

"""Training launcher: any arch (full width or its smoke config) through
the fault-tolerant loop.  The port of ``repro/launch/train.py``, with the
same flags plus ``--device``.

On the card (the default)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --seq-len 4096 --batch 4 --grad-accum 2 --out build/train_llama

On the CPU, through the plain versions::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 20 --seq-len 32

Weights are random, from seed 0; data is the Markov token stream of
``repro_torch.data``.  A run resumes from the newest checkpoint in
``--out``.  Prints the parameter count and device, then the last
metrics as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import TrainRunConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_train"))
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--remat", default=None, choices=[None, "none", "full", "dots"])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the kernels on the card; cpu: their plain "
                         "versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible; pass --device cpu to run "
                         "the plain versions on the CPU")

    cfg = (configs.smoke_config(args.arch, seq_len=args.seq_len)
           if args.smoke else configs.get_config(args.arch))
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    opt = AdamWConfig(lr=warmup_cosine(args.lr, args.warmup, args.steps),
                      moment_dtype=args.moment_dtype)
    run = TrainRunConfig(steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         out_dir=args.out, grad_accum=args.grad_accum)
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"device {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})" if args.device == "cuda"
             else ""))
    metrics = train(cfg, shape, opt, run, device=args.device)
    print(json.dumps(metrics, indent=1))


if __name__ == "__main__":
    main()

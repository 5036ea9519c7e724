"""Training loop with checkpoint/restart, heartbeats and straggler counts:
the port of ``repro/train/loop.py``.

Single-process; the fault-tolerance machinery (heartbeat files, failure
detection, elastic re-mesh planning) lives in ``distributed/ft.py`` and is
driven from this loop as a multi-host deployment would drive it.  The
parameters come from ``init_params`` with a ``torch.Generator`` on the
device seeded by ``run.seed``; a run resumes from the newest checkpoint in
``run.out_dir`` (crash or elastic restart), and batches are a pure
function of (seed, step), so a resumed run sees the data an uninterrupted
one would.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import AsyncCheckpointWriter, CheckpointStore
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data import batch_for
from repro_torch.distributed.ft import Heartbeat, StragglerMonitor
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainRunConfig:
    steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    out_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_run")
    grad_accum: int = 1
    resume: bool = True
    heartbeat_every: int = 1


def train(cfg: ModelConfig, shape: ShapeSpec, opt_cfg: adamw.AdamWConfig,
          run: TrainRunConfig, device="cuda",
          state: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """Run the loop on ``device`` (the kernels on a card, their plain
    versions on the CPU); returns the last logged metrics and
    ``slow_steps``.  ``metrics.jsonl`` in ``run.out_dir`` gets one line a
    logged step (its host seconds, ending in the read of its metrics).
    ``state``, when given, is filled with the run's ``start_step`` and its
    final ``params`` and ``opt_state``."""
    device = torch.device(device)
    impl = "cuda" if device.type == "cuda" else "torch"
    os.makedirs(run.out_dir, exist_ok=True)
    store = CheckpointStore(os.path.join(run.out_dir, "ckpt"))
    writer = AsyncCheckpointWriter(store)
    hb = Heartbeat(os.path.join(run.out_dir, "heartbeats"), rank=0)
    straggler = StragglerMonitor(window=20, threshold=2.0)

    gen = torch.Generator(device=device).manual_seed(run.seed)
    params = tf.init_params(cfg, gen, device)
    opt_state = adamw.init(opt_cfg, params)
    start_step = 0
    if run.resume and store.latest_step() is not None:
        start_step, restored = store.restore(
            {"params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]

    step_fn = make_train_step(cfg, opt_cfg, run.grad_accum, impl)
    last: Dict[str, float] = {}
    try:
        with open(os.path.join(run.out_dir, "metrics.jsonl"), "a") as log:
            for step in range(start_step, run.steps):
                t0 = time.monotonic()
                batch = batch_for(cfg, shape, step, seed=run.seed, device=device)
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                if step % run.log_every == 0 or step == run.steps - 1:
                    last = {k: float(v) for k, v in metrics.items()}
                    dt = time.monotonic() - t0
                    log.write(json.dumps({"step": step, "sec": round(dt, 4),
                                          **last}) + "\n")
                    log.flush()
                if step % run.heartbeat_every == 0:
                    hb.beat(step)
                straggler.record(time.monotonic() - t0)
                if (step + 1) % run.checkpoint_every == 0 or step == run.steps - 1:
                    writer.save(step + 1, {"params": params, "opt_state": opt_state},
                                extra={"arch": cfg.name, "shape": shape.name})
    finally:
        writer.wait()
    if state is not None:
        state.update(start_step=start_step, params=params, opt_state=opt_state)
    last["slow_steps"] = float(straggler.slow_count)
    return last

"""The port's training loop, launcher and fault-tolerance pieces on the CPU.

- ``train`` reduces the loss on the Markov token stream;
- a run that crashes after a checkpoint and is started again resumes at
  that checkpoint's step and ends bit for bit where an uninterrupted run
  ends (CPU: every step is deterministic), with the reference's
  ``metrics.jsonl`` and heartbeat files;
- int8 moments and gradient accumulation through the loop;
- ``python -m repro_torch.launch.train --smoke --device cpu`` runs;
- ``distributed/ft.py`` decides as the reference's on the same inputs.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.distributed import ft as j_ft
from repro_torch import configs, optim
from repro_torch import tree as tree_lib
from repro_torch.configs import ShapeSpec
from repro_torch.distributed import ft
from repro_torch.train import TrainRunConfig, loop, train

REPO = Path(__file__).resolve().parents[1]
SHAPE = ShapeSpec("t", 32, 8, "train")


@pytest.fixture(autouse=True)
def one_thread():
    """The loop's smoke-size ops are microseconds each: PyTorch's intra-op
    threads only add their start-up to every op (several times the whole
    loop's time on a shared CPU), so these tests run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(**kw):
    return optim.AdamWConfig(lr=optim.warmup_cosine(3e-3, 5, 40), **kw)


def test_loss_falls_on_the_markov_stream(tmp_path):
    cfg = configs.smoke_config("llama3.2-1b")
    run = TrainRunConfig(steps=40, checkpoint_every=100, log_every=1,
                         out_dir=str(tmp_path))
    last = train(cfg, SHAPE, _opt(), run, device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs] == list(range(40))
    first, end = recs[0]["loss"], recs[-1]["loss"]
    assert end < first - 1.0, (first, end)
    assert last["loss"] == end and "slow_steps" in last


class _Crash(RuntimeError):
    pass


def test_crash_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    cfg = configs.smoke_config("qwen1.5-0.5b")
    opt = _opt()
    whole = {}
    train(cfg, SHAPE, opt, TrainRunConfig(steps=6, checkpoint_every=3,
                                          out_dir=str(tmp_path / "a")),
          device="cpu", state=whole)

    out = tmp_path / "b"
    real = loop.batch_for

    def crash_at_4(cfg, shape, step, **kw):
        if step == 4:
            raise _Crash("host lost")
        return real(cfg, shape, step, **kw)

    monkeypatch.setattr(loop, "batch_for", crash_at_4)
    with pytest.raises(_Crash):
        train(cfg, SHAPE, opt, TrainRunConfig(steps=6, checkpoint_every=3,
                                              out_dir=str(out)), device="cpu")
    monkeypatch.setattr(loop, "batch_for", real)
    resumed = {}
    train(cfg, SHAPE, opt, TrainRunConfig(steps=6, checkpoint_every=3,
                                          out_dir=str(out)),
          device="cpu", state=resumed)
    assert whole["start_step"] == 0 and resumed["start_step"] == 3
    assert int(resumed["opt_state"].step) == 6
    for a, b in zip(tree_lib.leaves([whole["params"], whole["opt_state"]]),
                    tree_lib.leaves([resumed["params"], resumed["opt_state"]])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    steps = [json.loads(line)["step"] for line in open(out / "metrics.jsonl")]
    assert steps == [0, 5]      # log_every 10: step 0 (first run), the last
    beat = json.load(open(out / "heartbeats" / "rank_0.json"))
    assert beat["rank"] == 0 and beat["step"] == 5
    assert sorted(os.listdir(out / "ckpt")) == ["LATEST", "step_3", "step_6"]


def test_resume_restores_the_saved_state_bit_for_bit(tmp_path):
    cfg = configs.smoke_config("gemma2-27b")
    run = TrainRunConfig(steps=2, checkpoint_every=2, out_dir=str(tmp_path))
    first, again = {}, {}
    train(cfg, SHAPE, _opt(moment_dtype="bfloat16"), run, device="cpu", state=first)
    last = train(cfg, SHAPE, _opt(moment_dtype="bfloat16"), run, device="cpu",
                 state=again)
    assert again["start_step"] == 2 and set(last) == {"slow_steps"}
    for a, b in zip(tree_lib.leaves([first["params"], first["opt_state"]]),
                    tree_lib.leaves([again["params"], again["opt_state"]])):
        assert torch.equal(a, b)


def test_int8_moments_and_grad_accum_through_the_loop(tmp_path):
    cfg = configs.smoke_config("granite-moe-1b-a400m")
    run = TrainRunConfig(steps=3, checkpoint_every=2, grad_accum=2, log_every=1,
                         out_dir=str(tmp_path))
    state = {}
    last = train(cfg, SHAPE, _opt(moment_dtype="int8"), run, device="cpu",
                 state=state)
    assert isinstance(state["opt_state"].m["layers"][0]["moe"]["w_up"], optim.QTensor)
    assert torch.isfinite(torch.tensor(last["loss"]))
    assert sorted(last) == ["grad_norm", "loss", "lr", "slow_steps"]


def test_launcher_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "xlstm-125m",
         "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
         "--batch", "2", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[train] xlstm-125m-smoke" in proc.stdout and "device cpu" in proc.stdout
    assert '"loss"' in proc.stdout
    assert (tmp_path / "ckpt" / "step_3" / "manifest.json").exists()


def test_launcher_refuses_cuda_without_a_card(monkeypatch):
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke"])


def test_fault_tolerance_pieces_match_reference(tmp_path):
    for mod, d in ((ft, tmp_path / "a"), (j_ft, tmp_path / "b")):
        for r, t in ((0, 100.0), (2, 30.0)):
            mod.Heartbeat(str(d), rank=r).beat(step=7, now=t)
    dead = ft.FailureDetector(str(tmp_path / "a"), 4, timeout=60).dead_ranks(now=120.0)
    assert dead == j_ft.FailureDetector(str(tmp_path / "b"), 4,
                                        timeout=60).dead_ranks(now=120.0) == [1, 2, 3]
    ours, ref = ft.StragglerMonitor(5, 2.0), j_ft.StragglerMonitor(5, 2.0)
    times = [1.0, 1.1, 0.9, 1.0, 3.5, 1.0, 2.5, 9.0]
    assert [ours.record(t) for t in times] == [ref.record(t) for t in times]
    assert ours.slow_count == ref.slow_count == 3
    plan = ft.ElasticPlanner((8, 4), hosts_per_dp_row=2).plan(16, [3, 5])
    j_plan = j_ft.ElasticPlanner((8, 4), hosts_per_dp_row=2).plan(16, [3, 5])
    assert dataclasses.asdict(plan) == dataclasses.asdict(j_plan)
    assert (ft.ElasticPlanner((8, 4), 2).grad_accum_factor(plan)
            == j_ft.ElasticPlanner((8, 4), 2).grad_accum_factor(j_plan))

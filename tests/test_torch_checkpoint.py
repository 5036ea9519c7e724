"""The port's checkpoint store against the JAX package's, on the CPU.

Both write ``arrays.npz`` + ``manifest.json`` under ``step_N`` with keys
``name::path`` and dtype strings (bf16 as a uint8 view named
"bfloat16"), so each reads the other's checkpoints: a flat tree with fp32,
bf16, int32 and 0-d leaves, and an optimizer state with int8 moments
(``QTensor``) and its step.  Values round-trip bit for bit.  A torn write
(a ``tmp.step_N`` never renamed, a step directory without its manifest, a
LATEST that names one) is never loaded.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import AsyncCheckpointWriter as JWriter
from repro.checkpoint import CheckpointStore as JStore
from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_sched
from repro_torch import configs, optim
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import AsyncCheckpointWriter, CheckpointStore
from repro_torch.models import transformer as tf


def _flat(rng):
    return {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32),
            "n": rng.integers(-5, 5, size=(3,)).astype(np.int32),
            "s": np.float32(rng.normal())}


def _ours(flat):
    out = {k: torch.tensor(v) for k, v in flat.items()}
    out["b"] = out["b"].to(torch.bfloat16)
    return out


def _ref(flat):
    out = {k: jnp.asarray(v) for k, v in flat.items()}
    out["b"] = out["b"].astype(jnp.bfloat16)
    return out


def _equal(t, a):
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        t, a = t.float(), a.astype(np.float32)
    np.testing.assert_array_equal(t.numpy(), a)


def test_port_reads_a_reference_checkpoint(tmp_path):
    flat = _flat(np.random.default_rng(0))
    JStore(str(tmp_path)).save(3, {"params": _ref(flat)}, extra={"who": "jax"})
    template = tree_lib.tree_map(torch.zeros_like, _ours(flat))
    step, out = CheckpointStore(str(tmp_path)).restore({"params": template})
    assert step == 3
    for k, t in out["params"].items():
        assert t.dtype == template[k].dtype and t.shape == template[k].shape
        _equal(t, _ref(flat)[k])


def test_reference_reads_a_port_checkpoint(tmp_path):
    flat = _flat(np.random.default_rng(1))
    CheckpointStore(str(tmp_path)).save(5, {"params": _ours(flat)})
    manifest = json.load(open(tmp_path / "step_5" / "manifest.json"))
    assert manifest["dtypes"]["params::b"] == "bfloat16"
    template = {k: jnp.zeros_like(v) for k, v in _ref(flat).items()}
    step, out = JStore(str(tmp_path)).restore({"params": template})
    assert step == 5
    for k, v in out["params"].items():
        assert v.dtype == template[k].dtype
        _equal(_ours(flat)[k], v)


def test_int8_optimizer_state_crosses_both_ways(tmp_path):
    """An AdamW state with int8 moments written by the reference loads into
    the port's state (QTensor payload and scales, the step), and back."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(4, 300)).astype(np.float32),
              "norm": rng.normal(size=(300,)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    jcfg = j_adamw.AdamWConfig(lr=j_sched.constant(1e-2), moment_dtype="int8")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, jst, _ = j_adamw.update(jcfg, {k: jnp.asarray(v) for k, v in grads.items()},
                               j_adamw.init(jcfg, jp), jp)
    JStore(str(tmp_path / "a")).save(1, {"opt_state": jst})

    ocfg = optim.AdamWConfig(lr=optim.constant(1e-2), moment_dtype="int8")
    template = optim.init(ocfg, {k: torch.tensor(v) for k, v in params.items()})
    _, out = CheckpointStore(str(tmp_path / "a")).restore({"opt_state": template})
    st = out["opt_state"]
    assert int(st.step) == 1 and st.step.dtype == torch.int32
    for k in params:
        for ours, ref in ((st.m[k], jst.m[k]), (st.v[k], jst.v[k])):
            assert isinstance(ours, optim.QTensor) and ours.shape == ref.shape
            np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
            np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))

    CheckpointStore(str(tmp_path / "b")).save(1, {"opt_state": st})
    _, back = JStore(str(tmp_path / "b")).restore(
        {"opt_state": j_adamw.init(jcfg, jp)})
    for k in params:
        np.testing.assert_array_equal(np.asarray(back["opt_state"].m[k].q),
                                      np.asarray(jst.m[k].q))


def test_round_trip_of_a_model_state_is_bit_equal(tmp_path):
    cfg = configs.smoke_config("recurrentgemma-9b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    params = tree_lib.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t,
                               params)
    ocfg = optim.AdamWConfig(lr=optim.constant(1e-3), moment_dtype="int8")
    grads = tree_lib.tree_map(lambda t: torch.randn(t.shape), params)
    params, st, _ = optim.update(ocfg, grads, optim.init(ocfg, params), params)
    store = CheckpointStore(str(tmp_path))
    store.save(7, {"params": params, "opt_state": st}, extra={"arch": cfg.name})
    templates = {"params": tree_lib.tree_map(torch.zeros_like, params),
                 "opt_state": optim.init(ocfg, params)}
    step, out = store.restore(templates)
    assert step == 7
    for a, b in zip(tree_lib.leaves({"params": params, "opt_state": st}),
                    tree_lib.leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_torn_writes_are_never_loaded(tmp_path):
    store = CheckpointStore(str(tmp_path))
    good = {"x": torch.arange(4.0)}
    store.save(2, {"p": good})
    # A write cut before its rename, and a step directory with no manifest.
    os.makedirs(tmp_path / "tmp.step_9")
    np.savez(tmp_path / "tmp.step_9" / "arrays.npz", **{"p::x": np.zeros(4)})
    os.makedirs(tmp_path / "step_8")
    np.savez(tmp_path / "step_8" / "arrays.npz", **{"p::x": np.zeros(4)})
    assert store.all_steps() == [2] and store.latest_step() == 2
    # LATEST naming the torn step falls back to the newest complete one.
    (tmp_path / "LATEST").write_text("8")
    step, out = store.restore({"p": {"x": torch.zeros(4)}})
    assert step == 2 and torch.equal(out["p"]["x"], good["x"])
    (tmp_path / "LATEST").write_text("garbage")
    assert store.latest_step() == 2
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "empty")).restore({"p": good})


def test_keep_last_and_shape_check(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        store.save(s, {"p": {"x": torch.full((3,), float(s))}})
    assert store.all_steps() == [3, 4]
    with pytest.raises(ValueError, match="template"):
        store.restore({"p": {"x": torch.zeros(5)}})


def test_async_writer_snapshots_and_reports_errors(tmp_path):
    store = CheckpointStore(str(tmp_path))
    writer = AsyncCheckpointWriter(store)
    x = torch.arange(6.0)
    writer.save(1, {"p": {"x": x}})
    x.add_(100.0)                      # the next step's in-place update
    writer.wait()
    _, out = store.restore({"p": {"x": torch.zeros(6)}})
    assert torch.equal(out["p"]["x"], torch.arange(6.0))

    class Broken(CheckpointStore):
        def save(self, *a, **k):
            raise OSError("disk full")

    bad = AsyncCheckpointWriter(Broken(str(tmp_path / "b")))
    bad.save(1, {"p": {"x": x}})
    with pytest.raises(OSError, match="disk full"):
        bad.wait()
    bad.wait()                         # the error is raised once


def test_reference_async_writer_output_loads(tmp_path):
    flat = _flat(np.random.default_rng(3))
    w = JWriter(JStore(str(tmp_path)))
    w.save(4, {"params": _ref(flat)})
    w.wait()
    _, out = CheckpointStore(str(tmp_path)).restore(
        {"params": tree_lib.tree_map(torch.zeros_like, _ours(flat))})
    for k, t in out["params"].items():
        _equal(t, _ref(flat)[k])

"""CNN serving through ``repro_torch.compile(...).serve()`` against the JAX
package's ``repro.compile(...).serve()``, and the serving options.

A narrow YOLOv3-tiny at 64x64 is served through buckets (1, 2, 4): seven
requests drain as 4 + 2 + 1.  Both engines take the same images: the
bucket sequence and the stats must be the reference's, and every row its
row at the reference's tolerances (fp32 1e-4 and bf16 2e-2 of max(1,
max|ref|), int8 an SQNR of at least 30 dB).  Each row is also the
compiled forward's of its bucket, on the same padded batch, bit for bit.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.core.quant import sqnr_db
from repro_torch.models.cnn import init_cnn, random_batchnorm
from test_torch_slice import _models, _narrow_tiny

BUCKETS = (1, 2, 4)
N_REQUESTS = 7
HW = (64, 64)
# The reference's impl per dtype: its pure-JAX forward where it has one
# for the type, else its Pallas kernels in interpret mode.
REF_IMPL = {"float32": "jax", "bfloat16": "pallas", "int8": "jax"}


def _setup(dtype, seed=0):
    ours, ref = _models(_narrow_tiny(), HW, "narrow")
    rng = np.random.default_rng(seed)
    params = random_batchnorm(init_cnn(rng, ours.layers), rng)
    images = rng.standard_normal((N_REQUESTS, *HW, 3)).astype(np.float32)
    calibration = images[:2] if dtype == "int8" else None
    compiled = repro_torch.compile(ours, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", dtype=dtype, buckets=BUCKETS),
        calibration=calibration)
    j_compiled = repro.compile(ref, params, repro.ExecutionOptions(
        impl=REF_IMPL[dtype], dtype=dtype, buckets=BUCKETS, cache_path=None),
        calibration=None if calibration is None else jnp.asarray(calibration))
    return compiled, j_compiled, images


def _drain(engine):
    """Step ``engine`` until its queue is empty: the results and the
    bucket each step served."""
    results, sequence = {}, []
    while engine.queue:
        before = dict(engine.stats["batches"])
        results.update(engine.step())
        sequence += [b for b, n in engine.stats["batches"].items()
                     if n != before[b]]
    return results, sequence


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "int8":
        assert sqnr_db(want, got) >= 30.0
        return
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_served_rows_match_the_reference_engine(dtype):
    compiled, j_compiled, images = _setup(dtype)
    engine, j_engine = compiled.serve(), j_compiled.serve()
    uids = [(engine.submit(img), j_engine.submit(img)) for img in images]
    got, sequence = _drain(engine)
    want, j_sequence = _drain(j_engine)
    assert sequence == j_sequence == [4, 2, 1]
    assert engine.stats == j_engine.stats == {
        "batches": {1: 1, 2: 1, 4: 1}, "padded_slots": 0,
        "requests": N_REQUESTS}
    for u, ju in uids:
        assert got[u].device.type == "cpu"
        _close(got[u], want[ju], dtype)
    h = engine.health()
    assert h["ladder"] == ["primary"]
    assert all(h[k] == 0 for k in ("evictions", "rejections", "retries",
                                   "request_failures", "failed_batches",
                                   "faults_injected"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_served_rows_are_the_bucket_forwards(dtype):
    """Each row, bit for bit, the bucket's compiled forward of the padded
    batch it rode in (plans differ by batch, so not the batch-1 forward),
    in the forward's output dtype."""
    compiled, _, images = _setup(dtype)
    engine = compiled.serve(buckets=(4, 2))
    assert engine.buckets == (2, 4)
    uids = [engine.submit(img) for img in images[:5]]
    results, sequence = _drain(engine)
    assert sequence == [4, 2]
    assert engine.stats["padded_slots"] == 1
    rows = {}
    for start, b in ((0, 4), (4, 2)):
        batch = np.zeros((b, *HW, 3), np.float32)
        n = min(b, 5 - start)
        batch[:n] = images[start:start + n]
        out = compiled.executor(b)(torch.from_numpy(batch).to(
            getattr(torch, compiled.options.input_dtype)))
        rows.update({uids[start + i]: out[i] for i in range(n)})
    for u in uids:
        assert results[u].dtype == rows[u].dtype
        assert torch.equal(results[u], rows[u])
    stacked = engine.infer(images[:3])
    assert stacked.shape == (3, *rows[uids[0]].shape)


def test_serve_plans_every_bucket_and_a_warm_cache_tunes_nothing(tmp_path):
    ours, _ = _models(_narrow_tiny(), HW, "narrow")
    params = init_cnn(np.random.default_rng(1), ours.layers)
    opts = repro_torch.ExecutionOptions(
        impl="torch", device="cpu", buckets=(4, 1, 4),
        cache_path=str(tmp_path / "plans.json"))
    assert opts.buckets == (1, 4)
    cold = repro_torch.compile(ours, params, opts).serve()
    assert not cold.warm and set(cold.compiled._netplans) == {1, 4}
    warm = repro_torch.compile(ours, params, opts).serve()
    assert warm.warm and warm.planner.network_hits == 2


# ---------------------------------------------------------------------------
# The serving options


def test_options_json_round_trip():
    opts = repro_torch.ExecutionOptions(
        impl="torch", device="cpu", buckets=(8, 2, 2), max_queue=16,
        default_deadline_s=0.5, retries=3)
    d = opts.to_json()
    assert d["buckets"] == [2, 8]
    back = repro_torch.ExecutionOptions.from_json(json.loads(json.dumps(d)))
    assert back == opts and back.buckets == (2, 8)


@pytest.mark.parametrize("field,value", [
    ("buckets", ()), ("buckets", (0, 4)), ("retries", -1), ("max_queue", 0),
    ("default_deadline_s", 0.0)])
def test_options_refuse_bad_serving_values(field, value):
    with pytest.raises(ValueError, match=field):
        repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                     **{field: value})


def test_an_artifact_saved_before_the_serving_options_loads(tmp_path):
    """An artifact of an earlier release: its options lack the serving
    fields and its plans come from the tile count.  It loads with the
    default serving options, and every plan of the retired rule replans
    (a saved entry holding one is no hit)."""
    ours, _ = _models(_narrow_tiny(), HW, "narrow")
    params = init_cnn(np.random.default_rng(2), ours.layers)
    compiled = repro_torch.compile(ours, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu"))
    path = compiled.save(str(tmp_path / "narrow.json"))
    with open(path) as f:
        data = json.load(f)
    for k in ("buckets", "max_queue", "default_deadline_s", "retries"):
        del data["options"][k]
    for entry in data["networks"].values():
        for step in entry["steps"]:
            if step["plan"] is not None:
                step["plan"]["source"] = "tile_rule"
    with open(path, "w") as f:
        json.dump(data, f)
    loaded = repro_torch.load(path, ours, params)
    assert loaded.options == dataclasses.replace(
        compiled.options, buckets=(1, 4, 8), max_queue=None,
        default_deadline_s=None, retries=1)
    assert loaded.planner.network_hits == 0
    assert loaded.planner.stats["tunes"] > 0
    x = np.random.default_rng(3).standard_normal((1, *HW, 3)).astype(np.float32)
    assert torch.equal(loaded.run(x), compiled.run(x))
    # The loaded model serves with the options' buckets.
    assert loaded.serve().buckets == (1, 4, 8)

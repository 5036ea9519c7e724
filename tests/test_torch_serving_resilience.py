"""Serving resilience of the port: every failure path under injected faults.

The reference's cases (``tests/test_resilience.py``) that need no rung
below the first, run against the port's engines on the CPU (the plain
versions of the kernels):

  - the happy path is invisible: rows equal to the compiled forward's bit
    for bit, counters at zero, the plan cache's bytes unchanged;
  - each fault meets its handler: an exception is retried on the same
    kernels, a NaN row fails its request alone, a batch that stays
    non-finite fails its requests (nothing falls back), an expired
    request is evicted, a full queue raises ``Backpressure``;
  - no request is lost or served twice under a seeded fault storm.

The port has no ladder below its kernels: ``health()["ladder"]`` is
``["primary"]``, and a batch that fails its retries fails its requests.
"""
import os

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.api import CNNModel, ExecutionOptions
from repro_torch.models import transformer as tf
from repro_torch.models.cnn import CNNLayer, init_cnn
from repro_torch.serving import (
    Backpressure,
    DeadlineExceeded,
    FakeClock,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    InvalidRequest,
    QueueNotDrained,
    RequestFailed,
    ServingEngine,
    ServingError,
    corrupt_cache_file,
    is_failure,
)

C = CNNLayer

LAYERS = (
    C("conv", out_channels=8, kernel=3, activation="relu"),
    C("conv", out_channels=4, kernel=1, pad=0, batch_norm=False,
      activation="linear"),
)
HW = (8, 8)
COUNTERS = ("evictions", "rejections", "retries", "request_failures",
            "failed_batches", "faults_injected")


def _compiled(cache_path=None, buckets=(1, 2), **opt_kw):
    model = CNNModel(LAYERS, HW, name="resilience-tiny")
    params = init_cnn(np.random.default_rng(0), LAYERS)
    opts = ExecutionOptions(impl="torch", device="cpu", cache_path=cache_path,
                            buckets=buckets, batch=buckets[0], **opt_kw)
    return repro_torch.compile(model, params, opts)


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, *HW, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# The happy path


def test_happy_path_bit_identical_and_counters_zero():
    compiled = _compiled()
    imgs = _images(3)
    eng = compiled.serve()
    uids = [eng.submit(img) for img in imgs]
    results = eng.run()
    # At the batch sizes the engine dispatched: bucket 2, then bucket 1.
    direct = {uids[0]: compiled.run(imgs[:2])[0],
              uids[1]: compiled.run(imgs[:2])[1],
              uids[2]: compiled.run(imgs[2:3])[0]}
    for u in uids:
        assert torch.equal(results[u], direct[u])
    h = eng.health()
    assert h["ladder"] == ["primary"]
    assert all(h[k] == 0 for k in COUNTERS)
    assert h["buckets"] == {
        "1": {"batches": 1, "retries": 0, "failed_batches": 0},
        "2": {"batches": 1, "retries": 0, "failed_batches": 0}}


def test_happy_path_cache_bytes_stable(tmp_path):
    cache = str(tmp_path / "plans.json")
    eng = _compiled(cache_path=cache).serve()
    eng.submit(_images(1)[0])
    eng.run()
    before = open(cache, "rb").read()
    # A second compilation over the same cache, serving under a fault that
    # its retry absorbs, plans nothing and rewrites nothing.
    faults = FaultPlan([FaultSpec("exception", times=1)])
    eng2 = _compiled(cache_path=cache).serve(faults=faults)
    eng2.submit(_images(1)[0])
    assert not is_failure(eng2.run()[1])
    assert eng2.warm
    assert open(cache, "rb").read() == before


# ---------------------------------------------------------------------------
# Admission: backpressure, validation, deadlines, priority


def test_backpressure_typed_rejection():
    eng = _compiled(max_queue=2).serve()
    eng.submit(_images(1)[0])
    eng.submit(_images(1)[0])
    with pytest.raises(Backpressure) as ei:
        eng.submit(_images(1)[0])
    assert ei.value.queue_len == 2 and ei.value.max_queue == 2
    assert eng.health()["rejections"] == 1
    # Draining the queue opens admission again.
    eng.run()
    eng.submit(_images(1)[0])


def test_submit_validation_cnn():
    eng = _compiled().serve()
    bad = _images(1)[0]
    bad[0, 0, 0] = np.nan
    with pytest.raises(InvalidRequest):
        eng.submit(bad)
    with pytest.raises(ValueError):        # InvalidRequest is a ValueError
        eng.submit(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(InvalidRequest):
        eng.submit(np.zeros((*HW, 3), np.complex64))
    with pytest.raises(InvalidRequest):
        eng.submit(_images(1)[0], deadline_s=-1.0)
    assert eng.health()["queue_len"] == 0, "no rejected payload was enqueued"


def test_deadline_eviction_no_double_serve():
    clock = FakeClock()
    eng = _compiled(buckets=(1, 2)).serve(clock=clock)
    u_exp = eng.submit(_images(1, seed=2)[0], deadline_s=1.0)
    u_ok = eng.submit(_images(1, seed=3)[0])
    clock.advance(5.0)
    results = eng.run()
    assert isinstance(results[u_exp], DeadlineExceeded)
    assert results[u_exp].deadline == pytest.approx(1.0)
    assert not is_failure(results[u_ok])
    assert eng.health()["evictions"] == 1
    assert eng.run() == {} and eng.health()["evictions"] == 1


def test_default_deadline_from_options():
    clock = FakeClock()
    eng = _compiled(default_deadline_s=2.0).serve(clock=clock)
    u = eng.submit(_images(1)[0])
    clock.advance(3.0)
    results = eng.run()
    assert isinstance(results[u], DeadlineExceeded)


def test_priority_dispatch_order():
    eng = _compiled(buckets=(1,)).serve()
    u_low = eng.submit(_images(1, seed=4)[0], priority=0)
    u_high = eng.submit(_images(1, seed=5)[0], priority=5)
    assert set(eng.step()) == {u_high}, "higher priority dispatches first"
    assert set(eng.step()) == {u_low}


# ---------------------------------------------------------------------------
# Retries and request-level failure, on the one rung


def test_retry_recovers_transient_exception():
    faults = FaultPlan([FaultSpec("exception", times=1)])
    compiled = _compiled()
    eng = compiled.serve(faults=faults)
    img = _images(1)[0]
    u = eng.submit(img)
    results = eng.run()
    assert torch.equal(results[u], compiled.run(img[None])[0])
    h = eng.health()
    assert h["retries"] == 1 and h["faults_injected"] == 1
    assert h["failed_batches"] == h["request_failures"] == 0


def test_exception_past_the_retries_fails_the_requests():
    """The port's counterpart of the reference's descent to XLA: with no
    lower rung, a batch that raises on every attempt fails its requests
    with ``RequestFailed``, and the engine serves the next batch."""
    faults = FaultPlan([FaultSpec("exception", times=2)])
    eng = _compiled(buckets=(1, 2)).serve(faults=faults)
    uids = [eng.submit(img) for img in _images(2)]
    results = eng.run()
    assert all(isinstance(results[u], RequestFailed) for u in uids)
    assert "InjectedFault" in results[uids[0]].reason
    assert results[uids[0]].reason.startswith("batch 2 failed 2 attempt(s)")
    h = eng.health()
    assert h["retries"] == 1 and h["failed_batches"] == 1
    assert h["request_failures"] == 2 and h["buckets"]["2"]["failed_batches"] == 1
    u = eng.submit(_images(1)[0])
    assert not is_failure(eng.run()[u])


def test_nan_row_is_request_level_not_batch_level():
    faults = FaultPlan([FaultSpec("nan", rows=(1,), times=2)])
    compiled = _compiled()
    eng = compiled.serve(faults=faults)
    imgs = _images(2)
    u0, u1 = (eng.submit(img) for img in imgs)
    results = eng.run()
    assert isinstance(results[u1], RequestFailed)
    assert "non-finite" in results[u1].reason
    assert torch.equal(results[u0], compiled.run(imgs)[0])
    h = eng.health()
    assert h["request_failures"] == 1 and h["failed_batches"] == 0


def test_fully_nan_batch_fails_after_the_retries():
    """Every live row NaN on every attempt: a batch-level failure, retried,
    then the requests fail; no other realization serves them."""
    faults = FaultPlan([FaultSpec("inf", times=2)])
    eng = _compiled().serve(faults=faults)
    uids = [eng.submit(img) for img in _images(2)]
    results = eng.run()
    assert all(isinstance(results[u], RequestFailed) for u in uids)
    assert "non-finite" in results[uids[0]].reason
    h = eng.health()
    assert h["retries"] == 1 and h["faults_injected"] == 2
    assert h["failed_batches"] == 1 and h["ladder"] == ["primary"]


def test_fully_nan_batch_recovered_by_a_retry():
    faults = FaultPlan([FaultSpec("nan", times=1)])
    compiled = _compiled()
    eng = compiled.serve(faults=faults)
    imgs = _images(2)
    uids = [eng.submit(img) for img in imgs]
    results = eng.run()
    want = compiled.run(imgs)
    assert all(torch.equal(results[u], want[i]) for i, u in enumerate(uids))
    assert eng.health()["retries"] == 1


def test_zero_retries_fail_fast():
    faults = FaultPlan([FaultSpec("exception", times=1)])
    eng = _compiled(retries=0, buckets=(1,)).serve(faults=faults)
    u = eng.submit(_images(1)[0])
    assert isinstance(eng.run()[u], RequestFailed)
    assert eng.health()["retries"] == 0


def test_infer_raises_typed_error_on_failures():
    faults = FaultPlan([FaultSpec("exception", times=99)])
    eng = _compiled(retries=0, buckets=(1, 2)).serve(faults=faults)
    with pytest.raises(ServingError):
        eng.infer(_images(2))


def test_latency_fault_expires_next_request():
    clock = FakeClock()
    faults = FaultPlan(
        [FaultSpec("latency", latency_s=10.0, times=1)])
    eng = _compiled(buckets=(1,)).serve(clock=clock, faults=faults)
    u1 = eng.submit(_images(1, seed=6)[0], deadline_s=5.0)
    u2 = eng.submit(_images(1, seed=7)[0], deadline_s=5.0)
    results = eng.run()
    # The spike lands while u1 is dispatched (it serves); u2 is then past
    # its deadline and is evicted, not served stale.
    assert not is_failure(results[u1])
    assert isinstance(results[u2], DeadlineExceeded)


def test_queue_not_drained_carries_partials():
    eng = _compiled(buckets=(1,)).serve()
    uids = [eng.submit(img) for img in _images(3)]
    with pytest.raises(QueueNotDrained) as ei:
        eng.run(max_steps=1)
    assert set(ei.value.results) == {uids[0]}
    assert ei.value.remaining == uids[1:]
    assert set(eng.run()) == set(uids[1:])


def test_a_lost_device_is_not_retried(monkeypatch):
    """An error after which the card runs nothing (a sticky CUDA error)
    raises out of the engine at once instead of being retried into a
    ``RequestFailed``."""
    eng = _compiled(buckets=(1,)).serve(
        faults=FaultPlan([FaultSpec("exception", times=1)]))
    monkeypatch.setattr(eng, "_device_lost", lambda: True)
    eng.submit(_images(1)[0])
    with pytest.raises(InjectedFault):
        eng.run()
    assert eng.health()["retries"] == 0


def test_corrupt_cache_fault_quarantines_the_file(tmp_path):
    cache = str(tmp_path / "plans.json")
    _compiled(cache_path=cache)
    faults = FaultPlan([FaultSpec("corrupt_cache", path=cache)])
    eng = _compiled(cache_path=cache).serve(faults=faults)
    u = eng.submit(_images(1)[0])
    assert not is_failure(eng.run()[u])
    with pytest.warns(RuntimeWarning, match="corrupt"):
        _compiled(cache_path=cache)
    assert any(n.startswith("plans.json.corrupt-")
               for n in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# The fault harness


def test_seeded_fault_plan_deterministic():
    a = FaultPlan.seeded(7, n_faults=5, steps=10)
    b = FaultPlan.seeded(7, n_faults=5, steps=10)
    assert [vars(s) for s in a.specs] == [vars(s) for s in b.specs]
    c = FaultPlan.seeded(8, n_faults=5, steps=10)
    assert [vars(s) for s in a.specs] != [vars(s) for s in c.specs]


def test_fault_plan_draw_logs_and_exhausts():
    plan = FaultPlan([FaultSpec("exception", step=2, times=1)])
    assert plan.draw(1, 1) is None
    assert plan.draw(2, 1) is not None
    assert plan.draw(2, 1) is None      # budget spent
    assert plan.exhausted
    assert plan.injected == 1 and len(plan.log) == 3


def test_corrupt_cache_file_modes(tmp_path):
    path = str(tmp_path / "c.json")
    text = b'{"version": 2, "plans": {"k": [1, 2, 3]}}' * 4
    for mode in ("truncate", "garbage"):
        with open(path, "wb") as f:
            f.write(text)
        corrupt_cache_file(path, mode)
        assert open(path, "rb").read() != text
    with pytest.raises(ValueError, match="mode"):
        corrupt_cache_file(path, "shred")


def test_no_loss_no_double_serve_under_fault_storm():
    faults = FaultPlan.seeded(
        123, n_faults=6, steps=8, kinds=("exception", "nan", "inf"))
    eng = _compiled(buckets=(1, 2)).serve(faults=faults)
    uids = [eng.submit(img) for img in _images(9, seed=9)]
    seen = {}
    for _ in range(50):
        if not eng.queue:
            break
        step = eng.step()
        dup = set(step) & set(seen)
        assert not dup, f"uids served twice: {dup}"
        seen.update(step)
    assert set(seen) == set(uids), "every submitted request gets a result"


# ---------------------------------------------------------------------------
# The LM engine


@pytest.fixture(scope="module")
def lm_setup():
    cfg = configs.smoke_config("llama3.2-1b", seq_len=64)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params


def _engine(lm_setup, batch_size=1, **kw):
    cfg, params = lm_setup
    return ServingEngine(cfg, params, batch_size=batch_size, capacity=64,
                         impl="torch", **kw)


def _prompts(cfg, n, length=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, length) for _ in range(n)]


def test_lm_submit_validation(lm_setup):
    cfg, _ = lm_setup
    eng = _engine(lm_setup)
    with pytest.raises(ValueError):
        eng.submit(np.array([], np.int32))
    with pytest.raises(InvalidRequest):
        eng.submit(np.array([0.5, 1.5], np.float32))
    with pytest.raises(InvalidRequest):
        eng.submit(np.array([cfg.vocab_size + 3], np.int64))
    with pytest.raises(InvalidRequest):
        eng.submit(np.array([-1], np.int64))


def test_lm_backpressure_and_deadline(lm_setup):
    cfg, _ = lm_setup
    clock = FakeClock()
    eng = _engine(lm_setup, max_queue=1, clock=clock)
    p = _prompts(cfg, 2)
    u1 = eng.submit(p[0], max_new_tokens=2, deadline_s=1.0)
    with pytest.raises(Backpressure):
        eng.submit(p[1], max_new_tokens=2)
    clock.advance(2.0)
    results = eng.run()
    assert isinstance(results[u1], DeadlineExceeded)
    assert eng.health()["evictions"] == 1


def test_lm_mid_decode_eviction_frees_the_slot(lm_setup):
    """A request that expires while decoding is evicted and its slot taken
    by the next, which decodes as it would alone."""
    cfg, _ = lm_setup
    p = _prompts(cfg, 2, seed=1)
    alone = _engine(lm_setup)
    u = alone.submit(p[1], max_new_tokens=3)
    want = alone.run()[u]

    clock = FakeClock()
    faults = FaultPlan([FaultSpec("latency", step=5, latency_s=10.0)])
    eng = _engine(lm_setup, clock=clock, faults=faults)
    u0 = eng.submit(p[0], max_new_tokens=8, deadline_s=5.0)
    u1 = eng.submit(p[1], max_new_tokens=3)
    results = eng.run()
    assert isinstance(results[u0], DeadlineExceeded)
    assert results[u1] == want
    assert eng.health()["evictions"] == 1


def test_lm_priority_admission(lm_setup):
    cfg, _ = lm_setup
    eng = _engine(lm_setup)
    p = _prompts(cfg, 2, seed=2)
    u_low = eng.submit(p[0], max_new_tokens=1)
    u_high = eng.submit(p[1], max_new_tokens=1, priority=3)
    eng._admit()
    assert eng.slot_req[0].uid == u_high
    assert set(eng.run()) == {u_low, u_high}


def test_lm_decode_exception_retried_on_the_same_step(lm_setup):
    cfg, _ = lm_setup
    prompts = _prompts(cfg, 2, seed=3)
    clean = _engine(lm_setup, batch_size=2)
    uids = [clean.submit(p, max_new_tokens=3) for p in prompts]
    want = clean.run()

    faults = FaultPlan([FaultSpec("exception", times=1)])
    eng = _engine(lm_setup, batch_size=2, faults=faults)
    uids2 = [eng.submit(p, max_new_tokens=3) for p in prompts]
    got = eng.run()
    for u, u2 in zip(uids, uids2):
        assert got[u2] == want[u], "the retried step decodes the same tokens"
    h = eng.health()
    assert h["retries"] == 1 and h["faults_injected"] == 1
    assert h["buckets"]["decode"]["failed_batches"] == 0


def test_lm_decode_failing_its_retries_fails_the_live_requests(lm_setup):
    cfg, _ = lm_setup
    prompts = _prompts(cfg, 2, length=2, seed=4)
    # Steps 1 and 2 are the two single-slot prefills; step 3 is the first
    # joint decode.
    faults = FaultPlan([FaultSpec("exception", step=3, times=2)])
    eng = _engine(lm_setup, batch_size=2, faults=faults)
    uids = [eng.submit(p, max_new_tokens=3) for p in prompts]
    results = eng.run()
    assert all(isinstance(results[u], RequestFailed) for u in uids)
    assert eng.health()["request_failures"] == 2
    u = eng.submit(prompts[0], max_new_tokens=2)
    assert len(eng.run()[u]) == 2, "the engine serves on"


def test_lm_nan_row_fails_one_request(lm_setup):
    cfg, _ = lm_setup
    prompts = _prompts(cfg, 2, length=2, seed=4)
    faults = FaultPlan(
        [FaultSpec("nan", rows=(1,), step=3, times=1)])
    eng = _engine(lm_setup, batch_size=2, faults=faults, retries=0)
    u0 = eng.submit(prompts[0], max_new_tokens=3)
    u1 = eng.submit(prompts[1], max_new_tokens=3)
    results = eng.run()
    assert isinstance(results[u1], RequestFailed)
    assert isinstance(results[u0], list) and len(results[u0]) == 3
    assert eng.health()["request_failures"] == 1


def test_lm_prefill_retry_starts_the_slot_over(lm_setup):
    """A prompt's prefill is one guarded call: a poisoned attempt (its
    steps did run) is retried from a reset slot, so the tokens equal a
    clean run's."""
    cfg, _ = lm_setup
    prompts = _prompts(cfg, 2, seed=7)
    clean = _engine(lm_setup, batch_size=2)
    uids = [clean.submit(p, max_new_tokens=3) for p in prompts]
    want = clean.run()
    faults = FaultPlan([FaultSpec("nan", step=1, times=1)])
    eng = _engine(lm_setup, batch_size=2, faults=faults)
    uids2 = [eng.submit(p, max_new_tokens=3) for p in prompts]
    got = eng.run()
    assert [got[u] for u in uids2] == [want[u] for u in uids]
    assert list(eng.pos) == list(clean.pos), "the retry restarts at 0"
    h = eng.health()
    assert h["retries"] == 1 and h["request_failures"] == 0


def test_lm_prefill_failing_its_retries_fails_the_request(lm_setup):
    cfg, _ = lm_setup
    prompts = _prompts(cfg, 2, seed=7)
    alone = _engine(lm_setup)
    u = alone.submit(prompts[1], max_new_tokens=3)
    want = alone.run()[u]
    faults = FaultPlan([FaultSpec("nan", step=1, times=2)])
    eng = _engine(lm_setup, batch_size=2, faults=faults)
    u0, u1 = (eng.submit(p, max_new_tokens=3) for p in prompts)
    results = eng.run()
    assert isinstance(results[u0], RequestFailed)
    assert results[u1] == want
    h = eng.health()
    assert h["request_failures"] == 1 and h["failed_batches"] == 1


def test_lm_nan_row_of_the_step_fails_one_request(lm_setup):
    """A row the decode step itself makes non-finite, with no fault
    injected, is caught by the mask the step writes beside its logits."""
    cfg, _ = lm_setup
    prompts = _prompts(cfg, 2, length=2, seed=4)
    eng = _engine(lm_setup, batch_size=2, retries=0)
    step = eng.step

    def nan_row_1(tokens, pos, live):
        logits = step(tokens, pos, live)
        if bool(live.all()):            # joint decode, not a prefill step
            logits[1] = float("nan")
        return logits

    eng.step = nan_row_1
    u0 = eng.submit(prompts[0], max_new_tokens=3)
    u1 = eng.submit(prompts[1], max_new_tokens=3)
    results = eng.run()
    assert isinstance(results[u1], RequestFailed)
    assert "non-finite" in results[u1].reason
    assert isinstance(results[u0], list) and len(results[u0]) == 3
    h = eng.health()
    assert h["request_failures"] == 1 and h["faults_injected"] == 0


def test_lm_sampling_at_a_temperature_is_seeded(lm_setup):
    """Above temperature 0 the engine draws from the logits (not the
    step's greedy tokens): the same seed, the same draws."""
    cfg, _ = lm_setup
    p = _prompts(cfg, 2, seed=6)
    runs = []
    for seed in (3, 3):
        eng = _engine(lm_setup, batch_size=2, temperature=1.0, seed=seed)
        uids = [eng.submit(q, max_new_tokens=6) for q in p]
        res = eng.run()
        runs.append([res[u] for u in uids])
    assert runs[0] == runs[1]
    greedy = _engine(lm_setup, batch_size=2)
    uids = [greedy.submit(q, max_new_tokens=6) for q in p]
    res = greedy.run()
    assert runs[0] != [res[u] for u in uids]
    assert all(0 <= t < cfg.vocab_size for r in runs[0] for t in r)


def test_lm_queue_not_drained(lm_setup):
    cfg, _ = lm_setup
    eng = _engine(lm_setup)
    p = _prompts(cfg, 2, seed=5)
    u1 = eng.submit(p[0], max_new_tokens=4)
    u2 = eng.submit(p[1], max_new_tokens=4)
    with pytest.raises(QueueNotDrained) as ei:
        eng.run(max_steps=1)
    assert u2 in ei.value.remaining
    assert set(eng.run()) == {u1, u2}


def test_lm_serve_passes_the_options_through(lm_setup):
    cfg, params = lm_setup
    lm = repro_torch.compile(cfg, params, ExecutionOptions(
        impl="torch", device="cpu", batch=2, max_queue=3,
        default_deadline_s=4.0, retries=2))
    eng = lm.serve(capacity=64)
    h = eng.health()
    assert (eng.batch, h["max_queue"], h["default_deadline_s"],
            h["retries_allowed"]) == (2, 3, 4.0, 2)
    assert lm.serve(capacity=64, retries=0).health()["retries_allowed"] == 0

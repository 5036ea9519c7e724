"""Multi-device CNN inference in the port against the JAX package: the
cost-balanced stage partition, its plan-cache entries, GPipe's schedule
(``distributed/pipeline.py``), batch sharding and the facade's options.

Everything runs on the CPU in this process: a device list of
``["cpu"] * k`` stands for k devices (each entry its own stage or shard,
with its own copy of the parameters), ``impl="torch"`` (the plain
versions of the kernels), full widths at 32x32, batch <= 8, inputs and
parameters from a numpy seed.

- The partition: ``layer_ref_spans``, the schedule model
  (``modeled_pipeline_latency``, ``choose_n_micro``, ``bubble_fraction``)
  and the searches (``partition_network``, ``equal_count_partition``)
  equal the reference's.  The reference's search runs on a stand-in that
  carries the port's steps, layouts, batch and ``step_seconds``, so both
  see the same inputs, and the port is given the reference's tick
  overhead (2e-6 s).
- The forward: the pipelined forward against the reference's
  single-device ``run_network`` at ``rtol=1e-4``, ``atol=1e-4 *
  max|ref|`` (tests/test_api.py), and against the port's own unsharded
  executor at 1e-5 (the same plain ops, only the microbatch differs);
  bf16 within 2e-2 * max(1, max|ref|) of the port's single-device bf16
  forward (the reference suite's bf16 tolerance); int8 at an SQNR of at
  least 40 dB against the reference's int8 forward (tests/test_torch_int8.py).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.configs import vgg16 as jvgg16
from repro.configs import yolov3 as jyolov3
from repro.core import netplan as jnetplan
from repro.core.planner import Planner as JPlanner
from repro.models.cnn import layer_ref_spans as j_layer_ref_spans
from repro_torch.configs import vgg16, yolov3
from repro_torch.core import netplan
from repro_torch.core.netplan import (
    NetworkExecutor,
    PipelinePlan,
    choose_n_micro,
    equal_count_partition,
    legal_cut_points,
    modeled_pipeline_latency,
    partition_network,
    plan_network,
    plan_pipeline,
    run_network,
    step_seconds,
)
from repro_torch.core.planner import Planner, plan_is_current
from repro_torch.core.quant import sqnr_db
from repro_torch.distributed.pipeline import PipelineExecutor, gpipe_schedule
from repro_torch.launch.mesh import stage_devices
from repro_torch.models.cnn import (
    init_cnn,
    layer_ref_spans,
    params_from_numpy,
    random_batchnorm,
)

HW = 32
REF_TICK_S = 2e-6           # the reference's TICK_OVERHEAD_S
MODELS = {"yolov3-tiny": (yolov3.TINY_MODEL, jyolov3.TINY_LAYERS),
          "yolov3-20": (yolov3.MODEL_20, jyolov3.LAYERS_20),
          "vgg16": (vgg16.MODEL, jvgg16.LAYERS)}


def _model(name, hw=HW):
    model = MODELS[name][0]
    return repro_torch.CNNModel(model.layers, (hw, hw), name=f"{name} {hw}")


def _netplan(name, batch, dtype="float32", hw=HW, planner=None):
    return plan_network(MODELS[name][0].layers, hw, hw,
                        planner if planner is not None
                        else Planner(impl="torch", device="cpu"),
                        batch=batch, dtype=dtype)


def _params(name, seed=0):
    rng = np.random.default_rng(seed)
    return random_batchnorm(init_cnn(rng, MODELS[name][0].layers), rng)


def _input(batch, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, HW, HW, 3)).astype(np.float32)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


def _standin(np_):
    """The port's plan as the reference's partitioner reads a NetworkPlan:
    its steps' layers and output layouts, its batch, and each step's
    seconds (``step_seconds``) as ``plan.predicted_s``."""
    seconds = step_seconds(np_)
    steps = [types.SimpleNamespace(
        layer=s.layer, out_layout=s.out_layout,
        plan=types.SimpleNamespace(predicted_s=t))
        for s, t in zip(np_.steps, seconds)]
    return types.SimpleNamespace(steps=steps, batch=np_.batch)


# ---------------------------------------------------------------------------
# The partition


@pytest.mark.parametrize("name", sorted(MODELS))
def test_layer_ref_spans_match_reference(name):
    ours, ref = MODELS[name]
    assert layer_ref_spans(ours.layers) == j_layer_ref_spans(ref)


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_schedule_model_matches_reference(n_stages):
    rng = np.random.default_rng(n_stages)
    ref_plan = jnetplan.PipelinePlan
    for _ in range(20):
        seconds = tuple(float(t) for t in rng.uniform(1e-6, 5e-4, n_stages))
        for batch in (1, 2, 4, 6, 8, 12):
            m = choose_n_micro(seconds, batch, REF_TICK_S)
            assert m == jnetplan.choose_n_micro(seconds, batch)
            assert batch % m == 0
            for n_micro in (1, 2, 3, m):
                assert modeled_pipeline_latency(
                    seconds, n_micro, REF_TICK_S) == \
                    jnetplan.modeled_pipeline_latency(seconds, n_micro)
                bounds = tuple((i, i + 1) for i in range(n_stages))
                ours = PipelinePlan(bounds, seconds, m)
                ref = ref_plan(bounds, seconds, m)
                assert ours.bubble_fraction(n_micro) == \
                    ref.bubble_fraction(n_micro)
                assert ours.modeled_latency_s(n_micro, REF_TICK_S) == \
                    ref.modeled_latency_s(n_micro)


PARTITIONS = [("yolov3-tiny", "float32", 1, 2), ("yolov3-tiny", "float32", 8, 2),
              ("yolov3-tiny", "bfloat16", 8, 3), ("yolov3-tiny", "int8", 4, 2),
              ("yolov3-20", "float32", 8, 2), ("yolov3-20", "int8", 2, 3),
              ("vgg16", "float32", 8, 4), ("vgg16", "bfloat16", 4, 4),
              ("vgg16", "int8", 8, 3)]


@pytest.mark.parametrize("name,dtype,batch,n_stages", PARTITIONS)
def test_partition_matches_reference(name, dtype, batch, n_stages):
    """Both searches give the reference's bounds, seconds and microbatch
    count on the same steps, seconds and tick overhead; the balanced
    partition models no slower than the equal-count one."""
    np_ = _netplan(name, batch, dtype)
    standin = _standin(np_)
    assert legal_cut_points(np_) == jnetplan.legal_cut_points(standin)
    for ours_fn, ref_fn in ((partition_network, jnetplan.partition_network),
                            (equal_count_partition,
                             jnetplan.equal_count_partition)):
        ours = ours_fn(np_, n_stages, tick_overhead_s=REF_TICK_S)
        ref = ref_fn(standin, n_stages)
        assert ours.stage_bounds == ref.stage_bounds
        assert ours.n_micro == ref.n_micro
        assert ours.stage_seconds == pytest.approx(ref.stage_seconds,
                                                   rel=1e-12)
    balanced = partition_network(np_, n_stages)
    equal = equal_count_partition(np_, n_stages)
    assert balanced.modeled_latency_s() <= equal.modeled_latency_s()


@pytest.mark.parametrize("name,dtype,batch,n_stages", PARTITIONS)
def test_minmax_partition_matches_reference(name, dtype, batch, n_stages,
                                            monkeypatch):
    """Past the exact search's budget (here 0 candidates, in both
    packages) the min-max DP gives the reference's bounds and microbatch
    count, and no stage larger than the exact search's largest."""
    np_ = _netplan(name, batch, dtype)
    exact = partition_network(np_, n_stages, tick_overhead_s=REF_TICK_S)
    monkeypatch.setattr(netplan, "_EXACT_SEARCH_LIMIT", 0)
    monkeypatch.setattr(jnetplan, "_EXACT_SEARCH_LIMIT", 0)
    ours = partition_network(np_, n_stages, tick_overhead_s=REF_TICK_S)
    ref = jnetplan.partition_network(_standin(np_), n_stages)
    assert ours.stage_bounds == ref.stage_bounds
    assert ours.n_micro == ref.n_micro
    assert ours.stage_seconds == pytest.approx(ref.stage_seconds, rel=1e-12)
    assert max(ours.stage_seconds) <= max(exact.stage_seconds) * (1 + 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_full_size_networks_have_three_legal_cuts(name, dtype):
    """YOLOv3-tiny 416, MODEL_20 608 and VGG-16 224 at the port's channel
    layouts: at least 3 legal cuts in each type, so 4 stages always
    partition."""
    model = MODELS[name][0]
    np_ = plan_network(model.layers, *model.input_hw,
                       Planner(impl="cuda", device="cpu"), batch=8,
                       dtype=dtype)
    assert len(legal_cut_points(np_)) >= 3
    plan = partition_network(np_, 4)
    assert plan.n_stages == 4 and 8 % plan.n_micro == 0


def test_step_seconds_price_cost_mode_plans():
    """A cost-mode plan has no predicted time: its conv steps are priced by
    the card's cost model, every other step weighs 0; a model-mode plan's
    own predictions are taken as they are."""
    from repro_torch.core.codesign import predict_conv_time

    np_ = _netplan("yolov3-tiny", 4)
    seconds = step_seconds(np_)
    for s, t in zip(np_.steps, seconds):
        if s.layer.kind != "conv":
            assert t == 0.0
        else:
            assert s.plan.predicted_s is None
            assert t == predict_conv_time(
                s.spec, *s.in_hw, s.plan.algorithm, batch=4,
                winograd_fused=s.plan.winograd_fused) > 0
    modeled = _netplan("yolov3-tiny", 4, planner=Planner(
        impl="torch", device="cpu", mode="model"))
    assert step_seconds(modeled) == tuple(
        s.plan.predicted_s if s.plan is not None else 0.0
        for s in modeled.steps)


def test_partition_rejects_impossible_stage_counts():
    np_ = _netplan("yolov3-20", 2)
    assert len(legal_cut_points(np_)) == 4
    with pytest.raises(ValueError, match="legal cut points"):
        partition_network(np_, 6)
    with pytest.raises(ValueError):
        partition_network(np_, 0)


def test_pipeline_plan_json_round_trip():
    plan = partition_network(_netplan("vgg16", 8), 4)
    assert PipelinePlan.from_json(plan.to_json()) == plan
    assert 0.0 < plan.bubble_fraction() < 1.0


def test_plan_pipeline_warm_cache(tmp_path, monkeypatch):
    """Cold: partitioned and stored.  Warm, from the file: zero
    re-partitions, counted in ``pipeline_hits``.  Entries are scoped by
    stage count, and a corrupt entry re-partitions."""
    path = str(tmp_path / "plans.json")
    layers = yolov3.TINY_LAYERS

    def planner():
        return Planner(impl="torch", device="cpu", cache_path=path)

    cold = planner()
    two = plan_pipeline(layers, HW, HW, cold, 2, batch=4)
    three = plan_pipeline(layers, HW, HW, cold, 3, batch=4)
    assert cold.pipeline_hits == 0 and two.n_stages == 2
    cold.save()

    warm = planner()

    def no_partition(*a, **k):
        raise AssertionError("re-partitioned a cached network")

    with monkeypatch.context() as m:
        m.setattr(netplan, "partition_network", no_partition)
        assert plan_pipeline(layers, HW, HW, warm, 2, batch=4) == two
        assert plan_pipeline(layers, HW, HW, warm, 3, batch=4) == three
    assert warm.pipeline_hits == 2

    key = netplan.pipeline_key(layers, HW, HW, 3, 4, 2, warm)
    for bad in ({"stage_bounds": [[0, 5]], "stage_seconds": [0.1],
                 "n_micro": 1},
                {"stage_bounds": [[0, 9], [9, 22]], "stage_seconds": [1, 1],
                 "n_micro": 1},            # 9 is no legal cut (a route span)
                {"junk": 1}):
        warm.put_pipeline_entry(key, bad)
        hits = warm.pipeline_hits
        assert plan_pipeline(layers, HW, HW, warm, 2, batch=4) == two
        assert warm.pipeline_hits == hits
        assert warm.pipeline_entry(key) == two.to_json()


def test_stage_devices():
    assert stage_devices(2, ["cpu"] * 3) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 3 devices"):
        stage_devices(3, ["cpu", "cpu"])


@pytest.mark.parametrize("n_stages,n_micro", [(1, 1), (2, 1), (3, 4), (4, 2)])
def test_gpipe_schedule(n_stages, n_micro):
    """GPipe's n_micro + S - 1 ticks with the reference's active window,
    each (stage, microbatch) once; stage s runs m after stage s-1 ran it,
    and within a tick after stage s+1's turn."""
    sched = gpipe_schedule(n_stages, n_micro)
    assert sorted((s, m) for _, s, m in sched) == [
        (s, m) for s in range(n_stages) for m in range(n_micro)]
    assert max(t for t, _, _ in sched) == n_micro + n_stages - 2
    pos = {(s, m): i for i, (_, s, m) in enumerate(sched)}
    for t, s, m in sched:
        assert t == s + m
        if s:
            assert pos[s - 1, m] < pos[s, m]
        if s + 1 < n_stages and m >= 1:
            assert pos[s + 1, m - 1] < pos[s, m]


def test_kernel_launches_of_slices_sum_to_the_network():
    np_ = _netplan("yolov3-tiny", 8)
    plan = partition_network(np_, 3)
    total = {}
    for a, z in plan.stage_bounds:
        for k, n in np_.kernel_launches(a, z).items():
            total[k] = total.get(k, 0) + n
    assert total == np_.kernel_launches()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_full_batch_plan_holds_at_microbatch_size(name, dtype):
    """A shard runs the full batch's plan at batch / n and a stage at
    batch / n_micro: every step's blocks are the kernel's at those sizes
    too (the kernels compile their tiles and take their split counts from
    the call's shapes, kernels/_splitk.py)."""
    model = MODELS[name][0]
    np_ = plan_network(model.layers, *model.input_hw,
                       Planner(impl="cuda", device="cpu"), batch=8,
                       dtype=dtype)
    for s in np_.steps:
        if s.plan is not None:
            for mb in (1, 2, 4):
                assert plan_is_current(s.plan, s.spec, *s.in_hw, mb)


def test_a_slice_may_not_cut_a_route_span():
    np_ = _netplan("yolov3-tiny", 1)
    with pytest.raises(ValueError, match="route or shortcut"):
        run_network(np_, [{}] * 13, torch.zeros(1, 2, 2, 256), start=9)


# ---------------------------------------------------------------------------
# The forward


_REFS = {}


def _ref_forward(name, batch, dtype="float32"):
    """The reference's single-device forward (impl='jax'): ``run_network``
    on prepared params, or under int8 ``repro.compile(...).run`` with the
    input as the calibration batch (cached per case)."""
    key = (name, batch, dtype)
    if key not in _REFS:
        params, x = _params(name), _input(batch)
        layers = MODELS[name][1]
        if dtype == "int8":
            ref_model = (jyolov3.TINY_MODEL if name == "yolov3-tiny"
                         else jvgg16.MODEL).with_input_hw((HW, HW))
            _REFS[key] = np.asarray(repro.compile(
                ref_model, params, repro.ExecutionOptions(
                    impl="jax", dtype="int8", batch=batch, cache_path=None),
                calibration=jnp.asarray(x)).run(jnp.asarray(x)))
        else:
            jplan = jnetplan.plan_network(layers, HW, HW,
                                          JPlanner(impl="jax", cache_path=None),
                                          batch=batch)
            flags = jnetplan.pretransform_flags(jplan, True)
            prepared = jnetplan.prepare_net_params(jplan, params,
                                                   pretransform=True)
            _REFS[key] = np.asarray(jnetplan.run_network(
                jplan, prepared, jnp.asarray(x), pretransformed=flags))
    return _REFS[key]


@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3-20", "vgg16"])
def test_pipelined_forward_matches_reference(name, n_stages, batch):
    np_ = _netplan(name, batch)
    params = params_from_numpy(_params(name), "cpu")
    x = torch.from_numpy(_input(batch))
    plan = partition_network(np_, n_stages)
    ex = PipelineExecutor(np_, plan, params, devices=["cpu"] * n_stages)
    assert [d.type for d in ex.devices] == ["cpu"] * n_stages
    assert batch % ex.n_micro == 0
    got = ex(x)
    _close(got.numpy(), _ref_forward(name, batch), 1e-4)
    single = NetworkExecutor(np_, params)(x)
    _close(got.numpy(), single.numpy(), 1e-5)
    # A fixed microbatch count that divides the batch runs too.
    fixed = PipelineExecutor(np_, plan, params, devices=["cpu"] * n_stages,
                             n_micro=2)
    _close(fixed(x).numpy(), single.numpy(), 1e-5)


def test_each_stage_holds_its_own_params():
    np_ = _netplan("yolov3-tiny", 4)
    plan = partition_network(np_, 2)
    ex = PipelineExecutor(np_, plan, params_from_numpy(_params("yolov3-tiny"),
                                                       "cpu"),
                          devices=["cpu", "cpu"])
    (a0, z0), (a1, z1) = plan.stage_bounds
    assert [len(p) for p in ex.stage_params] == [z0 - a0, z1 - a1]
    with pytest.raises(ValueError, match="does not divide"):
        PipelineExecutor(np_, plan, [{}] * len(np_.steps),
                         devices=["cpu", "cpu"], n_micro=3)


def test_pipelined_bf16_forward_matches_single_device():
    np_ = _netplan("yolov3-tiny", 4, "bfloat16")
    params = params_from_numpy(_params("yolov3-tiny"), "cpu")
    x = torch.from_numpy(_input(4))
    ex = PipelineExecutor(np_, partition_network(np_, 2), params,
                          devices=["cpu", "cpu"])
    got = ex(x)
    ref = NetworkExecutor(np_, params)(x.to(torch.bfloat16))
    assert got.dtype == ref.dtype == torch.bfloat16
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= 2e-2 * scale


def test_pipelined_int8_forward_matches_reference():
    batch = 4
    np_ = _netplan("yolov3-tiny", batch, "int8")
    params = params_from_numpy(_params("yolov3-tiny"), "cpu")
    x = torch.from_numpy(_input(batch))
    plan = partition_network(np_, 2)
    ex = PipelineExecutor(np_, plan, params, devices=["cpu", "cpu"],
                          calibration=x)
    got = ex(x)
    assert got.dtype == torch.float32
    assert sqnr_db(_ref_forward("yolov3-tiny", batch, "int8"),
                   got.numpy()) >= 40.0


@pytest.mark.parametrize("name", ["yolov3-tiny", "vgg16"])
def test_batch_sharding(name):
    """Over two devices a batch of 4 runs as two shards of 2 and equals
    the unsharded forward; a batch of 3 does not divide, and runs
    unsharded."""
    params = params_from_numpy(_params(name), "cpu")
    x = torch.from_numpy(_input(4))
    np_ = _netplan(name, 4)
    sharded = NetworkExecutor(np_, params, devices=["cpu", "cpu"])
    assert len(sharded.shards) == 2 and sharded.params is None
    _close(sharded(x).numpy(), NetworkExecutor(np_, params)(x).numpy(), 1e-5)
    _close(sharded(x).numpy(), _ref_forward(name, 4), 1e-4)
    odd = NetworkExecutor(_netplan(name, 3), params, devices=["cpu", "cpu"])
    assert odd.shards == []
    _close(odd(x[:3]).numpy(), NetworkExecutor(_netplan(name, 3), params)(
        x[:3]).numpy(), 0.0)


# ---------------------------------------------------------------------------
# The options, the facade and serving


def test_execution_options_multi_device():
    opts = repro_torch.ExecutionOptions
    with pytest.raises(ValueError, match="pipeline_stages"):
        opts(impl="torch", device="cpu", pipeline_stages=1)
    with pytest.raises(ValueError, match="pipeline_stages"):
        opts(impl="torch", device="cpu", pipeline_stages=-2)
    for bad in (0, -1, "bogus", 1.5):
        with pytest.raises(ValueError, match="microbatch"):
            opts(impl="torch", device="cpu", microbatch=bad)
    o = opts(impl="torch", device="cpu", pipeline_stages=4, microbatch=2,
             shard_batch=False)
    assert opts.from_json(o.to_json()) == o
    d = opts(impl="torch", device="cpu")
    assert (d.shard_batch, d.pipeline_stages, d.microbatch) == (True, 0, "auto")
    assert opts.from_json(d.to_json()) == d


def test_facade_pipeline_report_run_save_load(tmp_path):
    model = _model("vgg16")
    params = _params("vgg16")
    x = _input(4)
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu", batch=4,
                                        pipeline_stages=4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        repro_torch.compile(model, params, opts)
    compiled = repro_torch.compile(model, params, opts, devices=["cpu"] * 4)
    report = compiled.plan_report()
    pipe = report["pipeline"]
    assert pipe["n_stages"] == 4 and len(pipe["stage_bounds"]) == 4
    assert 0.0 < pipe["bubble_fraction"] < 1.0
    assert pipe["modeled_latency_s"] > 0 and pipe["pipeline_hits"] == 0
    assert pipe["n_micro"] == compiled.pipeline_executor(4).n_micro
    assert all(0 <= row["stage"] < 4 for row in report["layers"])
    assert [row["stage"] for row in report["layers"]] == sorted(
        row["stage"] for row in report["layers"])
    got = compiled.run(x)
    single = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", batch=4))
    assert "pipeline" not in single.plan_report()
    _close(got.numpy(), single.run(x).numpy(), 1e-5)

    path = compiled.save(str(tmp_path / "vgg.compiled.json"))
    loaded = repro_torch.load(path, model, params, devices=["cpu"] * 4)
    report = loaded.plan_report()
    assert report["tunes"] == 0 and report["network_hits"] == 1
    assert report["pipeline"]["pipeline_hits"] == 1
    assert report["pipeline"]["stage_bounds"] == pipe["stage_bounds"]
    _close(loaded.run(x).numpy(), got.numpy(), 0.0)


def test_facade_shard_batch_option():
    model = _model("yolov3-tiny")
    params = _params("yolov3-tiny")
    base = repro_torch.ExecutionOptions(impl="torch", device="cpu", batch=4)
    sharded = repro_torch.compile(model, params, base, devices=["cpu"] * 2)
    assert len(sharded.executor(4).shards) == 2
    whole = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", batch=4, shard_batch=False),
        devices=["cpu"] * 2)
    assert whole.executor(4).shards == []
    default = repro_torch.compile(model, params, base)
    assert default.executor(4).shards == [] and default.devices() == [
        torch.device("cpu")]
    x = _input(4)
    _close(sharded.run(x).numpy(), default.run(x).numpy(), 1e-5)
    _close(whole.run(x).numpy(), default.run(x).numpy(), 0.0)


def test_pipelined_serving_rows_equal_their_buckets_forward():
    model = _model("yolov3-tiny")
    params = _params("yolov3-tiny")
    compiled = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", pipeline_stages=2, buckets=(1, 4)),
        devices=["cpu"] * 2)
    engine = compiled.serve()
    assert engine._executors[1].n_micro == 1
    assert all(isinstance(ex, PipelineExecutor)
               for ex in engine._executors.values())
    images = np.random.default_rng(5).standard_normal(
        (5, HW, HW, 3)).astype(np.float32)
    uids = [engine.submit(img) for img in images]
    results = engine.run()
    assert engine.stats["batches"] == {1: 1, 4: 1}
    assert engine.health()["request_failures"] == 0
    rows = torch.stack([results[u] for u in uids])
    want = torch.cat([compiled.pipeline_executor(4)(torch.from_numpy(
        images[:4])), compiled.pipeline_executor(1)(torch.from_numpy(
            images[4:]))])
    assert torch.equal(rows, want)

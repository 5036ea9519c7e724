"""The port's persistent plan cache, network entries, and ``save``/``load``
(the reference's tests/test_planner.py cache tests, and those of
tests/test_api.py and tests/test_netplan.py).  Every file lies under
``tmp_path``: no test reads a cache another run wrote.
"""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro.core.planner import salvage_cache_text as j_salvage_cache_text
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.core.netplan import network_key, plan_network
from repro_torch.core.planner import (
    DEFAULT_CACHE_PATH,
    PLAN_CACHE_VERSION,
    ConvPlan,
    Planner,
    plan_key,
    salvage_cache_text,
)
from repro_torch.hw import H100
from repro_torch.models.cnn import init_cnn, random_batchnorm

LAYER_CASES = [
    (ConvSpec(8, 16), 20, 20),                                  # 3x3 s1
    (ConvSpec(16, 32, (1, 1), padding=(0, 0)), 12, 12),         # 1x1
    (ConvSpec(16, 32, stride=(2, 2)), 24, 24),                  # 3x3 s2
    (ConvSpec(64, 128), 52, 52),
]
MODES = ("cost", "model", "measure")


def _planner(tmp_path, mode="model", name="plans.json", **kw):
    return Planner(impl="torch", device="cpu", mode=mode,
                   cache_path=os.path.join(tmp_path, name), **kw)


# ---------------------------------------------------------------------------
# Per-layer plans


@pytest.mark.parametrize("mode", MODES)
def test_plan_cache_round_trip(tmp_path, mode):
    """write -> reload in a fresh Planner -> every lookup is a hit, with
    the same plans."""
    p1 = _planner(tmp_path, mode)
    plans = [p1.plan(s, h, w, batch=2) for s, h, w in LAYER_CASES]
    assert p1.stats == {"hits": 0, "tunes": len(LAYER_CASES)}
    p1.save()
    p2 = _planner(tmp_path, mode)
    assert [p2.plan(s, h, w, batch=2) for s, h, w in LAYER_CASES] == plans
    assert p2.stats == {"hits": len(LAYER_CASES), "tunes": 0}
    data = json.load(open(p1.cache_path))
    assert data["version"] == PLAN_CACHE_VERSION and data["chip"] == "h100_sxm"
    assert len(data["plans"]) == len(LAYER_CASES)
    for d in data["plans"].values():
        assert ConvPlan.from_json(d).to_json() == d
    if mode != "cost":
        assert all(p.predicted_s > 0 for p in plans)


def test_cache_key_distinguishes_what_decides_a_plan():
    spec = ConvSpec(8, 16)
    base = plan_key(spec, 20, 20, 1, "cuda", "model", None)
    for other in (plan_key(spec, 21, 20, 1, "cuda", "model", None),
                  plan_key(spec, 20, 20, 2, "cuda", "model", None),
                  plan_key(spec, 20, 20, 1, "cuda", "model", None, "int8"),
                  plan_key(spec, 20, 20, 1, "cuda", "cost", None),
                  plan_key(spec, 20, 20, 1, "cuda", "measure", None),
                  plan_key(spec, 20, 20, 1, "cuda", "model", False),
                  plan_key(spec, 20, 20, 1, "torch", "model", None),
                  plan_key(ConvSpec(8, 17), 20, 20, 1, "cuda", "model", None),
                  plan_key(spec, 20, 20, 1, "cuda", "model", None,
                           chip="other_card")):
        assert other != base
    # A modeled plan names the constants that priced it: a refit replans.
    refit = dataclasses.replace(H100, launch_s=2 * H100.launch_s)
    assert refit.fit_digest != H100.fit_digest
    model = Planner(impl="torch", device="cpu", mode="model")
    assert model.key(spec, 20, 20, 1, "float32").endswith(
        f"|fit={H100.fit_digest}")
    assert Planner(impl="torch", device="cpu", mode="model",
                   hw=refit).key(spec, 20, 20, 1, "float32") != model.key(
        spec, 20, 20, 1, "float32")
    assert "fit=" not in Planner(impl="torch", device="cpu",
                                 mode="cost").key(spec, 20, 20, 1, "float32")
    # A measured plan names the device it was timed on.
    measured = Planner(impl="torch", device="cpu", mode="measure")
    assert measured.key(spec, 20, 20, 1, "float32").endswith("|dev=cpu")
    assert "dev=" not in Planner(impl="torch", device="cpu",
                                 mode="model").key(spec, 20, 20, 1, "float32")


def test_cache_is_opt_in():
    assert Planner().cache_path is None
    assert repro_torch.ExecutionOptions(impl="torch",
                                        device="cpu").cache_path is None
    assert DEFAULT_CACHE_PATH.endswith("conv_plans_torch.json")


def test_version_mismatch_is_a_cold_start(tmp_path):
    p1 = _planner(tmp_path)
    spec, h, w = LAYER_CASES[0]
    p1.plan(spec, h, w)
    p1.save()
    data = json.load(open(p1.cache_path))
    data["version"] = PLAN_CACHE_VERSION + 1
    json.dump(data, open(p1.cache_path, "w"))
    p2 = _planner(tmp_path)
    assert len(p2) == 0
    p2.plan(spec, h, w)
    assert p2.stats["tunes"] == 1
    p2.save()
    assert json.load(open(p1.cache_path))["version"] == PLAN_CACHE_VERSION


def test_corrupt_cache_is_quarantined_and_salvaged(tmp_path):
    p1 = _planner(tmp_path)
    for s, h, w in LAYER_CASES:
        p1.plan(s, h, w)
    p1.save()
    text = open(p1.cache_path).read()
    cut = text.index("ci64co128")              # inside the last plan's key
    with open(p1.cache_path, "w") as f:
        f.write(text[:cut])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p2 = _planner(tmp_path)
    assert any("quarantined" in str(w.message) for w in caught)
    corrupt = [f for f in os.listdir(tmp_path) if ".corrupt-" in f]
    assert len(corrupt) == 1
    assert open(os.path.join(tmp_path, corrupt[0])).read() == text[:cut]
    assert len(p2) == len(LAYER_CASES) - 1          # all but the cut one
    for s, h, w in LAYER_CASES:
        p2.plan(s, h, w)
    assert p2.stats == {"hits": len(LAYER_CASES) - 1, "tunes": 1}
    p2.save()
    json.load(open(p1.cache_path))                  # rewritten whole


@pytest.mark.parametrize("cut", [0.25, 0.5, 0.8, 0.97])
def test_salvage_matches_the_reference(tmp_path, cut):
    """The port's salvage returns the reference's sections for the same
    truncated text."""
    p = _planner(tmp_path)
    netplan = plan_network(yolov3.TINY_MODEL.layers, 64, 64, p)
    assert netplan.steps
    p.save()
    text = open(p.cache_path).read()
    truncated = text[:int(len(text) * cut)]
    ours, ref = salvage_cache_text(truncated), j_salvage_cache_text(truncated)
    assert ours == ref
    assert salvage_cache_text(text) == j_salvage_cache_text(text)


def test_concurrent_planners_converge_to_the_union(tmp_path):
    a, b = _planner(tmp_path), _planner(tmp_path)
    (s0, h0, w0), (s1, h1, w1) = LAYER_CASES[:2]
    a.plan(s0, h0, w0)
    b.plan(s1, h1, w1)
    a.save()
    b.save()                           # b read the file before a wrote it
    c = _planner(tmp_path)
    c.plan(s0, h0, w0)
    c.plan(s1, h1, w1)
    assert c.stats == {"hits": 2, "tunes": 0}


def test_plans_reach_the_file_at_save(tmp_path):
    """A miss writes nothing; ``save`` writes what came since the last
    save, and a save with nothing new leaves the file as it is."""
    p = _planner(tmp_path)
    spec, h, w = LAYER_CASES[0]
    p.plan(spec, h, w)
    assert not os.path.exists(p.cache_path)
    p.save()
    assert _planner(tmp_path).plan(spec, h, w) == p.plan(spec, h, w)
    os.remove(p.cache_path)
    p.plan(spec, h, w)                 # a hit: nothing new
    p.save()
    assert not os.path.exists(p.cache_path)


def test_pipelines_section_is_kept(tmp_path):
    """Pipeline entries are not planned yet: read and written back."""
    p = _planner(tmp_path)
    p.plan(*LAYER_CASES[0])
    p.save()
    data = json.load(open(p.cache_path))
    data["pipelines"] = {"pipe|x": {"stage_bounds": [[0, 3]]}}
    json.dump(data, open(p.cache_path, "w"))
    q = _planner(tmp_path)
    q.plan(*LAYER_CASES[1])
    q.save()
    assert json.load(open(p.cache_path))["pipelines"] == data["pipelines"]


# ---------------------------------------------------------------------------
# Whole-network entries


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_warm_plan_network_tunes_nothing(tmp_path, mode, dtype):
    layers, hw = yolov3.TINY_MODEL.layers, (64, 64)
    p1 = _planner(tmp_path, mode)
    cold = plan_network(layers, *hw, p1, batch=2, dtype=dtype)
    assert p1.stats["tunes"] > 0 and p1.network_hits == 0
    p1.save()
    p2 = _planner(tmp_path, mode)
    warm = plan_network(layers, *hw, p2, batch=2, dtype=dtype)
    assert warm == cold
    assert p2.stats == {"hits": 0, "tunes": 0} and p2.network_hits == 1
    # Another batch is another entry: planned, not reused.
    plan_network(layers, *hw, p2, batch=1, dtype=dtype)
    assert p2.network_hits == 1


def test_corrupt_network_entry_replans(tmp_path):
    layers = yolov3.TINY_MODEL.layers
    p1 = _planner(tmp_path)
    cold = plan_network(layers, 64, 64, p1)
    p1.save()
    key = network_key(layers, 64, 64, 3, 1, p1)
    data = json.load(open(p1.cache_path))
    data["networks"][key]["steps"][0]["plan"] = None     # a conv without a plan
    json.dump(data, open(p1.cache_path, "w"))
    p2 = _planner(tmp_path)
    assert plan_network(layers, 64, 64, p2) == cold
    assert p2.network_hits == 0 and p2.stats["hits"] > 0


def test_network_key_separates_planners():
    layers = yolov3.TINY_MODEL.layers
    keys = {network_key(layers, 64, 64, 3, 1,
                        Planner(impl="torch", device="cpu", mode=m,
                                winograd_fused=wf))
            for m in MODES for wf in (None, True, False)}
    assert len(keys) == 9
    assert network_key(layers, 64, 64, 3, 1, Planner()) != network_key(
        layers[:-1], 64, 64, 3, 1, Planner())


# ---------------------------------------------------------------------------
# compile(cache_path=...), save and load


def _tiny(hw=(64, 64)):
    model = repro_torch.CNNModel(yolov3.TINY_LAYERS, hw, name="tiny")
    rng = np.random.default_rng(0)
    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    return model, params, x


@pytest.mark.parametrize("mode,dtype", [("model", "float32"),
                                        ("measure", "float32"),
                                        ("model", "int8")])
def test_warm_compile_and_save_load(tmp_path, mode, dtype):
    model, params, x = _tiny()
    opts = repro_torch.ExecutionOptions(
        impl="torch", device="cpu", mode=mode, dtype=dtype, batch=2,
        cache_path=os.path.join(tmp_path, "plans.json"))
    cold = repro_torch.compile(model, params, opts, calibration=x)
    assert cold.plan_report()["tunes"] > 0
    warm = repro_torch.compile(model, params, opts, calibration=x)
    report = warm.plan_report()
    assert report["tunes"] == 0 and report["network_hits"] == 1
    y = warm.run(x)
    assert torch.equal(y, cold.run(x))

    path = warm.save()
    assert path == os.path.join(tmp_path, "tiny.compiled.json")
    loaded = repro_torch.load(path, model, params, calibration=x)
    assert loaded.options == opts
    assert loaded.plan_report()["tunes"] == 0
    assert loaded.planner.network_hits == 1
    assert torch.equal(loaded.run(x), y)


@pytest.mark.parametrize("mode", ["model", "measure"])
def test_save_load_without_a_cache(tmp_path, monkeypatch, mode):
    """Under the default ``cache_path`` None the artifact carries the
    plans of every planned batch size: ``load`` re-tunes nothing, and
    ``save()`` without a path raises rather than write into the working
    directory."""
    monkeypatch.chdir(tmp_path)
    model, params, x = _tiny()
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                        mode=mode, batch=2)
    compiled = repro_torch.compile(model, params, opts)
    y1 = compiled.run(x[:1])
    with pytest.raises(ValueError, match="path"):
        compiled.save()
    assert os.listdir(tmp_path) == []
    path = compiled.save(os.path.join(tmp_path, "tiny.json"))
    assert os.listdir(tmp_path) == ["tiny.json"]
    loaded = repro_torch.load(path, model, params)
    assert loaded.network_plan() == compiled.network_plan()
    assert torch.equal(loaded.run(x), compiled.run(x))
    assert torch.equal(loaded.run(x[:1]), y1)
    assert loaded.planner.stats["tunes"] == 0
    assert loaded.planner.network_hits == 2
    assert os.listdir(tmp_path) == ["tiny.json"]


def test_load_refuses_another_model(tmp_path):
    model, params, x = _tiny()
    opts = repro_torch.ExecutionOptions(
        impl="torch", device="cpu", mode="model",
        cache_path=os.path.join(tmp_path, "plans.json"))
    path = repro_torch.compile(model, params, opts).save(
        os.path.join(tmp_path, "a.json"))
    other = repro_torch.CNNModel(vgg16.MODEL.layers, (64, 64), name="tiny")
    with pytest.raises(ValueError, match="digest"):
        repro_torch.load(path, other, params)
    with pytest.raises(ValueError, match="input"):
        repro_torch.load(path, model.__class__(model.layers, (96, 96)), params)
    with open(path, "w") as f:
        json.dump({"format": "something else"}, f)
    with pytest.raises(ValueError, match="artifact"):
        repro_torch.load(path, model, params)


def test_shared_planner_pools_plans(tmp_path):
    """A caller's planner is shared, not saved by compile."""
    model, params, x = _tiny()
    shared = _planner(tmp_path)
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                        mode="model", batch=2)
    a = repro_torch.compile(model, params, opts, planner=shared)
    tunes = shared.stats["tunes"]
    b = repro_torch.compile(model, params, opts, planner=shared)
    assert shared.stats["tunes"] == tunes and shared.network_hits == 1
    assert a.planner is b.planner is shared
    assert not os.path.exists(shared.cache_path)
    assert torch.equal(a.run(x), b.run(x))


def test_options_round_trip():
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                        mode="model", winograd_fused=False,
                                        batch=3, dtype="int8",
                                        cache_path="x/plans.json")
    assert repro_torch.ExecutionOptions.from_json(
        json.loads(json.dumps(opts.to_json()))) == opts


def test_lm_save_load(tmp_path):
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params

    cfg = smoke_config("llama3.2-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu")
    lm = repro_torch.compile(cfg, params, opts)
    path = lm.save(os.path.join(tmp_path, "lm.json"))
    loaded = repro_torch.load(path, cfg, params)
    tokens = torch.arange(6).reshape(1, 6)
    assert torch.equal(loaded.run(tokens), lm.run(tokens))
    with pytest.raises(ValueError, match="LM config"):
        repro_torch.load(path, smoke_config("qwen1.5-0.5b"), params)


def test_plan_report_carries_the_model(tmp_path):
    model, params, x = _tiny()
    report = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", mode="model")).plan_report()
    assert report["predicted_total_s"] == pytest.approx(
        sum(r["predicted_s"] for r in report["layers"]))
    assert {"tunes", "hits", "network_hits"} <= set(report)
    cost = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu")).plan_report()
    assert cost["predicted_total_s"] is None
    assert all(r["predicted_s"] is None for r in cost["layers"])
    assert ConvAlgorithm.DIRECT.value in {r["algorithm"] for r in cost["layers"]}

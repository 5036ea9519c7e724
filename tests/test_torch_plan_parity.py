"""Cost mode's plans against the reference planner's, and the forwards
that the plans decide.

The port's cost mode decides by the reference's own rule
(``repro_torch/core/cost_rule.py``): each conv's (algorithm, Winograd
realization, dtype) must equal ``repro.core.planner.Planner``'s cost-mode
plan over a grid of networks at full width, input sizes, batches and
Winograd policies, in every dtype.  The rule depends only on the
reference's FLOP-per-byte crossovers, pinned here against its chip
constants.  Where a plan puts a 3x3 conv on the 3-pass pipeline, which in
16 bits rounds V and M to 16 bits, the forward must then match the
reference's (fp32 at 1e-4, bf16 at 2e-2 of max(1, max|ref|)).  A cache
file of the earlier rule replans.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
from repro.configs import vgg16 as jvgg16
from repro.configs import yolov3 as jyolov3
from repro.core.netplan import plan_network as j_plan_network
from repro.core.planner import Planner as JPlanner
from repro.hw import V5E
from repro.models.cnn import CNNLayer as JCNNLayer
from repro_torch.configs import vgg16, yolov3
from repro_torch.core import cost_rule
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import (
    PLAN_CACHE_VERSION,
    ConvPlan,
    Planner,
    plan_is_current,
    plan_key,
)
from repro_torch.models.cnn import CNNLayer, init_cnn, random_batchnorm

SIZES = (32, 64, 96, 160, 224, 320, 416, 608)
BATCHES = (1, 2, 4, 8)
POLICIES = (None, True, False)
NETWORKS = {
    "yolov3-tiny": (yolov3.TINY_LAYERS, jyolov3.TINY_LAYERS),
    "yolov3-20": (yolov3.LAYERS_20, jyolov3.LAYERS_20),
    "vgg16": (vgg16.MODEL.layers, jvgg16.MODEL.layers),
}
DTYPES = ("float32", "bfloat16", "float16", "int8")


def _decisions(netplan):
    return [(s.index, s.plan.algorithm.value, s.plan.winograd_fused,
             s.plan.dtype) for s in netplan.steps if s.plan is not None]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("network", list(NETWORKS))
def test_cost_mode_plans_match_the_reference(network, dtype):
    ours, ref = NETWORKS[network]
    for policy in POLICIES:
        planner = Planner(impl="torch", device="cpu", winograd_fused=policy)
        j_planner = JPlanner(impl="pallas", cache_path=None,
                             winograd_fused=policy)
        for size in SIZES:
            for batch in BATCHES:
                got = plan_network(ours, size, size, planner, batch=batch,
                                   dtype=dtype)
                want = j_plan_network(ref, size, size, j_planner, batch=batch,
                                      dtype=dtype)
                assert _decisions(got) == _decisions(want), (
                    network, dtype, policy, size, batch)
                assert all(s.plan.source == "cost_rule"
                           and s.plan.predicted_s is None
                           for s in got.steps if s.plan is not None)


@pytest.mark.parametrize("dtype_bytes,peak", [
    (4, V5E.peak_flops_fp32), (2, V5E.peak_flops_bf16),
    (1, V5E.peak_flops_int8)])
def test_crossovers_are_the_reference_planners(dtype_bytes, peak):
    assert cost_rule.CROSSOVER[dtype_bytes] == pytest.approx(
        peak / V5E.hbm_bandwidth, rel=1e-12)


def _compile_both(layers, jlayers, hw, batch, seed, **options):
    """The port's and the reference's forwards of one model on the same
    seeded weights (random batchnorm) and input."""
    name = "parity"
    ours = repro_torch.CNNModel(layers, hw, name=name)
    ref = repro.CNNModel(jlayers, hw, name=name)
    rng = np.random.default_rng(seed)
    params = random_batchnorm(init_cnn(rng, layers), rng)
    x = rng.standard_normal((batch, *hw, 3)).astype(np.float32)
    compiled = repro_torch.compile(ours, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", batch=batch, **options))
    j_compiled = repro.compile(ref, params, repro.ExecutionOptions(
        impl="pallas", batch=batch, cache_path=None, **options))
    return compiled, j_compiled, x


@pytest.mark.parametrize("network,batch,seed", [
    ("yolov3-tiny", 1, 0), ("yolov3-20", 1, 7), ("yolov3-20", 2, 7)])
def test_16bit_forced_3pass_forward_matches_the_reference(network, batch,
                                                          seed):
    """bf16 with ``winograd_fused=False`` at 64x64: the plans, and so the
    16-bit roundings of V and M, are the reference's, and the forward is
    within the reference suite's bf16 tolerance."""
    ours, ref = NETWORKS[network]
    compiled, j_compiled, x = _compile_both(
        ours, ref, (64, 64), batch, seed, dtype="bfloat16",
        winograd_fused=False)
    assert _decisions(compiled.network_plan()) == _decisions(
        j_compiled.network_plan(batch))
    got = compiled.run(x).float().numpy()
    want = np.asarray(j_compiled.run(jnp.asarray(x)).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 2e-2 * max(1.0, float(np.abs(want).max())), err


def test_fp32_3pass_forward_matches_the_reference():
    """VGG-16's conv1_2 (64 -> 64) at 96x96, batch 4, policy False: both
    planners send it to the 3-pass pipeline."""
    # conv1_1 maps 3 channels to 64; conv1_2 is the second conv.
    conv = dict(kind="conv", out_channels=64, activation="relu")
    layers = (CNNLayer(**conv), CNNLayer(**conv))
    jlayers = (JCNNLayer(**conv), JCNNLayer(**conv))
    compiled, j_compiled, x = _compile_both(layers, jlayers, (96, 96), 4, 11,
                                            winograd_fused=False)
    got_plan = _decisions(compiled.network_plan())
    assert got_plan == _decisions(j_compiled.network_plan(4))
    assert got_plan[1] == (1, "winograd", False, "float32")
    got = compiled.run(x).numpy()
    want = np.asarray(j_compiled.run(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_a_cache_file_of_the_tile_rule_replans(tmp_path):
    """A version-1 cache file, written under the tile count, holds a plan
    the rule would not make (a 256 -> 512 conv at 26x26, batch 4, policy
    False: the 3-pass pipeline by its 100 tiles, im2col by the rule): a
    planner reads none of it and replans."""
    spec, h, w, batch = ConvSpec(256, 512), 26, 26, 4
    planner = Planner(impl="torch", device="cpu", winograd_fused=False,
                      cache_path=str(tmp_path / "plans.json"))
    key = planner.key(spec, h, w, batch, "float32")
    stale = {"algorithm": "winograd", "impl": "torch",
             "kernel_blocks": [16, 8, 32], "source": "tile_rule",
             "winograd_fused": False, "measured_ms": [], "dtype": "float32",
             "predicted_s": None}
    with open(planner.cache_path, "w") as f:
        json.dump({"version": 1, "chip": planner.hw.name,
                   "plans": {key: stale}, "networks": {}, "pipelines": {}}, f)
    assert PLAN_CACHE_VERSION == 2
    again = Planner(impl="torch", device="cpu", winograd_fused=False,
                    cache_path=planner.cache_path)
    assert len(again) == 0
    plan = again.plan(spec, h, w, batch)
    assert again.stats == {"hits": 0, "tunes": 1}
    assert (plan.algorithm, plan.source) == (ConvAlgorithm.IM2COL_GEMM,
                                             "cost_rule")
    assert key == plan_key(spec, h, w, batch, "torch", "cost", False)
    again.save()
    with open(planner.cache_path) as f:
        data = json.load(f)
    assert data["version"] == PLAN_CACHE_VERSION
    assert data["plans"][key]["source"] == "cost_rule"
    # A plan of the tile rule in a save artifact (or any entry) replans
    # too, whatever its version.
    assert not plan_is_current(ConvPlan.from_json(stale), spec, h, w, batch)

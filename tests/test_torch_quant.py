"""The port's core/quant.py against the JAX package's repro.core.quant.

The same numpy inputs go through both.  Tolerances: scales (a max-abs
divided by 127) at rtol 1e-6; the int8 values of ``quantize_activation``
and ``quantize_conv_weights`` equal (both divide and round half to even in
fp32); the planner's gates equal on every conv of the four full-size cells
(pure arithmetic); calibration, whose fp32 walk sums in another order than
the reference's XLA convolution, at rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.core.netplan import plan_network as j_plan_network
from repro.core.planner import Planner as JPlanner
from repro.models.cnn import CNNLayer as JCNNLayer
from repro.models.cnn import fold_batchnorm as j_fold_batchnorm
from repro_torch.configs import vgg16, yolov3
from repro_torch.core import quant
from repro_torch.core.netplan import _propagate_shapes, plan_network
from repro_torch.core.planner import Planner
from repro_torch.models.cnn import (
    CNNLayer,
    fold_batchnorm,
    init_cnn,
    params_from_numpy,
    random_batchnorm,
)

CELLS = [(yolov3.TINY_MODEL, 1), (yolov3.TINY_MODEL, 4), (vgg16.MODEL, 1),
         (yolov3.MODEL_20, 1)]


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_activation_scales_match_reference():
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 7, 5, 12) * rng.uniform(0.1, 10, 12).astype(np.float32)
    x[..., 3] = 0.0                                   # a dead channel: floor
    got = quant.activation_scales(torch.from_numpy(x)).numpy()
    ref = np.asarray(jquant.activation_scales(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got[3] == quant.SCALE_FLOOR == jquant.SCALE_FLOOR
    assert (quant.QMAX, quant.INT8_TRAFFIC_THRESHOLD) == (
        jquant.QMAX, jquant.INT8_TRAFFIC_THRESHOLD)


def test_quantize_activation_matches_reference():
    """Equal int8 values, halves (x / scale = k + 0.5) and clipping
    included."""
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 6, 6, 16) * 3
    scale = np.abs(_np(rng, 16)) * 0.02 + 1e-3
    # Exact halves, which round to even, and values past the clip.
    x[0, 0, 0, :8] = (np.arange(8) + 0.5).astype(np.float32) * scale[:8]
    x[0, 0, 1, :] = 200 * scale
    got = quant.quantize_activation(torch.from_numpy(x),
                                    torch.from_numpy(scale)).numpy()
    ref = np.asarray(jquant.quantize_activation(jnp.asarray(x),
                                                jnp.asarray(scale)))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)


def test_quantize_conv_weights_matches_reference():
    rng = np.random.default_rng(2)
    w = _np(rng, 3, 3, 10, 7)
    w[..., 4] = 0.0                                   # a dead out channel
    x_scale = np.abs(_np(rng, 10)) * 0.05 + 1e-3
    wq, w_scale = quant.quantize_conv_weights(torch.from_numpy(w),
                                              torch.from_numpy(x_scale))
    jwq, jw_scale = jquant.quantize_conv_weights(jnp.asarray(w),
                                                 jnp.asarray(x_scale))
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_allclose(w_scale.numpy(), np.asarray(jw_scale),
                               rtol=1e-6)


def test_sqnr_db_matches_reference():
    rng = np.random.default_rng(3)
    ref, test = _np(rng, 100), _np(rng, 100)
    test = ref + 0.01 * test
    assert quant.sqnr_db(torch.from_numpy(ref), test) == pytest.approx(
        jquant.sqnr_db(ref, test), rel=1e-12)
    assert quant.sqnr_db(ref, ref) == float("inf")


@pytest.mark.parametrize("model,batch", CELLS,
                         ids=[f"{m.name}-b{b}" for m, b in CELLS])
def test_traffic_gate_matches_reference_on_full_cells(model, batch):
    infos = _propagate_shapes(model.layers, *model.input_hw,
                              model.in_channels)
    decided = []
    for info in infos:
        spec = info["spec"]
        if spec is None:
            continue
        h, w, _ = info["in"]
        jspec = JConvSpec(spec.in_channels, spec.out_channels,
                          spec.kernel_size, spec.stride, spec.padding)
        ratio = quant.int8_traffic_ratio(spec, h, w, batch)
        assert ratio == jquant.int8_traffic_ratio(jspec, h, w, batch)
        ok = quant.int8_worthwhile(spec, h, w, batch)
        assert ok == jquant.int8_worthwhile(jspec, h, w, batch)
        decided.append(ok)
    assert not decided[0] and sum(decided) >= len(decided) - 2


def test_winograd_int8_budget_fails_like_reference():
    assert quant.winograd_int8_budget_ok() is False
    assert jquant.winograd_int8_budget_ok() is False
    assert quant.winograd_transform_amplification() == pytest.approx(
        jquant.winograd_transform_amplification(), rel=1e-12)
    assert quant.winograd_int8_sqnr_estimate_db() == pytest.approx(
        jquant.winograd_int8_sqnr_estimate_db(), rel=1e-12)


def test_default_calibration_batch_is_seeded_numpy():
    a = quant.default_calibration_batch(8, 6, 3, seed=5)
    assert a.shape == (2, 8, 6, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(
        a, np.random.default_rng(5).standard_normal((2, 8, 6, 3)).astype(
            np.float32))


def test_calibration_matches_reference_on_narrow_tiny():
    """Per-conv input scales of a narrow YOLOv3-tiny at 32x32 (every layer
    kind of the table: both pools, route, upsample, both heads)."""
    def conv(ch, k=3, bn=True, act="leaky"):
        return dict(kind="conv", out_channels=ch, kernel=k, stride=1,
                    batch_norm=bn, activation=act)

    pool2 = dict(kind="maxpool", size=2, stride=2)
    head = conv(21, 1, bn=False, act="linear")
    rows = [
        conv(5), pool2, conv(12), pool2, conv(13), pool2, conv(16), pool2,
        conv(20), pool2, conv(24), dict(kind="maxpool", size=2, stride=1),
        conv(40), conv(10, 1), conv(24), head,
        dict(kind="route", from_layers=(13,)), conv(9, 1),
        dict(kind="upsample", size=2), dict(kind="route", from_layers=(18, 8)),
        conv(18), head,
    ]
    layers = [CNNLayer(**r) for r in rows]
    jlayers = [JCNNLayer(**r) for r in rows]
    rng = np.random.default_rng(4)
    params = random_batchnorm(init_cnn(rng, layers), rng)
    x = _np(rng, 2, 32, 32, 3)

    netplan = plan_network(layers, 32, 32,
                           Planner(impl="torch", device="cpu"), dtype="int8")
    got = quant.calibrate_activation_scales(
        netplan, fold_batchnorm(params_from_numpy(params, "cpu"), layers), x)
    jnetplan = j_plan_network(jlayers, 32, 32,
                              JPlanner(impl="jax", cache_path=None),
                              dtype="int8")
    jparams = [{k: (jnp.asarray(v) if not isinstance(v, dict) else
                    {kk: jnp.asarray(vv) for kk, vv in v.items()})
                for k, v in p.items()} for p in params]
    ref = jquant.calibrate_activation_scales(
        jnetplan, j_fold_batchnorm(jparams, jlayers), jnp.asarray(x))
    assert sorted(got) == sorted(ref) == [
        i for i, r in enumerate(rows) if r["kind"] == "conv"]
    for i in got:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, err_msg=f"step {i}")

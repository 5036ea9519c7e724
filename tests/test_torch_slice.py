"""The port's plain conv algorithms and its whole planned forward against
the JAX package.

Core modules: the same numpy inputs go through ``repro.core.conv2d`` (the
pure-jnp path) and ``repro_torch.core.conv2d`` with ``impl='torch'`` on the
CPU, for every algorithm, at rtol = atol = 5e-4
(tests/test_conv_conformance.py).

The slice: ``repro_torch.compile(...).run`` on the CPU (``impl='torch'``,
``device='cpu'``) against ``repro.compile(..., impl='jax').run`` on narrow
nets with the layer kinds of the two YOLOv3 tables and of VGG-16, with
random batchnorm statistics, at rtol = 1e-4, atol = 1e-4 * max|ref|
(tests/test_api.py).  The widths are odd on purpose, so that channel
padding and the elided boundaries of the port's plan are exercised; the
input sizes and batches are picked so that every algorithm a net's layer
kinds allow runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.conv2d import conv2d as j_conv2d
from repro.core.conv_spec import ConvAlgorithm as JConvAlgorithm
from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.core.conv_spec import Epilogue as JEpilogue
from repro.core.winograd import transform_weights as j_transform_weights
from repro.models.cnn import CNNLayer as JCNNLayer
from repro_torch.core.conv2d import conv2d, conv2d_reference
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec, Epilogue
from repro_torch.core.winograd import transform_weights
from repro_torch.models.cnn import CNNLayer, init_cnn, random_batchnorm

TOL = dict(rtol=5e-4, atol=5e-4)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Core conv algorithms (plain torch) against repro.core (pure jnp)


@pytest.mark.parametrize("algo,k,s,p", [
    ("DIRECT", 1, 1, 0),
    ("DIRECT", 1, 2, 1),
    ("IM2COL_GEMM", 3, 1, 1),
    ("IM2COL_GEMM", 3, 2, 1),
    ("IM2COL_GEMM", 1, 2, 0),
    ("WINOGRAD", 3, 1, 1),
    ("WINOGRAD", 3, 1, 0),
])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "epilogue"])
def test_core_conv_matches_reference(algo, k, s, p, fused):
    rng = np.random.default_rng(k * 100 + s * 10 + p)
    x, w, bias = _np(rng, 2, 10, 13, 5), _np(rng, k, k, 5, 7), _np(rng, 7)
    jspec = JConvSpec(5, 7, (k, k), (s, s), (p, p),
                      algorithm=getattr(JConvAlgorithm, algo))
    spec = ConvSpec(5, 7, (k, k), (s, s), (p, p),
                    algorithm=getattr(ConvAlgorithm, algo))
    ref = j_conv2d(jnp.asarray(x), jnp.asarray(w), jspec, impl="jax",
                   epilogue=(JEpilogue(jnp.asarray(bias), "leaky")
                             if fused else None))
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w), spec, impl="torch",
                 epilogue=(Epilogue(torch.from_numpy(bias), "leaky")
                           if fused else None))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    oracle = conv2d_reference(torch.from_numpy(x), torch.from_numpy(w), spec)
    if not fused:
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


def test_winograd_pretransformed_matches_reference():
    rng = np.random.default_rng(11)
    x, w = _np(rng, 1, 14, 9, 6), _np(rng, 3, 3, 6, 4)
    u_ref = np.asarray(j_transform_weights(jnp.asarray(w)))
    u = transform_weights(torch.from_numpy(w))
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-5, atol=1e-6)
    spec = ConvSpec(6, 4, algorithm=ConvAlgorithm.WINOGRAD)
    got = conv2d(torch.from_numpy(x), u, spec, impl="torch",
                 pretransformed=True)
    ref = j_conv2d(jnp.asarray(x), jnp.asarray(u_ref),
                   JConvSpec(6, 4, algorithm=JConvAlgorithm.WINOGRAD),
                   impl="jax", pretransformed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# The whole slice: compile -> plan -> prepare -> run


def _conv(ch, k=3, s=1, bn=True, act="leaky"):
    return dict(kind="conv", out_channels=ch, kernel=k, stride=s,
                batch_norm=bn, activation=act)


def _narrow_tiny():
    """YOLOv3-tiny's layer kinds at narrow, odd widths: the stride-2 pools,
    the size-2 stride-1 pool, both heads, route, upsample."""
    pool2, pool1 = dict(kind="maxpool", size=2, stride=2), dict(
        kind="maxpool", size=2, stride=1)
    head = _conv(21, 1, bn=False, act="linear")
    return [
        _conv(5), pool2, _conv(12), pool2, _conv(13), pool2, _conv(16), pool2,
        _conv(20), pool2,                                 # 8 = route source
        _conv(24), pool1, _conv(40), _conv(10, 1),        # 13 = route source
        _conv(24), head,
        dict(kind="route", from_layers=(13,)), _conv(9, 1),
        dict(kind="upsample", size=2), dict(kind="route", from_layers=(18, 8)),
        _conv(18), head,
    ]


def _narrow_layers_20():
    """The first 20 Darknet-53 layers at narrow widths: stride-2 convs and
    shortcuts."""
    def sc(j):
        return dict(kind="shortcut", from_layers=(j,))

    return [
        _conv(6), _conv(12, 3, 2), _conv(6, 1), _conv(12), sc(1),
        _conv(20, 3, 2), _conv(10, 1), _conv(20), sc(5),
        _conv(11, 1), _conv(20), sc(8),
        _conv(36, 3, 2), _conv(18, 1), _conv(36), sc(12),
        _conv(18, 1), _conv(36), sc(15), _conv(18, 1),
    ]


def _narrow_vgg16():
    """VGG-16's layer kinds at narrow widths: relu convs, pools, and the
    fc head on the spatial mean."""
    pool = dict(kind="maxpool", size=2, stride=2)
    return [
        _conv(8, act="relu"), _conv(11, act="relu"), pool,
        _conv(12, act="relu"), pool, _conv(16, act="relu"), pool,
        dict(kind="fc", out_channels=20, activation="relu", batch_norm=False),
        dict(kind="fc", out_channels=10, activation="linear", batch_norm=False),
    ]


def _narrow_vgg16_3pass():
    """Relu convs that halve their channels (16 -> 8) on a large map,
    where the reference's planner sends them to the 3-pass pipeline when a
    policy forces it (and the convs before them to im2col)."""
    pool = dict(kind="maxpool", size=2, stride=2)
    return [
        _conv(16, act="relu"), _conv(8, act="relu"), pool,
        _conv(16, act="relu"), _conv(8, act="relu"), pool,
        dict(kind="fc", out_channels=10, activation="linear", batch_norm=False),
    ]


ALL_ALGOS = {ConvAlgorithm.DIRECT, ConvAlgorithm.IM2COL_GEMM,
             ConvAlgorithm.WINOGRAD}


def _models(spec_rows, hw, name):
    ours = repro_torch.CNNModel([CNNLayer(**r) for r in spec_rows], hw,
                                name=name)
    ref = repro.CNNModel([JCNNLayer(**r) for r in spec_rows], hw, name=name)
    return ours, ref


@pytest.mark.parametrize("rows,hw,batch,seed,algos,options", [
    (_narrow_tiny(), (64, 64), 1, 0, ALL_ALGOS, {}),
    (_narrow_tiny(), (64, 64), 2, 1, ALL_ALGOS, {}),
    (_narrow_tiny(), (64, 64), 2, 1, ALL_ALGOS, {"pretransform": False}),
    (_narrow_layers_20(), (64, 56), 1, 2, ALL_ALGOS, {}),
    (_narrow_vgg16(), (48, 48), 2, 3, {ConvAlgorithm.WINOGRAD}, {}),
    # A forced 3-pass planner competes im2col against the 3-pass pipeline,
    # which these narrow widths never pick, as the reference's planner.
    (_narrow_tiny(), (64, 64), 2, 1,
     {ConvAlgorithm.DIRECT, ConvAlgorithm.IM2COL_GEMM},
     {"winograd_fused": False}),
    (_narrow_vgg16(), (48, 48), 2, 3, {ConvAlgorithm.IM2COL_GEMM},
     {"winograd_fused": False}),
    (_narrow_vgg16_3pass(), (96, 96), 2, 4,
     {ConvAlgorithm.IM2COL_GEMM, ConvAlgorithm.WINOGRAD},
     {"winograd_fused": False}),
    # Measure mode picks per layer from the CPU's timings: any split is
    # right, as long as the output matches.
    (_narrow_vgg16(), (48, 48), 2, 3, None, {"mode": "measure"}),
], ids=["tiny-b1", "tiny-b2", "tiny-b2-no-pretransform", "layers20-b1",
        "vgg16-b2", "tiny-b2-3pass", "vgg16-b2-3pass", "vgg16-3pass-96-b2",
        "vgg16-b2-measure"])
def test_compiled_slice_matches_reference(rows, hw, batch, seed, algos,
                                          options):
    ours, ref_model = _models(rows, hw, "narrow")
    rng = np.random.default_rng(seed)
    params = random_batchnorm(init_cnn(rng, ours.layers), rng)
    x = _np(rng, batch, *hw, 3)

    compiled = repro_torch.compile(ours, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", batch=batch, **options))
    if algos is not None:
        assert set(compiled.network_plan().algorithm_counts()) == algos
    pretransform = options.get("pretransform", True)
    # Every Winograd step runs the realization the policy asks for (the
    # fused kernel under impl='torch' unless forced to 3-pass), and keeps
    # (8, 8, C, O) weights from the offline transform, or its (3, 3, C, O)
    # weights to be transformed on every forward.
    executor = compiled.executor()
    for s in executor.netplan.steps:
        if s.layer.kind != "conv":
            continue
        assert s.plan.source == ("measured" if options.get("mode") == "measure"
                                 else "cost_rule")
        if s.plan.algorithm is ConvAlgorithm.WINOGRAD:
            assert s.plan.winograd_fused is (
                options.get("winograd_fused") is not False)
            assert executor.params[s.index]["w"].shape[0] == (
                8 if pretransform else 3)
    got = compiled.run(x).numpy()

    ref = np.asarray(repro.compile(ref_model, params, repro.ExecutionOptions(
        impl="jax", batch=batch, cache_path=None,
        winograd_fused=options.get("winograd_fused"))).run(jnp.asarray(x)))
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * max(scale, 1.0))


def test_plan_pads_only_to_the_kernels_multiple():
    """Channel pads follow the CUDA kernels (multiples of 8 for Winograd
    and im2col, none for the GEMM), and a producer whose width the next
    conv cannot take as it is pads its out channels for it (an elided
    boundary), never to 128 lanes."""
    ours, _ = _models(_narrow_tiny(), (64, 64), "narrow")
    compiled = repro_torch.compile(ours, init_cnn(np.random.default_rng(0),
                                                  ours.layers),
                                   repro_torch.ExecutionOptions(
                                       impl="torch", device="cpu"))
    steps = {s.index: s for s in compiled.network_plan().steps}
    assert (steps[0].in_layout.c, steps[0].in_layout.pad_c) == (3, 5)
    # conv 4 (13 channels) feeds conv 6 through a pool: padded to 16.
    assert (steps[4].out_layout.c, steps[4].out_layout.pad_c) == (13, 3)
    assert steps[6].in_layout == steps[4].out_layout
    # route sources and heads stay logical; the GEMM takes any width.
    assert steps[8].out_layout.trivial and steps[13].out_layout.trivial
    assert steps[15].out_layout.trivial and steps[21].out_layout.trivial
    assert max(s.in_layout.pad_c for s in steps.values()) < 8
    report = compiled.plan_report()
    assert report["elided_boundaries"] == compiled.network_plan(
    ).elided_boundaries >= 2

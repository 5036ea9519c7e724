"""The port's 3-pass Winograd pipeline and the planner's choice of
realization, against the JAX package.

The three stage wrappers (``impl='torch'`` on the CPU) go against the
Pallas 3-pass kernels run with ``interpret=True``, at ragged T, C, O with
the Pallas side padded to blocks of 8, at rtol = atol = 5e-4
(tests/test_conv_conformance.py).  The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch
from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.core.netplan import plan_network as j_plan_network
from repro.core.planner import Planner as JPlanner
from repro.models.cnn import CNNLayer as JCNNLayer
from repro.kernels.winograd import conv2d_winograd_pallas
from repro.kernels.winograd.kernel import (
    input_transform_pallas,
    output_transform_pallas,
    tuple_multiply_pallas,
)
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec, Epilogue
from repro_torch.core.planner import Planner, plan_key
from repro_torch.core.winograd import transform_weights
from repro_torch.kernels.conv_ops import conv2d_cuda
from repro_torch.kernels.winograd.ops import (
    THREE_PASS_BLOCKS,
    conv2d_winograd_padded_call,
    input_transform,
    output_transform,
    pick_blocks,
    tuple_multiply,
)
from repro_torch.models.cnn import CNNLayer, init_cnn

TOL = dict(rtol=5e-4, atol=5e-4)
T, C, O = 21, 16, 20          # ragged against the Pallas blocks of 8
BLK = 8


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pad_to(a, shape):
    return np.pad(a, [(0, s - d) for d, s in zip(a.shape, shape)])


def _ceil_to(x, q):
    return -(-x // q) * q


TP, OP = _ceil_to(T, BLK), _ceil_to(O, BLK)


# ---------------------------------------------------------------------------
# The three stages against the Pallas kernels


def test_input_transform_matches_pallas():
    tiles = _np(np.random.default_rng(20), T, 8, 8, C)
    ref = input_transform_pallas(jnp.asarray(_pad_to(tiles, (TP, 8, 8, C))),
                                 BLK, BLK, interpret=True)
    got = input_transform(torch.from_numpy(tiles), impl="torch")
    assert got.shape == (8, 8, T, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :, :T], **TOL)


def test_tuple_multiply_matches_pallas():
    rng = np.random.default_rng(21)
    v, u = _np(rng, 64, T, C), _np(rng, 64, C, O)
    ref = tuple_multiply_pallas(jnp.asarray(_pad_to(v, (64, TP, C))),
                                jnp.asarray(_pad_to(u, (64, C, OP))),
                                BLK, BLK, BLK, interpret=True)
    got = tuple_multiply(torch.from_numpy(v), torch.from_numpy(u),
                         impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :T, :O], **TOL)


@pytest.mark.parametrize("with_bias,act", [(True, "leaky"), (False, "linear")],
                         ids=["bias-leaky", "nobias-linear"])
def test_output_transform_matches_pallas(with_bias, act):
    rng = np.random.default_rng(22)
    m, bias = _np(rng, 8, 8, T, O), _np(rng, O)
    ref = output_transform_pallas(
        jnp.asarray(_pad_to(m, (8, 8, TP, OP))), BLK, BLK, interpret=True,
        bias=jnp.asarray(_pad_to(bias, (OP,)))[None] if with_bias else None,
        activation=act)
    got = output_transform(torch.from_numpy(m),
                           torch.from_numpy(bias) if with_bias else None,
                           act, impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:T, ..., :O], **TOL)


# ---------------------------------------------------------------------------
# The 3-pass conv


def _conv_inputs(seed, c=5, o=11):
    rng = np.random.default_rng(seed)
    return _np(rng, 2, 14, 13, c), _np(rng, 3, 3, c, o), _np(rng, o)


def test_3pass_conv_matches_conv2d_winograd_pallas():
    x, w, bias = _conv_inputs(23)
    c, o = w.shape[2], w.shape[3]
    ref = conv2d_winograd_pallas(
        jnp.asarray(x), jnp.asarray(w), JConvSpec(c, o), interpret=True,
        bias=jnp.asarray(bias), activation="leaky", fused=False)
    xt = torch.from_numpy(x)
    got = conv2d_winograd_padded_call(
        F.pad(xt, (0, 0, 1, 1, 1, 1)), transform_weights(torch.from_numpy(w)),
        14, 13, THREE_PASS_BLOCKS, bias=torch.from_numpy(bias),
        activation="leaky", impl="torch", fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fused_and_3pass_realizations_agree():
    """Both realizations are the same math: they agree far tighter than
    either agrees with an oracle."""
    x, w, bias = _conv_inputs(24, c=8, o=12)
    spec = ConvSpec(8, 12, algorithm=ConvAlgorithm.WINOGRAD)
    out = []
    for policy in (True, False):
        plan = Planner(impl="torch", winograd_fused=policy).plan(spec, 14, 13,
                                                                 batch=2)
        assert plan.winograd_fused is policy
        out.append(conv2d_cuda(
            torch.from_numpy(x), torch.from_numpy(w), spec, plan.algorithm,
            plan=plan, epilogue=Epilogue(torch.from_numpy(bias), "relu"),
            impl="torch").numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The planner's realization policy and measure mode


def _narrow_vgg():
    def conv(ch):
        return CNNLayer("conv", out_channels=ch, kernel=3, activation="relu")

    pool = CNNLayer("maxpool", size=2, stride=2)
    return (conv(8), conv(11), pool, conv(12), pool, conv(16), conv(8),
            CNNLayer("fc", out_channels=10, activation="linear",
                     batch_norm=False))


def _compile(**options):
    layers = _narrow_vgg()
    model = repro_torch.CNNModel(layers, (48, 48), name="narrow")
    params = init_cnn(np.random.default_rng(25), layers)
    return repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", batch=2, **options))


def _winograd_steps(compiled):
    return [s for s in compiled.network_plan().steps if s.layer.kind == "conv"
            and s.plan.algorithm is ConvAlgorithm.WINOGRAD]


@pytest.mark.parametrize("policy,fused,winograd,launches", [
    (None, True, [0, 1, 3, 5, 6], {"winograd_fused": 5}),
    (True, True, [0, 1, 3, 5, 6], {"winograd_fused": 5}),
    # A forced 3-pass planner competes im2col against the 3-pass pipeline:
    # only the conv that halves its channels keeps Winograd.
    (False, False, [6], {"input_transform": 1, "tuple_multiply": 1,
                         "output_transform": 1, "im2col_conv": 4}),
])
def test_planner_policy_picks_the_realization(policy, fused, winograd,
                                              launches):
    compiled = _compile(winograd_fused=policy)
    steps = _winograd_steps(compiled)
    assert [s.index for s in steps] == winograd
    for s in steps:
        assert s.plan.winograd_fused is fused
        assert s.plan.source == "cost_rule"
        spec, (h, w) = s.spec, s.in_hw
        assert s.plan.kernel_blocks == pick_blocks(
            2 * -(-h // 6) * -(-w // 6), spec.in_channels, spec.out_channels,
            fused=fused)
    rows = {r["index"]: r for r in compiled.plan_report()["layers"]}
    assert all(rows[s.index]["winograd_fused"] is fused for s in steps)
    assert compiled.network_plan().kernel_launches() == launches
    # The reference's planner under the same policy makes the same plans.
    ref = j_plan_network(
        [JCNNLayer(**dataclasses.asdict(l)) for l in _narrow_vgg()], 48, 48,
        JPlanner(impl="jax", cache_path=None, winograd_fused=policy), batch=2)
    assert [(s.plan.algorithm.value, s.plan.winograd_fused)
            for s in ref.steps if s.plan is not None] == [
        (s.plan.algorithm.value, s.plan.winograd_fused)
        for s in compiled.network_plan().steps if s.plan is not None]


def test_policy_and_mode_are_part_of_the_plan_key():
    spec = ConvSpec(8, 16)
    keys = {plan_key(spec, 24, 24, 1, "cuda", mode, wf)
            for mode in ("cost", "measure") for wf in (None, True, False)}
    assert len(keys) == 6
    planner = Planner(impl="torch", winograd_fused=False)
    planner.plan(spec, 24, 24)
    assert list(planner._plans) == [plan_key(spec, 24, 24, 1, "torch", "cost",
                                             False)]


def test_measure_mode_keeps_the_fastest_candidate():
    compiled = _compile(mode="measure")
    convs = [s for s in compiled.network_plan().steps if s.layer.kind == "conv"]
    for s in convs:
        assert s.plan.source == "measured"
        times = dict(s.plan.measured_ms)
        # impl='torch': the fused realization only, beside im2col.
        assert set(times) == {"winograd_fused", "im2col_gemm"}
        assert s.plan.label == min(times, key=times.get)
    assert compiled.plan_report()["mode"] == "measure"


def test_measure_mode_candidate_failure_stops_compile(monkeypatch):
    """A candidate that raises is never skipped: compile raises."""
    from repro_torch.kernels.im2col_gemm import ops

    def broken(*args, **kwargs):
        raise RuntimeError("im2col candidate failed")

    monkeypatch.setattr(ops, "im2col_conv_ref", broken)
    with pytest.raises(RuntimeError, match="im2col candidate failed"):
        _compile(mode="measure")


def test_options_validate_mode_and_policy():
    with pytest.raises(ValueError, match="mode"):
        repro_torch.ExecutionOptions(impl="torch", device="cpu", mode="fast")
    with pytest.raises(ValueError, match="winograd_fused"):
        repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                     winograd_fused="yes")

"""The port's int8 path against the JAX package's.

- The int8 kernels' plain versions (``matmul_q8_ref``,
  ``im2col_conv_q8_ref``) against the Pallas int8 bodies
  (``matmul_pallas(..., scale=)``, ``conv2d_im2col_gemm_pallas(...,
  scale=)``) in interpret mode, on identical int8 inputs: both sum the
  products exactly in int32 and apply the same fp32 epilogue, rtol 1e-6.
- The planner's resolved (algorithm, dtype) per conv against the
  reference planner's on the four full-size cells (planning only).
- Whole networks at full channel widths at 32x32:
  ``repro_torch.compile(..., dtype='int8', impl='torch', device='cpu')``
  against ``repro.compile(..., impl='jax', dtype='int8')`` with the same
  calibration batch: the same int8 layers, and an SQNR of at least 40 dB
  (the reference's impl='jax' int8 path sums the integer products in fp32,
  not exactly, and the fp32 layers before an int8 layer sum in another
  order, so a value near a quantization step may round the other way);
  and at least 30 dB against the port's own fp32 compilation, the
  reference's acceptance gate, in its setup (tests/test_conv_conformance.py
  ::test_int8_network_acceptance: identity batchnorm, the input as the
  calibration batch).
- Option validation, the int32 overflow bound and the CPU-tensor refusal
  of both int8 wrappers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.configs import vgg16 as jvgg16
from repro.configs import yolov3 as jyolov3
from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.core.netplan import plan_network as j_plan_network
from repro.core.planner import Planner as JPlanner
from repro.kernels.gemm.kernel import matmul_pallas
from repro.kernels.im2col_gemm.kernel import conv2d_im2col_gemm_pallas
from repro.kernels.im2col_gemm.ops import pad_conv_operands
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec, Epilogue
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.core.quant import sqnr_db
from repro_torch.kernels.conv_ops import conv2d_cuda, plan_kernels
from repro_torch.kernels.gemm.ops import matmul_q8_bias_act
from repro_torch.kernels.gemm.ref import matmul_q8_ref
from repro_torch.kernels.im2col_gemm.ops import im2col_conv_q8
from repro_torch.kernels.im2col_gemm.ref import im2col_conv_q8_ref
from repro_torch.models.cnn import CNNLayer, init_cnn

RTOL = 1e-6


def _q8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _scale(rng, n):
    return (rng.uniform(0.5, 2.0, n) * 1e-3).astype(np.float32)


def _ceil_to(x, q):
    return -(-x // q) * q


def _pad_to(a, shape):
    return np.pad(a, [(0, s - d) for d, s in zip(a.shape, shape)])


def _close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


# ---------------------------------------------------------------------------
# 1. The plain versions against the Pallas int8 bodies


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ["linear", "relu", "leaky"])
def test_matmul_q8_ref_matches_pallas(with_bias, act):
    rng = np.random.default_rng(0)
    m, n, k = 37, 70, 45                             # ragged M, N and K
    a, b = _q8(rng, m, k), _q8(rng, k, n)
    scale = _scale(rng, n)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    bm, bn, bk = 8, 128, 128
    mp, np_, kp = _ceil_to(m, bm), _ceil_to(n, bn), _ceil_to(k, bk)
    ref = matmul_pallas(
        jnp.asarray(_pad_to(a, (mp, kp))), jnp.asarray(_pad_to(b, (kp, np_))),
        bm, bn, bk, interpret=True, activation=act,
        bias=None if bias is None else jnp.asarray(_pad_to(bias, (np_,)))[None],
        scale=jnp.asarray(_pad_to(scale, (np_,)))[None],
    )
    got = matmul_q8_ref(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(scale),
                        None if bias is None else torch.from_numpy(bias), act)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(ref)[:m, :n])
    # The wrapper's plain route is the same function.
    via = matmul_q8_bias_act(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(scale),
                             None if bias is None else torch.from_numpy(bias),
                             act, impl="torch")
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad", [0, 1])
def test_im2col_conv_q8_ref_matches_pallas(stride, pad):
    rng = np.random.default_rng(1 + stride * 10 + pad)
    b, h, w, c, o = 2, 11, 9, 16, 20
    x, wt = _q8(rng, b, h, w, c), _q8(rng, 3, 3, c, o)
    scale, bias = _scale(rng, o), rng.standard_normal(o).astype(np.float32)
    jspec = JConvSpec(c, o, (3, 3), (stride, stride), (pad, pad))
    oh, ow = jspec.out_hw(h, w)
    toh, bc, bo = 4, 16, 128
    x_p, w_p, bias_p = pad_conv_operands(
        jnp.asarray(x), jnp.asarray(wt), jspec, (toh, bc, bo),
        bias=jnp.asarray(bias))
    ref = conv2d_im2col_gemm_pallas(
        x_p, w_p, stride, stride, oh, ow, toh, bc, bo, interpret=True,
        bias=bias_p, activation="leaky",
        scale=jnp.asarray(_pad_to(scale, (bo,)))[None])
    spec = ConvSpec(c, o, (3, 3), (stride, stride), (pad, pad))
    got = im2col_conv_q8_ref(torch.from_numpy(x), torch.from_numpy(wt), spec,
                             torch.from_numpy(scale), torch.from_numpy(bias),
                             "leaky")
    assert got.shape == (b, oh, ow, o)
    _close(got.numpy(), np.asarray(ref)[:, :oh, :, :o])
    via = im2col_conv_q8(torch.from_numpy(x), torch.from_numpy(wt), spec,
                         torch.from_numpy(scale), bias=torch.from_numpy(bias),
                         activation="leaky", impl="torch")
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_int8_dispatch_matches_its_kernels():
    """conv2d_cuda routes an int8 input with a dequant scale to the int8
    kernels, padding channels to 16 on its self-contained path."""
    rng = np.random.default_rng(2)
    x, w = _q8(rng, 1, 7, 8, 13), _q8(rng, 1, 1, 13, 6)
    scale = torch.from_numpy(_scale(rng, 6))
    epi = Epilogue(None, "relu", scale)
    got = conv2d_cuda(torch.from_numpy(x), torch.from_numpy(w),
                      ConvSpec(13, 6, (1, 1), padding=(0, 0)),
                      ConvAlgorithm.DIRECT, epilogue=epi, impl="torch")
    ref = matmul_q8_ref(torch.from_numpy(x.reshape(56, 13)),
                        torch.from_numpy(w.reshape(13, 6)), scale, None, "relu")
    np.testing.assert_array_equal(got.numpy(), ref.reshape(1, 7, 8, 6).numpy())


# ---------------------------------------------------------------------------
# 2. The planner's int8 decisions against the reference planner's


PLAN_CELLS = [
    (yolov3.TINY_MODEL, jyolov3.TINY_LAYERS, 1),
    (yolov3.TINY_MODEL, jyolov3.TINY_LAYERS, 4),
    (vgg16.MODEL, jvgg16.LAYERS, 1),
    (yolov3.MODEL_20, jyolov3.LAYERS_20, 1),
]


@pytest.mark.parametrize("model,jlayers,batch", PLAN_CELLS,
                         ids=[f"{m.name}-b{b}" for m, _, b in PLAN_CELLS])
def test_int8_plan_matches_reference(model, jlayers, batch):
    h, w = model.input_hw
    ours = plan_network(model.layers, h, w, Planner(impl="cuda"),
                        in_channels=model.in_channels, batch=batch,
                        dtype="int8")
    ref = j_plan_network(jlayers, h, w,
                         JPlanner(impl="pallas", cache_path=None),
                         in_channels=model.in_channels, batch=batch,
                         dtype="int8")
    got = [(s.index, s.plan.algorithm.value, s.plan.dtype)
           for s in ours.steps if s.layer.kind == "conv"]
    want = [(s.index, s.plan.algorithm.value, s.plan.dtype)
            for s in ref.steps if s.layer.kind == "conv"]
    assert got == want
    assert ours.dtype == "int8"
    # Every int8 step runs an int8 kernel, once.
    launches = ours.kernel_launches()
    n8 = sum(1 for _, _, d in got if d == "int8")
    assert launches.get("gemm_q8", 0) + launches.get("im2col_conv_q8", 0) == n8
    # Decided by the reference's rule, which prices nothing on the card.
    assert {(s.plan.source, s.plan.predicted_s) for s in ours.steps
            if s.plan is not None} == {("cost_rule", None)}


def test_int8_winograd_only_under_the_error_budget(monkeypatch):
    """A 3x3 layer that plans fp32 Winograd goes to int8 im2col, because
    F(6,3) misses the transform-stage error budget; were the budget met,
    the planner would keep Winograd in int8, as the reference does (and the
    dispatcher, which has no int8 Winograd kernel, would refuse it)."""
    from repro_torch.core import quant

    spec = ConvSpec(64, 64)
    assert Planner(impl="torch", device="cpu").plan(spec, 64, 64).algorithm \
        is ConvAlgorithm.WINOGRAD                              # 121 tiles
    plan = Planner(impl="torch", device="cpu").plan(spec, 64, 64, dtype="int8")
    assert (plan.algorithm, plan.dtype) == (ConvAlgorithm.IM2COL_GEMM, "int8")
    monkeypatch.setattr(quant, "winograd_int8_budget_ok", lambda: True)
    plan = Planner(impl="torch", device="cpu").plan(spec, 64, 64, dtype="int8")
    assert (plan.algorithm, plan.dtype) == (ConvAlgorithm.WINOGRAD, "int8")
    x = torch.zeros(1, 64, 64, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="never routes to Winograd"):
        conv2d_cuda(x, torch.zeros(3, 3, 64, 64, dtype=torch.int8), spec,
                    plan.algorithm, plan, Epilogue(None, "linear",
                                                   torch.ones(64)),
                    impl="torch")


def test_int8_plan_pads_to_the_int8_kernels_multiple():
    """An int8 step's input layout is a multiple of 16 (the int8 kernels'
    16-byte loads), and a producer that feeds one pads its out channels to
    16; int8 plans have their own label and cache key."""
    rows = [dict(kind="conv", out_channels=ch, kernel=3, stride=1,
                 batch_norm=True, activation="leaky") for ch in (24, 40, 20)]
    model = repro_torch.CNNModel([CNNLayer(**r) for r in rows], (16, 16))
    planner = Planner(impl="torch", device="cpu")
    netplan = plan_network(model.layers, 16, 16, planner, dtype="int8")
    steps = netplan.steps
    assert [s.plan.dtype for s in steps] == ["float32", "int8", "int8"]
    assert steps[1].in_layout.phys_c % 16 == 0 and steps[0].out_layout.pad_c == 8
    assert steps[2].in_layout.phys_c == 48 and steps[1].out_layout.pad_c == 8
    assert steps[1].plan.label == "im2col_gemm_int8"
    assert plan_kernels(steps[1].plan) == ("im2col_conv_q8",)
    fp32 = plan_network(model.layers, 16, 16, planner)
    assert all(s.plan.dtype == "float32" for s in fp32.steps)
    assert planner.stats["tunes"] == 6


# ---------------------------------------------------------------------------
# 3. Whole networks against repro.compile(..., dtype='int8')


NETS = [("yolov3-tiny", 1), ("yolov3-tiny", 2), ("vgg16", 1), ("vgg16", 2)]


@pytest.mark.parametrize("name,batch", NETS, ids=[f"{n}-b{b}" for n, b in NETS])
def test_int8_network_matches_reference(name, batch):
    ours_model = yolov3.TINY_MODEL if name == "yolov3-tiny" else vgg16.MODEL
    ref_model = (jyolov3.TINY_MODEL if name == "yolov3-tiny"
                 else jvgg16.MODEL).with_input_hw((32, 32))
    model = repro_torch.CNNModel(ours_model.layers, (32, 32), name=name)
    rng = np.random.default_rng(batch)
    params = init_cnn(rng, model.layers)
    x = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)

    q = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", dtype="int8", batch=batch), calibration=x)
    got = q.run(x).numpy()
    fp32 = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", batch=batch)).run(x).numpy()
    jq = repro.compile(ref_model, params, repro.ExecutionOptions(
        impl="jax", dtype="int8", batch=batch, cache_path=None),
        calibration=jnp.asarray(x))
    ref = np.asarray(jq.run(jnp.asarray(x)))

    report, jreport = q.plan_report(), jq.plan_report()
    assert report["dtype"] == "int8"
    assert [r["dtype"] for r in report["layers"]] == [
        r["dtype"] for r in jreport["layers"]]
    dtypes = [r["dtype"] for r in report["layers"]]
    assert dtypes[0] == "float32" and dtypes.count("int8") == len(dtypes) - 1
    assert got.shape == ref.shape == fp32.shape
    assert np.isfinite(got).all()
    assert sqnr_db(ref, got) >= 40.0
    assert sqnr_db(fp32, got) >= 30.0


# ---------------------------------------------------------------------------
# 4. and 5. Options, dispatch and wrapper guards


def test_execution_options_dtype():
    opts = repro_torch.ExecutionOptions
    assert opts(impl="torch", device="cpu").dtype == "float32"
    # Under int8 run() still takes an fp32 batch: each int8 layer
    # quantizes its own input.
    model = repro_torch.CNNModel([CNNLayer("conv", 16)], (8, 8))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 8, 8, 3))                     # float64
    y = repro_torch.compile(model, init_cnn(rng, model.layers), opts(
        impl="torch", device="cpu", dtype="int8"), calibration=x).run(x)
    assert y.dtype == torch.float32 and y.shape == (1, 8, 8, 16)
    # bf16 and fp16 construct and plan (tests/test_torch_cnn16.py runs
    # them); int4 is no dtype of the reference.
    for half in ("bfloat16", "float16"):
        o = opts(impl="torch", device="cpu", dtype=half)
        assert o.dtype == o.input_dtype == half
        plan = Planner(impl="torch", device="cpu").plan(ConvSpec(8, 8), 8, 8,
                                                        dtype=half)
        assert plan.dtype == half
    with pytest.raises(ValueError, match="dtype must be one of"):
        opts(impl="torch", device="cpu", dtype="int4")
    with pytest.raises(ValueError, match="dtype must be one of"):
        Planner(impl="torch", device="cpu").plan(ConvSpec(8, 8), 8, 8,
                                                 dtype="int4")


def test_int8_winograd_dispatch_raises():
    x = torch.zeros(1, 8, 8, 16, dtype=torch.int8)
    w = torch.zeros(3, 3, 16, 16, dtype=torch.int8)
    epi = Epilogue(None, "linear", torch.ones(16))
    with pytest.raises(ValueError, match="never routes to Winograd"):
        conv2d_cuda(x, w, ConvSpec(16, 16), ConvAlgorithm.WINOGRAD,
                    epilogue=epi, impl="torch")
    with pytest.raises(ValueError, match="dequant scale"):
        conv2d_cuda(x, w, ConvSpec(16, 16), ConvAlgorithm.IM2COL_GEMM,
                    impl="torch")


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_int8_wrappers_refuse_an_overflowing_k(impl):
    """K * 127^2 >= 2^31 could overflow the int32 sum: both wrappers raise
    before running anything, on either impl."""
    k_max = (2 ** 31 - 1) // (127 * 127)             # 133144
    c = -(-(k_max + 1) // 9)                         # 9 * c > k_max
    with pytest.raises(ValueError, match="overflow"):
        matmul_q8_bias_act(torch.zeros(1, k_max + 1, dtype=torch.int8),
                           torch.zeros(k_max + 1, 1, dtype=torch.int8),
                           torch.ones(1), impl=impl)
    c16 = _ceil_to(c, 16)
    with pytest.raises(ValueError, match="overflow"):
        im2col_conv_q8(torch.zeros(1, 1, 1, c16, dtype=torch.int8),
                       torch.zeros(3, 3, c16, 1, dtype=torch.int8),
                       ConvSpec(c16, 1), torch.ones(1), impl=impl)
    # The largest K on the main path (9 * 1024) is far inside the bound.
    assert 9 * 1024 * 127 * 127 < 2 ** 31


def test_int8_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        matmul_q8_bias_act(torch.from_numpy(_q8(rng, 4, 16)),
                           torch.from_numpy(_q8(rng, 16, 3)),
                           torch.ones(3), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        im2col_conv_q8(torch.from_numpy(_q8(rng, 1, 6, 6, 16)),
                       torch.from_numpy(_q8(rng, 3, 3, 16, 4)),
                       ConvSpec(16, 4), torch.ones(4), impl="cuda")

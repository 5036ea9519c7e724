"""bf16 and fp16 CNN inference of the port against the JAX package.

Kernels: the same 16-bit inputs (numpy values from a seed, rounded to the
type once) go through the reference's Pallas kernels in interpret mode, as
tests/test_kernels.py runs them on the CPU, and through the port's 16-bit
wrappers with ``impl='torch'`` (their plain versions) on the CPU, with
bias and activation.  The slice: the narrow nets of
tests/test_torch_slice.py compiled with ``dtype='bfloat16' | 'float16'``
against ``repro.compile(..., impl='pallas', dtype=...)`` on the same fp32
parameters.  Tolerance, of max(1, max|ref|): 2e-2 in bf16 (the reference
suite's own bf16 tolerance, tests/test_kernels.py), 5e-3 in fp16 (fp16
rounds 8 times finer than bf16, 2^-11 against 2^-8, and the gate keeps a
factor of 2).  The port rounds its conv weights to the 16-bit type offline
where the reference keeps them fp32; the tolerance covers that.  Winograd
weights go split into hi and lo parts (core/winograd.py), as accurate as
the reference's fp32 ones.

Plans: cost mode in 16 bits gives the reference's cost-mode splits on the
three full-size networks (plans only, no forward).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.kernels.gemm.kernel import matmul_pallas
from repro.kernels.im2col_gemm.kernel import conv2d_im2col_gemm_pallas
from repro.kernels.im2col_gemm.ops import pad_conv_operands
from repro.kernels.winograd.kernel import (
    fused_winograd_pallas,
    input_transform_pallas,
    output_transform_pallas,
    tuple_multiply_pallas,
)
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.core.winograd import split_transformed, transform_weights
from repro_torch.kernels.gemm.ops import (
    TILE_16,
    matmul16_bias_act,
    matmul_bias_act,
)
from repro_torch.kernels.im2col_gemm.ops import im2col_conv, im2col_conv16
from repro_torch.kernels.winograd.ops import (
    FUSED_BLOCKS_16,
    THREE_PASS_BLOCKS_16,
    fused_winograd,
    fused_winograd16,
    input_transform,
    input_transform16,
    output_transform,
    output_transform16,
    tuple_multiply,
    tuple_multiply16,
)
from repro_torch.models.cnn import init_cnn, random_batchnorm
from test_torch_slice import _models, _narrow_layers_20, _narrow_tiny, \
    _narrow_vgg16

DTYPES = ("bfloat16", "float16")
TOL = {"bfloat16": 2e-2, "float16": 5e-3}


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rounded(a, dtype):
    """``a`` rounded to ``dtype`` once, back as fp32 numpy: the same values
    for both packages."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _both(a, dtype):
    """(jax array, torch tensor) of ``a`` rounded to ``dtype``."""
    r = _rounded(a, dtype)
    return (jnp.asarray(r).astype(getattr(jnp, dtype)),
            torch.from_numpy(r).to(getattr(torch, dtype)))


def _check(got, ref, dtype):
    """``got`` (a tensor of ``dtype``) within the dtype's tolerance of the
    reference's jax array ``ref``."""
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= TOL[dtype] * max(1.0, float(np.abs(ref).max())), err


def _ceil_to(x, q):
    return -(-x // q) * q


def _pad_to(a, shape):
    return jnp.pad(a, [(0, s - d) for d, s in zip(a.shape, shape)])


# ---------------------------------------------------------------------------
# Kernels: the 16-bit plain versions against the Pallas kernels


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,act", [(37, 70, 48, "leaky"),
                                       (169, 255, 40, "linear")])
def test_gemm16_matches_matmul_pallas(dtype, m, n, k, act):
    rng = np.random.default_rng(0)
    (ja, a), (jb, b) = (_both(_np(rng, m, k), dtype),
                        _both(_np(rng, k, n, scale=k ** -0.5), dtype))
    bias = _np(rng, n)
    bm, bn, bk = 8, 128, 128
    mp, np_, kp = _ceil_to(m, bm), _ceil_to(n, bn), _ceil_to(k, bk)
    ref = matmul_pallas(_pad_to(ja, (mp, kp)), _pad_to(jb, (kp, np_)),
                        bm, bn, bk, interpret=True,
                        bias=_pad_to(jnp.asarray(bias), (np_,))[None],
                        activation=act)
    assert ref.dtype == getattr(jnp, dtype)
    got = matmul16_bias_act(a, b, torch.from_numpy(bias), act, impl="torch")
    _check(got, ref[:m, :n], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    dict(h=9, w=11, c=16, o=20, s=1, act="leaky"),
    dict(h=13, w=10, c=8, o=9, s=2, act="relu"),
])
def test_im2col_conv16_matches_pallas(dtype, case):
    rng = np.random.default_rng(1)
    c, o, s = case["c"], case["o"], case["s"]
    (jx, x), (jw, w) = (_both(_np(rng, 2, case["h"], case["w"], c), dtype),
                        _both(_np(rng, 3, 3, c, o, scale=(9 * c) ** -0.5),
                              dtype))
    bias = _np(rng, o)
    spec = ConvSpec(c, o, (3, 3), (s, s), (1, 1))
    oh, ow = spec.out_hw(case["h"], case["w"])
    from repro.core.conv_spec import ConvSpec as JConvSpec

    toh, bc, bo = 4, 8, 128
    x_p, w_p, bias_p = pad_conv_operands(
        jx, jw, JConvSpec(c, o, (3, 3), (s, s), (1, 1)), (toh, bc, bo),
        bias=jnp.asarray(bias))
    ref = conv2d_im2col_gemm_pallas(
        x_p, w_p, s, s, oh, ow, toh, bc, bo, interpret=True, bias=bias_p,
        activation=case["act"])
    got = im2col_conv16(x, w, spec, bias=torch.from_numpy(bias),
                        activation=case["act"], impl="torch")
    _check(got, ref[:, :oh, :, :o], dtype)


def _winograd_operands(dtype, t=21, c=16, o=20, seed=2):
    """Tiles (rounded to ``dtype``), the fp32 transformed weights the
    reference multiplies by, the port's split of them, and a bias."""
    rng = np.random.default_rng(seed)
    jt, tiles = _both(_np(rng, t, 8, 8, c), dtype)
    u = transform_weights(torch.from_numpy(_np(rng, 3, 3, c, o,
                                               scale=(9 * c) ** -0.5)))
    return jt, tiles, u, split_transformed(u, getattr(torch, dtype)), \
        _np(rng, o)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_winograd16_matches_pallas(dtype):
    jt, tiles, u, split, bias = _winograd_operands(dtype)
    t, c, o = tiles.shape[0], tiles.shape[-1], u.shape[-1]
    bt, bc, bo = 8, 8, 8
    tp, op = _ceil_to(t, bt), _ceil_to(o, bo)
    ref = fused_winograd_pallas(
        _pad_to(jt, (tp, 8, 8, c)), _pad_to(jnp.asarray(u.numpy()),
                                            (8, 8, c, op)),
        bt, bc, bo, interpret=True, bias=_pad_to(jnp.asarray(bias), (op,))[None],
        activation="leaky")
    got = fused_winograd16(tiles, split.hl, split.inv_scale,
                           bias=torch.from_numpy(bias), activation="leaky",
                           impl="torch")
    _check(got, ref[:t, ..., :o], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_three_pass16_matches_pallas(dtype):
    """The 3-pass kernels, each on the reference's previous stage's output
    (V and M in the 16-bit type, as the reference stores them)."""
    jt, tiles, u, split, bias = _winograd_operands(dtype, t=24, seed=3)
    t, c, o = tiles.shape[0], tiles.shape[-1], u.shape[-1]
    v_ref = input_transform_pallas(jt, 8, 8, interpret=True)
    _check(input_transform16(tiles, impl="torch"), v_ref, dtype)
    v = torch.from_numpy(np.array(v_ref.astype(jnp.float32))).to(
        getattr(torch, dtype)).reshape(64, t, c)
    op = _ceil_to(o, 8)
    m_ref = tuple_multiply_pallas(
        v_ref.reshape(64, t, c),
        _pad_to(jnp.asarray(u.numpy()).reshape(64, c, o), (64, c, op)),
        8, 8, 8, interpret=True)[..., :o]
    got = tuple_multiply16(v, split.hl.reshape(2, 64, c, o), split.inv_scale,
                           impl="torch")
    _check(got, m_ref, dtype)
    m = torch.from_numpy(np.array(m_ref.astype(jnp.float32))).to(
        getattr(torch, dtype)).reshape(8, 8, t, o)
    y_ref = output_transform_pallas(
        _pad_to(m_ref.reshape(8, 8, t, o), (8, 8, t, op)), 8, 8,
        interpret=True, bias=_pad_to(jnp.asarray(bias), (op,))[None],
        activation="relu")[..., :o]
    _check(output_transform16(m, torch.from_numpy(bias), "relu",
                              impl="torch"), y_ref, dtype)


# ---------------------------------------------------------------------------
# No quiet cast: each wrapper takes its own types


def _fp32_calls(x16):
    """Each fp32 wrapper called with one 16-bit operand."""
    f = torch.zeros
    return {
        "gemm": lambda impl: matmul_bias_act(x16(8, 8), f(8, 8), impl=impl),
        "im2col_conv": lambda impl: im2col_conv(
            x16(1, 4, 4, 8), f(3, 3, 8, 8), ConvSpec(8, 8), impl=impl),
        "winograd_fused": lambda impl: fused_winograd(
            x16(2, 8, 8, 8), f(8, 8, 8, 8), impl=impl),
        "input_transform": lambda impl: input_transform(x16(2, 8, 8, 8),
                                                        impl=impl),
        "tuple_multiply": lambda impl: tuple_multiply(
            x16(64, 2, 8), f(64, 8, 8), impl=impl),
        "output_transform": lambda impl: output_transform(x16(8, 8, 2, 8),
                                                          impl=impl),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("kernel", ["gemm", "im2col_conv", "winograd_fused",
                                    "input_transform", "tuple_multiply",
                                    "output_transform"])
def test_fp32_wrappers_refuse_16bit_operands(dtype, impl, kernel):
    def x16(*shape):
        return torch.zeros(shape, dtype=getattr(torch, dtype))

    with pytest.raises(ValueError, match="float32"):
        _fp32_calls(x16)[kernel](impl)


def test_16bit_wrappers_refuse_other_types():
    bf, f32 = torch.bfloat16, torch.float32
    z = torch.zeros
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        matmul16_bias_act(z(8, 8), z(8, 8), impl="torch")
    with pytest.raises(ValueError, match="needs bfloat16"):
        matmul16_bias_act(z(8, 8, dtype=bf), z(8, 8, dtype=torch.float16),
                          impl="torch")
    with pytest.raises(ValueError, match="needs float32"):
        im2col_conv16(z(1, 4, 4, 8, dtype=bf), z(3, 3, 8, 8, dtype=bf),
                      ConvSpec(8, 8), bias=z(8, dtype=bf), impl="torch")
    with pytest.raises(ValueError, match="needs bfloat16"):
        fused_winograd16(z(2, 8, 8, 8, dtype=bf), z(2, 8, 8, 8, 8, dtype=f32),
                         z(64), impl="torch")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tuple_multiply16(z(64, 2, 8, dtype=bf), z(2, 64, 8, 8, dtype=bf),
                         z(64))


# ---------------------------------------------------------------------------
# The slice: compile -> plan -> prepare -> run, against repro.compile


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,hw,batch,seed,options", [
    (_narrow_tiny(), (64, 64), 1, 0, {}),
    (_narrow_layers_20(), (64, 56), 1, 2, {}),
    (_narrow_vgg16(), (48, 48), 2, 3, {}),
    (_narrow_vgg16(), (48, 48), 2, 3, {"winograd_fused": False}),
    # Measure mode times the 16-bit candidates (here on the CPU), model
    # mode prices them: any split is right, as long as the output matches.
    (_narrow_vgg16(), (48, 48), 2, 3, {"mode": "measure"}),
    (_narrow_vgg16(), (48, 48), 2, 3, {"mode": "model"}),
], ids=["tiny-b1", "layers20-b1", "vgg16-b2", "vgg16-b2-3pass",
        "vgg16-b2-measure", "vgg16-b2-model"])
def test_compiled_slice16_matches_reference(rows, hw, batch, seed, options,
                                            dtype):
    ours, ref_model = _models(rows, hw, "narrow")
    rng = np.random.default_rng(seed)
    params = random_batchnorm(init_cnn(rng, ours.layers), rng)
    x = _np(rng, batch, *hw, 3)
    compiled = repro_torch.compile(ours, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", batch=batch, dtype=dtype, **options))
    netplan = compiled.network_plan()
    assert netplan.dtype == dtype and compiled.plan_report()["dtype"] == dtype
    wf = options.get("winograd_fused", True)
    source = {"measure": "measured", "model": "cost_model"}.get(
        options.get("mode"), "tile_rule")
    for s in netplan.steps:
        if s.plan is None:
            continue
        assert s.plan.dtype == dtype and s.plan.source == source
        if s.plan.algorithm is ConvAlgorithm.WINOGRAD:
            assert s.plan.kernel_blocks == (
                FUSED_BLOCKS_16 if s.plan.winograd_fused
                else THREE_PASS_BLOCKS_16)
        if s.plan.algorithm is ConvAlgorithm.DIRECT:
            assert s.plan.kernel_blocks == TILE_16
    got = compiled.run(x)
    ref = repro.compile(ref_model, params, repro.ExecutionOptions(
        impl="pallas", batch=batch, dtype=dtype, cache_path=None,
        winograd_fused=wf)).run(jnp.asarray(x))
    # VGG's fc head promotes to fp32, as the reference's does; a conv head
    # stays 16-bit.
    want = "float32" if rows[-1]["kind"] == "fc" else dtype
    assert str(ref.dtype) == want and got.dtype == getattr(torch, want)
    ref = np.asarray(ref.astype(jnp.float32))
    out = got.float().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = float(np.abs(out - ref).max())
    assert err <= TOL[dtype] * max(1.0, float(np.abs(ref).max())), err


# ---------------------------------------------------------------------------
# mode='model' in 16 bits: the 16-bit kernels priced with their own fit
# (hw.H100.kernel_fit's '_16' entries and 'glue_16', fit to the bf16
# records of scripts/cost_model_records_h100.json)


@pytest.mark.parametrize("spec,h,w", [
    (ConvSpec(3, 16), 416, 416),
    (ConvSpec(256, 512, (1, 1), padding=(0, 0)), 13, 13),
    (ConvSpec(32, 64, (3, 3), (2, 2)), 608, 608),
    (ConvSpec(256, 256), 56, 56),
], ids=["stem", "1x1", "stride2", "deep"])
def test_16bit_estimate_launches_what_the_dispatcher_launches(spec, h, w):
    from repro_torch.core.codesign import conv_estimate
    from repro_torch.core.planner import ConvPlan, kernel_blocks
    from repro_torch.kernels.conv_ops import plan_kernels

    for algo in ConvAlgorithm:
        for wf in (True, False):
            if algo is ConvAlgorithm.AUTO or (
                    algo is ConvAlgorithm.DIRECT and spec.kernel_size != (1, 1)
            ) or (algo is ConvAlgorithm.WINOGRAD and (
                    spec.kernel_size != (3, 3) or spec.stride != (1, 1))):
                continue
            est = conv_estimate(spec, h, w, algo, dtype_bytes=2,
                                winograd_fused=wf)
            plan = ConvPlan(algo, "cuda", kernel_blocks(
                spec, algo, h, w, 1, wf, "bfloat16"), dtype="bfloat16",
                winograd_fused=wf and algo is ConvAlgorithm.WINOGRAD)
            assert tuple(p.kernel for p in est.parts
                         if p.kernel != "glue_16"
                         and not p.kernel.endswith("_reduce")) == \
                plan_kernels(plan)
            assert all("_16" in p.kernel for p in est.parts)


# The model's 16-bit plans of the four cells (plans only): the 16-bit
# implicit-GEMM conv everywhere but the 1x1 convs, the same in bf16 and
# fp16 (one fit serves both types' kernels).
MODEL_PLANS_16 = {
    "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, 1, "IIIIIIIDIDDID"),
    "yolov3-tiny 416 b4": (yolov3.TINY_MODEL, 4, "IIIIIIIDIDDID"),
    "yolov3-20 608 b1": (yolov3.MODEL_20, 1, "IIDIIDIDIIDIDID"),
    "vgg16 224 b1": (vgg16.MODEL, 1, "IIIIIIIIIIIII"),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", list(MODEL_PLANS_16))
def test_model_mode_plans16(cell, dtype):
    model, batch, want = MODEL_PLANS_16[cell]
    netplan = plan_network(model.layers, *model.input_hw,
                           Planner(impl="torch", device="cpu", mode="model"),
                           in_channels=model.in_channels, batch=batch,
                           dtype=dtype)
    steps = [s for s in netplan.steps if s.plan is not None]
    assert "".join(_LETTER[s.plan.algorithm] for s in steps) == want
    for s in steps:
        assert s.plan.dtype == dtype and s.plan.source == "cost_model"
        assert s.plan.predicted_s > 0


# ---------------------------------------------------------------------------
# Plans: cost mode's split in 16 bits is the reference's (W Winograd, I
# im2col, D direct, one letter per conv in layer order), the same in all
# three dtypes on these networks


REFERENCE_PLANS = {
    "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, "WWWWIIIDIDDID"),
    "yolov3-20 608 b1": (yolov3.MODEL_20, "WIDWIDWDWIDWDWD"),
    "vgg16 224 b1": (vgg16.MODEL, "WWWWWWWIIIIII"),
}
_LETTER = {ConvAlgorithm.WINOGRAD: "W", ConvAlgorithm.IM2COL_GEMM: "I",
           ConvAlgorithm.DIRECT: "D"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", list(REFERENCE_PLANS))
def test_cost_plans16_equal_reference(cell, dtype):
    model, want = REFERENCE_PLANS[cell]
    netplan = plan_network(model.layers, *model.input_hw,
                           Planner(impl="torch", device="cpu"),
                           in_channels=model.in_channels, batch=1,
                           dtype=dtype)
    steps = [s for s in netplan.steps if s.plan is not None]
    assert "".join(_LETTER[s.plan.algorithm] for s in steps) == want
    assert {s.plan.dtype for s in steps} == {dtype}
    assert {s.in_layout.phys_c % 8 for s in steps} == {0}
    kernels = {"W": "winograd_fused_16", "I": "im2col_conv_16", "D": "gemm_16"}
    assert netplan.kernel_launches() == {
        kernels[k]: want.count(k) for k in set(want)}


# ---------------------------------------------------------------------------
# The build digest follows the 16-bit headers


@pytest.mark.parametrize("header,users", [
    ("csrc/hmma16.cuh", {"gemm_16", "im2col_conv_16", "winograd_fused_16",
                         "winograd_3pass_16"}),
    ("winograd/csrc/winograd16_transforms.cuh", {"winograd_fused_16",
                                                 "winograd_3pass_16"}),
])
def test_library_path_follows_the_16bit_headers(tmp_path, monkeypatch, header,
                                                users):
    import shutil

    from repro_torch.kernels import _build

    copy = tmp_path / "kernels"
    shutil.copytree(_build._KERNELS_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "_KERNELS_DIR", copy)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(copy / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == users

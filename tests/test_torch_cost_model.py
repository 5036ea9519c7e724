"""The port's co-design cost model (``mode='model'``) against the JAX
package's.

- The counts that do not depend on the chip, copied into the port
  (``smem_model.winograd_traffic_bytes`` fused and 3-pass,
  ``smem_model.im2col_gemm_traffic_bytes`` fp32 and int8,
  ``winograd.winograd_flops``, ``conv_spec.arithmetic_intensity``), equal
  the reference's exactly on every conv of YOLOv3-tiny 416 (b1, b4),
  MODEL_20 608 b1 and VGG-16 224 b1.
- The properties of ``tests/test_codesign.py`` on the card's sweeps: a
  larger shared-memory budget never hurts, more SMs never hurt, wider
  tiles need a bigger budget, the AI ordering of ``layer_roofline``, and
  the cost selector refines the paper's rule.
- The model prices what runs: the split each wrapper chooses and its
  reduce, the launches of each realization; it raises where it cannot
  price.
- ``mode='model'``'s split on the four cells, fp32 and int8, pinned
  (plans only): every plan from the model, with a modeled time.
- Narrow nets and VGG-16 at 96x96 compiled with ``mode='model'`` on the
  CPU against ``repro.compile(...).run`` at rtol = 1e-4, atol = 1e-4 *
  max|ref| (fp32), and at an SQNR of at least 30 dB (int8).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.configs import vgg16 as jvgg16
from repro.core.conv_spec import arithmetic_intensity as j_arithmetic_intensity
from repro.core.vmem_model import (
    im2col_gemm_traffic_bytes as j_im2col_gemm_traffic_bytes,
)
from repro.core.vmem_model import winograd_traffic_bytes as j_winograd_traffic_bytes
from repro.core.winograd import winograd_flops as j_winograd_flops
from repro.models.cnn import CNNLayer as JCNNLayer
from repro_torch.configs import vgg16, yolov3
from repro_torch.core import quant
from repro_torch.core.codesign import (
    SMEM_BUDGETS,
    conv_estimate,
    layer_roofline,
    predict_conv_time,
    select_algorithm_by_cost,
    sweep_cache_size,
    sweep_lanes,
)
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec, arithmetic_intensity
from repro_torch.core.netplan import _propagate_shapes, plan_network
from repro_torch.core.planner import Planner
from repro_torch.core.quant import sqnr_db
from repro_torch.core.smem_model import (
    GemmShape,
    im2col_gemm_traffic_bytes,
    predict_gemm,
    predict_winograd,
    winograd_traffic_bytes,
)
from repro_torch.core.winograd import winograd_flops
from repro_torch.hw import H100
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.im2col_gemm import ops as im2col_ops
from repro_torch.models.cnn import CNNLayer, init_cnn, random_batchnorm

CELLS = {
    "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, 1),
    "yolov3-tiny 416 b4": (yolov3.TINY_MODEL, 4),
    "yolov3-20 608 b1": (yolov3.MODEL_20, 1),
    "vgg16 224 b1": (vgg16.MODEL, 1),
}


def _convs():
    """(id, spec, h, w, batch) of every conv of the four cells."""
    out = []
    for cell, (model, batch) in CELLS.items():
        infos = _propagate_shapes(tuple(model.layers), *model.input_hw,
                                  model.in_channels)
        for i, (layer, info) in enumerate(zip(model.layers, infos)):
            if layer.kind == "conv":
                out.append((f"{cell} L{i}", info["spec"], *info["in"][:2],
                            batch))
    return out


CONVS = _convs()


# ---------------------------------------------------------------------------
# 1. The chip-independent counts, against the reference


@pytest.mark.parametrize("spec,h,w,batch", [c[1:] for c in CONVS],
                         ids=[c[0] for c in CONVS])
def test_counts_equal_the_reference(spec, h, w, batch):
    oh, ow = spec.out_hw(h, w)
    cin, cout = spec.in_channels, spec.out_channels
    for fused in (True, False):
        assert winograd_traffic_bytes(oh, ow, cin, cout, batch, 4, fused) == \
            j_winograd_traffic_bytes(oh, ow, cin, cout, batch, 4, fused)
    for dtype_bytes in (4, 1):
        args = (oh, ow, cin, cout, spec.kh, spec.kw, batch, dtype_bytes)
        assert im2col_gemm_traffic_bytes(*args) == j_im2col_gemm_traffic_bytes(*args)
    assert winograd_flops(oh, ow, cin, cout) == j_winograd_flops(oh, ow, cin, cout)
    m, n, k = spec.gemm_dims(h, w)
    for dtype_bytes in (4, 2, 1):
        assert arithmetic_intensity(m, n, k, dtype_bytes) == \
            j_arithmetic_intensity(m, n, k, dtype_bytes)


def test_kernel_fit_is_the_committed_records_fit():
    """hw.H100's fixed times and shares are what scripts/cost_model_fit.py
    fits to the records of its card run committed beside it."""
    import json
    import os

    from repro_torch.core.smem_model import fit

    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "cost_model_records_h100.json")
    with open(path) as f:
        data = json.load(f)
    assert data["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    lines = []
    got = fit(data["records"], log=lines.append)
    assert len(lines) >= len(got)
    assert [k for k, _, _ in H100.kernel_fit] == list(got)
    for name, fixed_s, share in H100.kernel_fit:
        assert fixed_s == pytest.approx(got[name][0], abs=1e-9)
        assert share == pytest.approx(got[name][1], rel=1e-3)


def test_quant_uses_the_one_traffic_count():
    """core/quant.py's traffic gate reads the model's count, not a copy."""
    assert quant.im2col_gemm_traffic_bytes is im2col_gemm_traffic_bytes


# ---------------------------------------------------------------------------
# 2. The co-design sweeps' properties (tests/test_codesign.py, on the card)


@pytest.mark.parametrize("shape", [GemmShape(256, 5776, 1152),
                                   GemmShape(169, 1024, 4608),
                                   GemmShape(12544, 64, 576)],
                         ids=["paper", "deep", "wide"])
def test_bigger_budget_never_hurts(shape):
    best = np.inf
    for budget, points in sweep_cache_size(shape).items():
        t = min(p.estimate.total_s for p in points)
        assert t <= best * (1 + 1e-9)
        best = t
        assert all(p.block.smem_bytes() <= budget for p in points)


@pytest.mark.parametrize("shape", [GemmShape(1024, 8192, 4096),
                                   GemmShape(169, 256, 1024)],
                         ids=["large", "batch-1-layer"])
def test_more_sms_never_hurt(shape):
    times = [p.estimate.total_s for p in sweep_lanes(shape)]
    assert all(b <= a * (1 + 1e-9) for a, b in zip(times, times[1:]))
    assert times[-1] < times[0]


def test_wider_tiles_need_a_bigger_budget():
    """The paper's co-design finding on the card's analogue: the widest
    tile fits only the larger budgets, and the best tile at the largest
    budget is at least as wide, and as fast, as at the smallest."""
    shape = GemmShape(4096, 8192, 1152)
    sweeps = sweep_cache_size(shape)
    small, big = sweeps[SMEM_BUDGETS[0]], sweeps[SMEM_BUDGETS[-1]]
    assert max(p.bn for p in small) < max(p.bn for p in big)
    best_small = min(small, key=lambda p: p.estimate.total_s)
    best_big = min(big, key=lambda p: p.estimate.total_s)
    assert best_big.bn >= best_small.bn
    assert best_big.estimate.total_s <= best_small.estimate.total_s


def test_layer_roofline_ai_ordering():
    low = layer_roofline(ConvSpec(3, 32, (3, 3), (1, 1), (1, 1)), 608, 608)
    high = layer_roofline(ConvSpec(512, 1024, (3, 3), (1, 1), (1, 1)), 26, 26)
    assert high["AI"] > low["AI"]
    assert high["pct_of_peak"] >= low["pct_of_peak"]
    assert high["ai_critical"] == H100.peak_flops_fp32 / H100.hbm_bandwidth


def test_cost_selector_refines_paper_rule():
    """Winograd where the paper's rule says so and the model prices it
    cheaper (an early layer), im2col deep in the network; elsewhere the
    paper's rule."""
    early = ConvSpec(64, 128, (3, 3), (1, 1), (1, 1))
    deep = ConvSpec(512, 1024, (3, 3), (1, 1), (1, 1))
    assert select_algorithm_by_cost(early, 152, 152, winograd_fused=None) \
        is ConvAlgorithm.WINOGRAD
    assert select_algorithm_by_cost(deep, 13, 13, winograd_fused=None) \
        is ConvAlgorithm.IM2COL_GEMM
    one = ConvSpec(64, 64, (1, 1), (1, 1), (0, 0))
    assert select_algorithm_by_cost(one, 64, 64) is ConvAlgorithm.DIRECT
    down = ConvSpec(64, 128, (3, 3), (2, 2), (1, 1))
    assert select_algorithm_by_cost(down, 64, 64) is ConvAlgorithm.IM2COL_GEMM


@pytest.mark.parametrize("cell", list(CELLS))
def test_planner_decides_as_the_cost_selector(cell):
    """Model mode's fp32 algorithm is the cost selector's: one selection
    (``codesign.cheapest_conv``) serves both."""
    planner = Planner(impl="torch", device="cpu", mode="model")
    for cid, spec, h, w, batch in CONVS:
        if cid.startswith(cell + " L"):
            assert planner.plan(spec, h, w, batch).algorithm is \
                select_algorithm_by_cost(spec, h, w, winograd_fused=None,
                                         batch=batch)


# ---------------------------------------------------------------------------
# 3. The model prices what runs, and raises where it cannot price


@pytest.mark.parametrize("m,n,k", [(169, 256, 1024), (169, 128, 256),
                                   (92416, 32, 64), (2704, 255, 256)])
@pytest.mark.parametrize("dtype_bytes", [4, 1], ids=["fp32", "int8"])
def test_gemm_prices_the_wrappers_split_and_its_reduce(m, n, k, dtype_bytes):
    est = predict_gemm(GemmShape(m, n, k), dtype_bytes=dtype_bytes)
    q8 = dtype_bytes == 1
    splits = (gemm_ops.call_splits_q8 if q8 else gemm_ops.call_splits)(m, n, k)
    name = "gemm_q8" if q8 else "gemm"
    assert est.parts[0].kernel == name and est.parts[0].splits == splits
    assert [p.kernel for p in est.parts[1:]] == (
        [name + "_reduce"] if splits > 1 else [])
    assert est.total_s > est.launches * H100.launch_s


@pytest.mark.parametrize("spec,h,w,batch", [c[1:] for c in CONVS[:13]],
                         ids=[c[0] for c in CONVS[:13]])
def test_conv_estimate_launches_what_the_dispatcher_launches(spec, h, w, batch):
    from repro_torch.core.planner import ConvPlan, kernel_blocks
    from repro_torch.kernels.conv_ops import plan_kernels

    for algo in (ConvAlgorithm.IM2COL_GEMM, ConvAlgorithm.WINOGRAD,
                 ConvAlgorithm.DIRECT):
        for wf in (True, False):
            if (algo is ConvAlgorithm.WINOGRAD) != (spec.kernel_size == (3, 3)
                                                   and spec.stride == (1, 1)):
                if algo is not ConvAlgorithm.IM2COL_GEMM:
                    continue
            if algo is ConvAlgorithm.DIRECT and spec.kernel_size != (1, 1):
                continue
            est = conv_estimate(spec, h, w, algo, batch=batch,
                                winograd_fused=wf)
            plan = ConvPlan(algo, "cuda", kernel_blocks(spec, algo, h, w,
                                                        batch, wf),
                            winograd_fused=wf and algo is ConvAlgorithm.WINOGRAD)
            kernels = [p.kernel for p in est.parts
                       if p.kernel != "glue" and not p.kernel.endswith("_reduce")]
            assert tuple(kernels) == plan_kernels(plan)
            if algo is ConvAlgorithm.IM2COL_GEMM:
                oh, ow = spec.out_hw(h, w)
                toh = im2col_ops.snap_row_tile(
                    im2col_ops.pick_blocks(oh, ow)[0], oh)
                splits = im2col_ops.call_splits(batch, oh, ow,
                                                -(-spec.in_channels // 8) * 8,
                                                spec.out_channels, toh)
                assert est.parts[0].splits == splits
                assert len(est.parts) == 1 + (splits > 1)


def test_fused_winograd_runs_one_block_an_sm():
    """The fused kernel's 214 KB of shared memory: a grid of 56 blocks
    takes one wave, 133 blocks two."""
    one = predict_winograd(16 * 28, 128, 64, fused=True).parts[0]
    two = predict_winograd(16 * 133, 128, 32, fused=True).parts[0]
    assert (one.grid, one.waves) == (56, 1) and (two.grid, two.waves) == (133, 2)
    assert one.smem_bytes <= H100.smem_per_block_bytes < 2 * one.smem_bytes


def test_the_model_raises_where_it_cannot_price():
    spec = ConvSpec(16, 16, dilation=(2, 2), padding=(2, 2))
    with pytest.raises(ValueError, match="dilated"):
        predict_conv_time(spec, 32, 32, ConvAlgorithm.IM2COL_GEMM)
    with pytest.raises(ValueError, match="dilated"):
        Planner(impl="torch", device="cpu", mode="model").plan(spec, 32, 32)
    with pytest.raises(ValueError, match="int8 Winograd"):
        predict_conv_time(ConvSpec(16, 16), 32, 32, ConvAlgorithm.WINOGRAD,
                          dtype_bytes=1)
    unfit = dataclasses.replace(H100, kernel_fit=H100.kernel_fit[1:])
    with pytest.raises(KeyError, match="no fit"):
        Planner(impl="torch", device="cpu", mode="model", hw=unfit).plan(
            ConvSpec(16, 16, (1, 1), padding=(0, 0)), 32, 32)


# ---------------------------------------------------------------------------
# 4. mode='model''s split on the four cells (plans only)

MODEL_PLANS = {
    ("yolov3-tiny 416 b1", "float32"): {
        0: "winograd_fused", 2: "winograd_fused", 4: "im2col_gemm",
        6: "winograd_3pass", 8: "im2col_gemm", 10: "im2col_gemm",
        12: "im2col_gemm", 13: "direct", 14: "im2col_gemm", 15: "direct",
        17: "direct", 20: "winograd_3pass", 21: "direct"},
    ("yolov3-tiny 416 b1", "int8"): {
        0: "winograd_fused", 2: "winograd_fused", 4: "im2col_gemm_int8",
        6: "im2col_gemm_int8", 8: "im2col_gemm_int8", 10: "im2col_gemm_int8",
        12: "im2col_gemm_int8", 13: "direct", 14: "im2col_gemm_int8",
        15: "direct", 17: "direct", 20: "im2col_gemm_int8", 21: "direct"},
    ("yolov3-tiny 416 b4", "float32"): {
        0: "winograd_fused", 2: "winograd_fused", 4: "winograd_fused",
        6: "winograd_3pass", 8: "winograd_3pass", 10: "winograd_3pass",
        12: "winograd_3pass", 13: "direct", 14: "winograd_3pass",
        15: "direct", 17: "direct", 20: "winograd_3pass", 21: "direct"},
    ("yolov3-tiny 416 b4", "int8"): {
        0: "winograd_fused", 2: "winograd_fused", 4: "im2col_gemm_int8",
        6: "im2col_gemm_int8", 8: "im2col_gemm_int8", 10: "im2col_gemm_int8",
        12: "im2col_gemm_int8", 13: "direct", 14: "im2col_gemm_int8",
        15: "direct", 17: "direct", 20: "im2col_gemm_int8", 21: "direct"},
    ("yolov3-20 608 b1", "float32"): {
        0: "im2col_gemm", 1: "im2col_gemm", 2: "direct", 3: "winograd_fused",
        5: "im2col_gemm", 6: "direct", 7: "winograd_3pass", 9: "direct",
        10: "winograd_3pass", 12: "im2col_gemm", 13: "direct",
        14: "winograd_3pass", 16: "direct", 17: "winograd_3pass",
        19: "direct"},
    ("yolov3-20 608 b1", "int8"): {
        0: "im2col_gemm", 1: "im2col_gemm", 2: "direct", 3: "winograd_fused",
        5: "im2col_gemm_int8", 6: "direct", 7: "im2col_gemm_int8",
        9: "direct", 10: "im2col_gemm_int8", 12: "im2col_gemm_int8",
        13: "direct", 14: "im2col_gemm_int8", 16: "direct",
        17: "im2col_gemm_int8", 19: "direct"},
    ("vgg16 224 b1", "float32"): {
        0: "im2col_gemm", 1: "winograd_fused", 3: "winograd_3pass",
        4: "winograd_3pass", 6: "winograd_3pass", 7: "winograd_3pass",
        8: "winograd_3pass", 10: "winograd_3pass", 11: "winograd_3pass",
        12: "winograd_3pass", 14: "im2col_gemm", 15: "im2col_gemm",
        16: "im2col_gemm"},
    ("vgg16 224 b1", "int8"): {
        0: "im2col_gemm", 1: "im2col_gemm_int8", 3: "im2col_gemm_int8",
        4: "im2col_gemm_int8", 6: "im2col_gemm_int8", 7: "im2col_gemm_int8",
        8: "im2col_gemm_int8", 10: "im2col_gemm_int8", 11: "im2col_gemm_int8",
        12: "im2col_gemm_int8", 14: "im2col_gemm_int8",
        15: "im2col_gemm_int8", 16: "im2col_gemm_int8"},
}


@pytest.mark.parametrize("cell,dtype", list(MODEL_PLANS),
                         ids=[f"{c} {d}" for c, d in MODEL_PLANS])
def test_model_mode_split(cell, dtype):
    model, batch = CELLS[cell]
    netplan = plan_network(model.layers, *model.input_hw,
                           Planner(impl="torch", device="cpu", mode="model"),
                           in_channels=model.in_channels, batch=batch,
                           dtype=dtype)
    steps = [s for s in netplan.steps if s.plan is not None]
    assert {s.index: s.plan.label for s in steps} == MODEL_PLANS[cell, dtype]
    for s in steps:
        assert s.plan.source == "cost_model" and s.plan.predicted_s > 0
        # The kept candidate is the cheapest the model priced.
        if dtype == "float32" and s.plan.algorithm is ConvAlgorithm.WINOGRAD:
            other = predict_conv_time(s.spec, *s.in_hw,
                                      ConvAlgorithm.IM2COL_GEMM, batch=batch)
            assert s.plan.predicted_s <= other


def test_model_mode_keeps_the_policy():
    """A forced realization is the only Winograd candidate."""
    model, batch = CELLS["vgg16 224 b1"]
    for policy in (True, False):
        netplan = plan_network(
            model.layers, *model.input_hw,
            Planner(impl="torch", device="cpu", mode="model",
                    winograd_fused=policy), batch=batch)
        assert {s.plan.winograd_fused for s in netplan.steps
                if s.plan is not None
                and s.plan.algorithm is ConvAlgorithm.WINOGRAD} == {policy}


# ---------------------------------------------------------------------------
# 5. Compiled with mode='model' on the CPU, against the reference


def _conv(ch, k=3, s=1, act="leaky"):
    return dict(kind="conv", out_channels=ch, kernel=k, stride=s,
                batch_norm=True, activation=act)


NARROW = {
    "tiny": [_conv(5), dict(kind="maxpool", size=2, stride=2), _conv(12),
             dict(kind="maxpool", size=2, stride=2), _conv(16), _conv(10, 1),
             dict(kind="route", from_layers=(4,)), _conv(9, 1),
             dict(kind="upsample", size=2), dict(kind="route",
                                                 from_layers=(8, 2)),
             _conv(18), _conv(21, 1, act="linear")],
    "layers20": [_conv(6), _conv(12, 3, 2), _conv(6, 1), _conv(12),
                 dict(kind="shortcut", from_layers=(1,)), _conv(20, 3, 2),
                 _conv(10, 1), _conv(20),
                 dict(kind="shortcut", from_layers=(5,))],
}


def test_holdout_refit_covers_every_cell():
    """scripts/cost_model_fit.py's leave-one-cell-out refit on the
    committed records: each cell is held out once, and the full fit's
    picks it reports are model mode's pinned plans."""
    import importlib.util
    import json
    import os

    scripts = os.path.join(os.path.dirname(__file__), "..", "scripts")
    spec = importlib.util.spec_from_file_location(
        "cost_model_fit", os.path.join(scripts, "cost_model_fit.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with open(os.path.join(scripts, "cost_model_records_h100.json")) as f:
        records = json.load(f)["records"]
    out = script.holdout(records, log=lambda _: None)
    assert list(out) == list(CELLS)
    for cell, res in out.items():
        assert res["kernels"]
        for dtype in ("float32", "int8"):
            assert res["picks"][dtype]
            for i, (_, full, _) in res["picks"][dtype].items():
                assert full == MODEL_PLANS[cell, dtype][i]
            assert res["ms"][dtype][2] <= min(res["ms"][dtype][:2])


@pytest.mark.parametrize("name,hw,batch", [("tiny", (256, 256), 1),
                                           ("layers20", (256, 232), 2)])
def test_model_mode_narrow_matches_reference(name, hw, batch):
    rows = NARROW[name]
    ours = repro_torch.CNNModel([CNNLayer(**r) for r in rows], hw, name=name)
    ref_model = repro.CNNModel([JCNNLayer(**r) for r in rows], hw, name=name)
    rng = np.random.default_rng(len(rows))
    params = random_batchnorm(init_cnn(rng, ours.layers), rng)
    x = rng.standard_normal((batch, *hw, 3)).astype(np.float32)
    compiled = repro_torch.compile(ours, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", mode="model", batch=batch))
    report = compiled.plan_report()
    assert report["mode"] == "model"
    assert all(r["source"] == "cost_model" for r in report["layers"])
    assert report["predicted_total_s"] == pytest.approx(
        sum(r["predicted_s"] for r in report["layers"]))
    assert ConvAlgorithm.WINOGRAD in compiled.network_plan().algorithm_counts()
    got = compiled.run(x).numpy()
    ref = np.asarray(repro.compile(ref_model, params, repro.ExecutionOptions(
        impl="jax", batch=batch, cache_path=None)).run(jnp.asarray(x)))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def vgg96():
    """VGG-16 at full width, 96x96: the model picks im2col and the 3-pass
    pipeline in fp32, and int8 on most layers."""
    model = repro_torch.CNNModel(vgg16.MODEL.layers, (96, 96), name="vgg16")
    rng = np.random.default_rng(96)
    params = init_cnn(rng, model.layers)
    x = rng.standard_normal((1, 96, 96, 3)).astype(np.float32)
    ref = repro.compile(jvgg16.MODEL.with_input_hw((96, 96)), params,
                        repro.ExecutionOptions(impl="jax", cache_path=None))
    return model, params, x, np.asarray(ref.run(jnp.asarray(x)))


def test_model_mode_vgg16_matches_reference(vgg96):
    model, params, x, ref = vgg96
    compiled = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", mode="model"))
    labels = {s.plan.label for s in compiled.network_plan().steps if s.plan}
    assert {"im2col_gemm", "winograd_3pass"} <= labels
    got = compiled.run(x).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_model_mode_int8_vgg16(vgg96):
    model, params, x, ref = vgg96
    compiled = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu", mode="model", dtype="int8"),
        calibration=x)
    rows = compiled.plan_report()["layers"]
    assert rows[0]["dtype"] == "float32"
    assert sum(r["dtype"] == "int8" for r in rows) >= 6
    assert all(r["source"] == "cost_model" for r in rows)
    got = compiled.run(x).numpy()
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert sqnr_db(ref, got) >= 30.0
    jq = repro.compile(jvgg16.MODEL.with_input_hw((96, 96)), params,
                       repro.ExecutionOptions(impl="jax", dtype="int8",
                                              cache_path=None),
                       calibration=jnp.asarray(x))
    assert sqnr_db(np.asarray(jq.run(jnp.asarray(x))), got) >= 30.0


def test_model_mode_options():
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                        mode="model")
    assert opts.make_planner().mode == "model"
    with pytest.raises(ValueError, match="mode"):
        Planner(impl="torch", device="cpu", mode="roofline")
    assert torch.device(opts.device).type == "cpu"

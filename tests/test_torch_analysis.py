"""The port's plan verifier (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

The reference's analysis runs only at its plan rung under this JAX (its
trace breaks on the ``BlockMapping`` of the installed Pallas), so the port
is held to it where it works and to the fault catalogue its tests define
(tests/test_analysis.py) everywhere else:

- (a) the option surface: ``ExecutionOptions(validate=...)`` takes and
  refuses what the reference's does, ``PlanVerificationError`` carries its
  report, and a report's JSON has the reference's keys;
- (b) the plan rung: on the same model and options both verifiers come out
  clean, and the port's conv steps that launch kernels are the
  reference's;
- (c) clean reports at every rung, in fp32, int8 and bf16, in cost and
  model mode, for every algorithm and realization the dispatcher runs, and
  for a two-stage pipeline;
- (d) one seeded fault per pass, each flagging its pass and no other;
- (e) under ``validate='off'`` a compiled forward and the launches it
  records are those of a compilation without the option.

Small sizes: YOLOv3-tiny at 64x64, VGG-16 at 32x32 and a five-layer chain
whose 12-channel output is padded to its consumer's multiple, batch 1-2,
weights from a numpy seed, ``impl='torch'`` (the wrappers record the
launches they would make and run their plain versions).  Every
comparison is exact: both sides count bytes and shared memory in
integers.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro
import repro_torch
from repro.analysis import report as jreport
from repro.analysis import step_descriptors as j_step_descriptors
from repro.analysis import verify_network as j_verify_network
from repro.configs import vgg16 as jvgg16
from repro.configs import yolov3 as jyolov3
from repro.core import netplan as jnetplan
from repro.core.planner import Planner as JPlanner
from repro_torch.analysis import (
    KERNEL_PASSES,
    LEVELS,
    PASSES,
    ChannelCensus,
    Finding,
    PlanVerificationError,
    PlannedLaunch,
    VerifyReport,
    dump_json,
    record_launches,
    step_descriptors,
    verify_network,
    verify_pipeline,
)
from repro_torch.analysis.passes import (
    accum_pass,
    bounds_pass,
    overflow_pass,
    race_pass,
)
from repro_torch.api.model import CNNModel
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm
from repro_torch.core.netplan import (
    Layout,
    build_network_plan,
    expected_channel_ops,
    plan_network,
    plan_pipeline,
    prepare_net_params,
)
from repro_torch.core.planner import ConvPlan, Planner, kernel_blocks
from repro_torch.hw import H100
from repro_torch.kernels._launch import Read, Write, flat_boxes, kernel_wrapper
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ops import gemm_launches
from repro_torch.kernels.im2col_gemm import ops as im2col_ops
from repro_torch.kernels.winograd import ops as winograd_ops
from repro_torch.models.cnn import CNNLayer, init_cnn, params_from_numpy

CASES = {"yolov3-tiny": (yolov3.TINY_LAYERS, (64, 64)),
         "vgg16": (vgg16.LAYERS, (32, 32))}
J_LAYERS = {"yolov3-tiny": jyolov3.TINY_LAYERS, "vgg16": jvgg16.LAYERS}
#: A chain whose first conv's 12 channels are padded to its consumer's
#: multiple: the zoo's channels are all multiples of 16, so only their
#: entry pads.
CHAIN = (CNNLayer("conv", 12, 3), CNNLayer("conv", 20, 3),
         CNNLayer("maxpool", size=2, stride=2), CNNLayer("conv", 24, 1),
         CNNLayer("conv", 16, 3))
ALL = set(PASSES) - {"pipeline"}


def _plan(layers, hw, dtype="float32", mode="cost", batch=1,
          winograd_fused=None):
    planner = Planner(impl="torch", mode=mode, device="cpu",
                      winograd_fused=winograd_fused)
    return plan_network(layers, *hw, planner, in_channels=3, batch=batch,
                        dtype=dtype)


def _params(layers, seed=0):
    return params_from_numpy(init_cnn(np.random.default_rng(seed), layers),
                             "cpu")


def _prepared(netplan, params=None):
    layers = [s.layer for s in netplan.steps]
    return prepare_net_params(netplan, params or _params(layers),
                              pretransform=True)


def _verify(netplan, level="full", params=None):
    return verify_network(netplan, _prepared(netplan, params), level=level)


def _rebuild(netplan, plans):
    return build_network_plan(
        [s.layer for s in netplan.steps], *netplan.input_hw, plans=plans,
        in_channels=netplan.in_channels, batch=netplan.batch,
        impl=netplan.impl, dtype=netplan.dtype)


def _with_mutated_plan(netplan, idx, **changes):
    """The netplan rebuilt with one step's ConvPlan changed, so the stored
    layouts stay consistent with it: the one defect is the injected one."""
    return _rebuild(netplan, [
        dataclasses.replace(s.plan, **changes) if s.index == idx else s.plan
        for s in netplan.steps])


def _replace_step(netplan, idx, **changes):
    steps = list(netplan.steps)
    steps[idx] = dataclasses.replace(steps[idx], **changes)
    return dataclasses.replace(netplan, steps=tuple(steps))


def _only_pass(report, pass_name):
    """The report is red, and every finding belongs to ``pass_name``."""
    assert not report.ok
    assert report.by_pass(pass_name), report.findings
    others = [f for f in report.findings if f.pass_name != pass_name]
    assert not others, others


def _interior(launches, pairs=None):
    report = VerifyReport(level="kernel", passes_run=KERNEL_PASSES)
    race_pass(report, launches)
    bounds_pass(report, launches)
    accum_pass(report, launches)
    overflow_pass(report, pairs if pairs is not None
                  else [(d, PlannedLaunch(d)) for d in launches])
    return report


# ---------------------------------------------------------------------------
# (a) The option surface and the report format


@pytest.mark.parametrize("value", ["off", "plan", "kernel", "full", "bogus",
                                   "", "FULL", None])
def test_validate_option_matches_reference(value):
    def accepts(make):
        try:
            make()
        except ValueError:
            return False
        return True

    ref = accepts(lambda: repro.ExecutionOptions(validate=value))
    port = accepts(lambda: repro_torch.ExecutionOptions(
        impl="torch", device="cpu", validate=value))
    assert port == ref
    if port:
        opts = repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                            validate=value)
        assert repro_torch.ExecutionOptions.from_json(opts.to_json()) == opts


def test_names_are_the_reference_ones():
    """The passes are the reference's with ``smem`` for ``vmem``; the
    levels and the kernel rung's passes are the reference's."""
    from repro.analysis import KERNEL_PASSES as J_KERNEL
    from repro.analysis import LEVELS as J_LEVELS

    assert PASSES == tuple("smem" if p == "vmem" else p
                           for p in jreport.PASSES)
    assert LEVELS == J_LEVELS and KERNEL_PASSES == J_KERNEL


def test_plan_verification_error_carries_its_report():
    report = verify_network(_plan(*CASES["vgg16"]), level="plan")
    err = PlanVerificationError(report)
    assert err.report is report and str(err) == report.summary()


def test_report_json_has_the_reference_keys():
    layers, hw = CASES["yolov3-tiny"]
    port = verify_network(_plan(layers, hw), level="plan")
    jnet = jnetplan.plan_network(J_LAYERS["yolov3-tiny"], *hw,
                                 JPlanner(impl="pallas", cache_path=None),
                                 in_channels=3)
    ref = j_verify_network(jnet, level="plan")
    port_json, ref_json = json.loads(dump_json(port)), json.loads(
        jreport.dump_json(ref))
    assert set(port_json) == set(ref_json)
    assert set(port_json["network"]) - {"smem_budget", "expected_launches"} \
        == set(ref_json["network"]) - {"vmem_budget", "expected_pallas_calls"}
    kw = dict(severity="error", message="m", step=3, kernel="k",
              expected=1.0, actual=2.0)
    assert Finding(pass_name="smem", **kw).to_json().keys() == \
        jreport.Finding(pass_name="vmem", **kw).to_json().keys()
    assert port.summary().split(":")[0] == ref.summary().split(":")[0]


# ---------------------------------------------------------------------------
# (b) The plan rung against the reference


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("model", list(CASES))
def test_plan_rung_agrees_with_reference(model, dtype):
    """Both verifiers find the same plans clean at the plan rung, and the
    port's conv steps that launch kernels are exactly the reference's that
    emit pallas_calls.  The expected channel ops follow each package's own
    layout rule (the reference crops to its 128 lanes, the port pads only
    to its kernels' channel multiples): printed side by side, not held
    equal."""
    layers, hw = CASES[model]
    port_net = _plan(layers, hw, dtype)
    jnet = jnetplan.plan_network(J_LAYERS[model], *hw,
                                 JPlanner(impl="pallas", cache_path=None),
                                 in_channels=3, dtype=dtype)
    ref = j_verify_network(jnet, level="plan")
    port = verify_network(port_net, level="plan")
    assert ref.clean and port.clean, (ref.findings, port.findings)
    assert port.passes_run == ("smem", "elision")
    assert [s.index for s in port_net.steps if step_descriptors(port_net, s)] \
        == [s.index for s in jnet.steps if j_step_descriptors(jnet, s)]
    print(f"{model} {dtype} expected channel ops: port "
          f"{expected_channel_ops(port_net)}; reference "
          f"{jnetplan.expected_channel_ops(jnet)}")
    assert {op["kind"] for op in expected_channel_ops(port_net)} <= {
        "pad", "cat"}


# ---------------------------------------------------------------------------
# (c) Clean reports


@pytest.mark.parametrize("mode", ["cost", "model"])
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("model", list(CASES))
def test_clean_plans_verify_clean(model, dtype, mode):
    """Full-level verification of a planned zoo network: every pass runs,
    no finding, a metric row a launch, each launch's shared memory within
    the budget and equal to the cost model's figure."""
    layers, hw = CASES[model]
    netplan = _plan(layers, hw, dtype, mode, batch=2 if mode == "cost" else 1)
    report = _verify(netplan)
    assert report.clean, report.summary()
    assert set(report.passes_run) == ALL
    assert len(report.kernels) == report.network["expected_launches"] > 0
    for row in report.kernels:
        assert row["smem_bytes"] <= row["smem_budget"] == \
            H100.smem_per_block_bytes
        assert row["smem_bytes"] == row["smem_model_bytes"]
        assert row["traffic_bytes"] == row["traffic_expected_bytes"]
    q8 = [r for r in report.kernels if "acc_bound" in r]
    assert bool(q8) == any(s.plan is not None and s.plan.dtype == "int8"
                           for s in netplan.steps)
    assert all(0 < r["acc_bound"] <= 2**31 - 1 for r in q8)


@pytest.mark.parametrize("level,passes", [
    ("plan", {"smem", "elision"}),
    ("kernel", {"structure", "race", "bounds", "accum", "overflow"})])
@pytest.mark.parametrize("model", list(CASES))
def test_plan_and_kernel_rungs_clean(model, level, passes):
    netplan = _plan(*CASES[model])
    report = (verify_network(netplan, level="plan") if level == "plan"
              else _verify(netplan, level=level))
    assert report.clean and set(report.passes_run) == passes
    assert report.level == level and report.kernels
    if level == "kernel":
        with pytest.raises(ValueError, match="parameter"):
            verify_network(netplan, level="kernel")


# Every algorithm and realization the dispatcher runs, by hand: (the
# conv's algorithm, Winograd realization, type, in channels, map size).
HAND = [
    (ConvAlgorithm.DIRECT, True, "float32", 256, 8),        # split + reduce
    (ConvAlgorithm.DIRECT, True, "int8", 256, 8),
    (ConvAlgorithm.DIRECT, True, "bfloat16", 256, 8),       # cluster split
    (ConvAlgorithm.DIRECT, True, "float16", 32, 32),        # persistent
    (ConvAlgorithm.IM2COL_GEMM, True, "float32", 64, 16),
    (ConvAlgorithm.IM2COL_GEMM, True, "int8", 256, 8),
    (ConvAlgorithm.IM2COL_GEMM, True, "bfloat16", 256, 8),
    (ConvAlgorithm.IM2COL_GEMM, True, "float16", 16, 24),
    (ConvAlgorithm.WINOGRAD, True, "float32", 64, 16),
    (ConvAlgorithm.WINOGRAD, True, "bfloat16", 256, 8),     # split + reduce
    (ConvAlgorithm.WINOGRAD, False, "float32", 64, 16),
    (ConvAlgorithm.WINOGRAD, False, "bfloat16", 32, 16),
    (ConvAlgorithm.WINOGRAD, False, "float16", 64, 8),
]


@pytest.mark.parametrize("algo,fused,dtype,cin,hw", HAND,
                         ids=[f"{a.value}-{'f' if f else '3p'}-{d}-{c}-{h}"
                              for a, f, d, c, h in HAND])
def test_each_algorithm_verifies_clean(algo, fused, dtype, cin, hw):
    """A stem and one conv planned by hand onto each kernel family,
    realization and type (splits, cluster sums and persistent grids
    included): the dispatch mirror of ``step_descriptors`` predicts the
    wrappers' launches exactly."""
    k = 1 if algo is ConvAlgorithm.DIRECT else 3
    layers = (CNNLayer("conv", cin, 3), CNNLayer("conv", 255, k))
    base = _plan(layers, (hw, hw), dtype, batch=2)
    spec = base.steps[1].spec
    plan = ConvPlan(algorithm=algo, impl="torch",
                    kernel_blocks=kernel_blocks(spec, algo, hw, hw, 2,
                                                fused, dtype),
                    winograd_fused=fused, dtype=dtype)
    netplan = _rebuild(base, [base.steps[0].plan, plan])
    report = _verify(netplan)
    assert report.clean, report.summary()
    kernels = [r["kernel"] for r in report.kernels if r["step"] == 1]
    from repro_torch.kernels.conv_ops import plan_kernels

    assert [k for k in kernels if not k.endswith("_reduce")] == \
        list(plan_kernels(netplan.steps[1].plan))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_pipeline_two_stages(dtype):
    """Plan and kernel rungs of a two-stage partition: each stage's
    forward recorded at microbatch size covers every planned conv step once
    and comes out clean; the kernel rung needs the prepared params."""
    layers, hw = CASES["yolov3-tiny"]
    planner = Planner(impl="torch", device="cpu")
    netplan = plan_network(layers, *hw, planner, in_channels=3, batch=2,
                           dtype=dtype)
    pipeplan = plan_pipeline(layers, *hw, planner, 2, in_channels=3, batch=2,
                             dtype=dtype, netplan=netplan)
    plan_report = verify_pipeline(netplan, pipeplan, name="yolov3-tiny")
    assert plan_report.clean and plan_report.passes_run == ("pipeline",)
    with pytest.raises(ValueError, match="parameter"):
        verify_pipeline(netplan, pipeplan, level="kernel")
    report = verify_pipeline(netplan, pipeplan, params=_prepared(netplan),
                             level="kernel")
    assert report.clean, report.summary()
    assert set(report.passes_run) == {"pipeline", "structure"} | set(
        KERNEL_PASSES)
    planned = {s.index for s in netplan.steps if s.layer.kind == "conv"}
    assert {row["step"] for row in report.kernels} == planned
    bad = dataclasses.replace(pipeplan, stage_bounds=((0, 3), (3, 22)))
    assert verify_pipeline(netplan, bad).by_pass("pipeline")


# ---------------------------------------------------------------------------
# (d) One seeded fault per pass


@pytest.mark.parametrize("model,mode", [("vgg16", "cost"),
                                        ("yolov3-tiny", "model")])
def test_oversized_block_flags_smem_only(model, mode):
    """An fp32 implicit-GEMM step whose plan declares 2048 out channels a
    block: its window and weight slice pass the card's shared memory and
    the cost model's figure; the smem pass, and only it, goes red at the
    plan rung (the wrapper itself refuses such a block)."""
    netplan = _plan(*CASES[model], mode=mode)
    idx = max(s.index for s in netplan.steps if s.layer.kind == "conv"
              and s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM)
    toh, bc, _ = netplan.steps[idx].plan.kernel_blocks
    mutated = _with_mutated_plan(netplan, idx, kernel_blocks=(toh, bc, 2048))
    report = verify_network(mutated, level="plan")
    _only_pass(report, "smem")
    assert any(f.step == idx and "budget" in f.message
               for f in report.by_pass("smem"))
    # Beyond the plan rung the forward itself refuses the block: one
    # structure finding, and no pass runs on launches that never were.
    report = _verify(mutated)
    _only_pass(report, "structure")
    assert "refused" in report.findings[0].message
    assert report.passes_run == ("structure",)


@pytest.mark.parametrize("model", list(CASES))
def test_wrong_dtype_flags_dtype_only(model):
    """An int8 step's declared type flipped to fp32 after its params were
    prepared: the int8 kernel runs under a plan that claims fp32.  The
    dtype pass pins it to the step; the byte passes stay quiet."""
    netplan = _plan(*CASES[model], dtype="int8")

    def flipped(s):
        return _replace_step(netplan, s.index, plan=dataclasses.replace(
            s.plan, dtype="float32"))

    # The first int8 step whose fp32 kernel would split as the int8 one
    # does: a step where the split counts differ adds a structure finding
    # (a reduce launch more or less) to the dtype one.
    idx = min(s.index for s in netplan.steps if s.layer.kind == "conv"
              and s.plan.dtype == "int8"
              and len(step_descriptors(netplan, s)) == len(
                  step_descriptors(flipped(s), flipped(s).steps[s.index])))
    prepared = _prepared(netplan)
    report = verify_network(flipped(netplan.steps[idx]), prepared)
    _only_pass(report, "dtype")
    assert any(f.step == idx for f in report.by_pass("dtype"))


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_forced_unelided_boundary_flags_elision_only(dtype):
    """A trivial out_layout forced where the layout rules keep the
    channels padded: the forward faithfully pads at the consumer (the
    census still meets the stored plan's prediction), but the decision
    check goes red against the rebuilt reference."""
    netplan = _plan(CHAIN, (32, 32), dtype)
    idx = min(s.index for s in netplan.steps
              if s.layer.kind == "conv" and s.out_layout.pad_c > 0)
    oc = netplan.steps[idx].spec.out_channels
    report = _verify(_replace_step(netplan, idx, out_layout=Layout(oc)))
    _only_pass(report, "elision")
    assert any(f.step == idx for f in report.by_pass("elision"))


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_bogus_layout_flags_traffic_only(dtype):
    """A boundary's physical channels doubled at the producer and its
    consumer: the plan stays executable and its decisions stand, but the
    launches move bytes the reference layouts never asked for."""
    netplan = _plan(CHAIN, (32, 32), dtype)
    convs = [s for s in netplan.steps if s.layer.kind == "conv"]
    src, dst = next((s.index, t.index) for s, t in zip(convs, convs[1:])
                    if s.out_layout.pad_c > 0
                    and t.in_layout.phys_c == s.out_layout.phys_c)
    oc = netplan.steps[src].spec.out_channels
    fat = Layout(oc, 2 * netplan.steps[src].out_layout.phys_c - oc)
    mutated = _replace_step(netplan, src, out_layout=fat)
    c = netplan.steps[dst].in_layout.c
    mutated = _replace_step(mutated, dst, in_layout=Layout(c, fat.phys_c - c))
    report = _verify(mutated)
    _only_pass(report, "traffic")
    assert any(f.step in (src, dst) for f in report.by_pass("traffic"))


def _split_gemm():
    main, reduce = gemm_launches(169, 256, 512)
    assert main.splits > 1 and reduce.kernel == "gemm_reduce"
    return main, reduce


def test_noninjective_tile_map_flags_race_only():
    """A GEMM whose blocks write row tile x + y: blocks (1, 0) and (0, 1)
    write the same tile and some rows are never written.  The boxes stay
    inside C, so bounds stays green."""
    (main,) = gemm_launches(5000, 255, 64)

    def broken(d):
        gx, gy, _ = d.grid
        for y in range(gy):
            for x in range(gx):
                r = min(x + y, gx - 1) * 64
                yield Write(x + gx * y, 0, "out", ((r, min(5000, r + 64)),
                                                   (y * 64,
                                                    min(255, y * 64 + 64))))

    report = _interior([dataclasses.replace(main, tile_map=broken)])
    _only_pass(report, "race")
    assert any("write element" in f.message for f in report.by_pass("race"))


def test_oob_window_flags_bounds_only():
    """A block's window of A shifted one tile down with no masking on the
    rows: the last row tile's window passes M.  The writes are untouched,
    so race stays green."""
    (main,) = gemm_launches(5000, 255, 64)
    shifted = lambda d: (Read(r.block, r.operand, ((r.box[0][0] + 64,  # noqa: E731
                                                    r.box[0][1] + 64),)
                              + r.box[1:], (1,)) if r.operand == "a" else r
                         for r in main.windows(d))
    report = _interior([dataclasses.replace(main, windows=shifted)])
    _only_pass(report, "bounds")
    f = report.by_pass("bounds")[0]
    assert "escapes" in f.message and f.actual > f.expected


def test_flipped_accumulate_order_flags_accum_only():
    """The reduce of a split GEMM summing its partials last split first."""
    main, reduce = _split_gemm()
    assert _interior([main, reduce]).clean
    flipped = dataclasses.replace(reduce,
                                  sum_order=tuple(reversed(reduce.sum_order)))
    report = _interior([main, flipped])
    _only_pass(report, "accum")
    assert any("split order" in f.message for f in report.by_pass("accum"))
    report = _interior([main])              # and a reduce that never comes
    _only_pass(report, "accum")


def test_overflow_shape_flags_overflow_only():
    """An int8 GEMM deep enough that K * 127^2 passes int32 (K = 133248 >
    floor((2^31 - 1) / 127^2)): the launches are sound, the bound is not.
    The wrapper itself refuses such a depth."""
    k = 133248
    launches = gemm_launches(8, 128, k, "int8")
    report = _interior(launches)
    _only_pass(report, "overflow")
    f = report.by_pass("overflow")[0]
    assert f.actual == k * 127 * 127 and f.actual > f.expected
    with pytest.raises(ValueError, match="overflow"):
        gemm_ops.matmul_q8_bias_act(
            torch.zeros((8, k), dtype=torch.int8),
            torch.zeros((k, 128), dtype=torch.int8), torch.ones(128),
            impl="torch")


def test_declared_k_drift_flags_overflow():
    """The plan declares a depth of 512, the launch sums 256."""
    recorded = gemm_launches(8, 128, 256, "int8")
    declared = gemm_launches(8, 128, 512, "int8")[0]
    report = _interior(recorded, [(recorded[0], PlannedLaunch(declared))])
    _only_pass(report, "overflow")
    assert report.by_pass("overflow")[0].expected == 512


# ---------------------------------------------------------------------------
# (e) The facade


def _model(name="yolov3-tiny"):
    layers, hw = CASES[name]
    return CNNModel(layers, hw, name=name)


def _input(batch, hw=(64, 64)):
    return np.random.default_rng(1).standard_normal(
        (batch, *hw, 3)).astype(np.float32)


def test_validate_off_changes_nothing(monkeypatch):
    """Under validate='off' (the default) no verification runs, and the
    forward and the launches it records equal those of a compilation
    without the option."""
    import repro_torch.analysis as analysis

    def refuse(*a, **k):
        raise AssertionError("verification ran under validate='off'")

    monkeypatch.setattr(analysis, "verify_network", refuse)
    monkeypatch.setattr(analysis, "verify_pipeline", refuse)
    params = init_cnn(np.random.default_rng(0), CASES["yolov3-tiny"][0])
    x = _input(2)
    runs = []
    for opts in (repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                              batch=2),
                 repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                              batch=2, validate="off")):
        compiled = repro_torch.compile(_model(), params, opts)
        with record_launches() as launches:
            y = compiled.run(x)
        runs.append((y, [d.to_json() for d in launches],
                     compiled.network_plan(2).kernel_launches()))
    (y0, l0, k0), (y1, l1, k1) = runs
    assert torch.equal(y0, y1) and l0 == l1 and k0 == k1 and l0


def test_validate_gates_every_executor():
    """validate='full' verifies each executor it builds (serving buckets
    included); a plan that fails raises PlanVerificationError and the
    executor is not kept; ``verify_report`` defaults to the full rung."""
    model = CNNModel(CHAIN, (32, 32), name="chain")
    params = init_cnn(np.random.default_rng(0), CHAIN)
    compiled = repro_torch.compile(model, params, repro_torch.
                                   ExecutionOptions(impl="torch",
                                                    device="cpu",
                                                    validate="full"))
    report = compiled.verify_report()
    assert report.clean and report.level == "full"
    assert compiled.verify_report(level="plan").level == "plan"
    engine = compiled.serve(buckets=(1, 2))
    assert engine is not None and 2 in compiled._executors
    netplan = compiled.network_plan(4)
    idx = min(s.index for s in netplan.steps if s.out_layout.pad_c > 0)
    compiled._netplans[4] = _replace_step(
        netplan, idx, out_layout=Layout(netplan.steps[idx].spec.out_channels))
    with pytest.raises(PlanVerificationError) as err:
        compiled.executor(4)
    assert err.value.report.by_pass("elision") and 4 not in compiled._executors


def test_pipeline_executor_is_gated():
    params = init_cnn(np.random.default_rng(0), CASES["yolov3-tiny"][0])
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu", batch=2,
                                        pipeline_stages=2, validate="kernel")
    compiled = repro_torch.compile(_model(), params, opts,
                                   devices=["cpu", "cpu"])
    assert compiled.run(_input(2)).shape[0] == 2
    pipe = compiled.pipeline_plan(4)
    compiled._pipeplans[4] = dataclasses.replace(
        pipe, stage_bounds=((0, 1), (1, len(compiled.network_plan(4).steps))))
    with pytest.raises(PlanVerificationError):
        compiled.pipeline_executor(4)
    assert 4 not in compiled._pipe_executors


def test_cli_on_the_cpu(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["yolov3-tiny", "--device", "cpu", "--input-hw", "64", "64",
                 "--dtype", "int8"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("verify[full] yolov3-tiny") and "smem" in out
    assert main(["vgg16", "--device", "cpu", "--input-hw", "32", "32",
                 "--level", "plan", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["clean"] is True


# ---------------------------------------------------------------------------
# The record side


def test_census_counts_channel_glue_outside_the_wrappers():
    """A channel pad, a channel crop and a channel concatenation count; a
    spatial pad, the max pool's -inf pad on its (B, C, H, W) view, and
    whatever a kernel wrapper does inside itself do not."""
    from repro_torch.core.netplan import _maxpool_same

    x = torch.randn(1, 6, 6, 5)

    @kernel_wrapper
    def wrapper(t):
        return F.pad(t, (0, 3))[..., :5]

    census = ChannelCensus()
    with census:
        F.pad(x, (0, 3))
        x[..., :2]
        torch.cat([x, x], dim=-1)
        F.pad(x, (0, 0, 1, 1, 1, 1))
        _maxpool_same(x, 2, 1)
        wrapper(x)
        torch.cat([x, x], dim=1)
    assert [op.kind for op in census.ops] == ["pad", "crop", "cat"]


@pytest.mark.parametrize("lo,hi,shape", [
    (0, 24, (2, 3, 4)), (5, 19, (2, 3, 4)), (3, 4, (2, 3, 4)),
    (4, 12, (2, 3, 4)), (0, 7, (7,)), (11, 23, (3, 8))])
def test_flat_boxes_hold_exactly_the_range(lo, hi, shape):
    counts = np.zeros(shape, dtype=np.int64)
    for box in flat_boxes(lo, hi, shape):
        counts[tuple(slice(a, b) for a, b in box)] += 1
    want = np.zeros(int(np.prod(shape)), dtype=np.int64)
    want[lo:hi] = 1
    assert np.array_equal(counts.reshape(-1), want)


@pytest.mark.parametrize("m,n,k", [(169, 256, 512), (8, 128, 4096),
                                   (5000, 255, 64)])
def test_descriptors_carry_the_wrappers_splits(m, n, k):
    """The split count a wrapper launches with is its descriptor's: the
    shape rule of each kernel (``call_splits``, ``call_splits_q8``,
    ``call_splits_16``), the fp32 and int8 ones with a reduce after."""
    fp32, q8, half = (gemm_launches(m, n, k, d)
                      for d in ("float32", "int8", "bfloat16"))
    assert fp32[0].splits == gemm_ops.call_splits(m, n, k)
    assert q8[0].splits == gemm_ops.call_splits_q8(m, n, k)
    assert half[0].splits == gemm_ops.call_splits_16(m, n, k)
    assert len(fp32) == 1 + (fp32[0].splits > 1) and len(half) == 1
    spec = dataclasses.replace(_plan(CHAIN, (32, 32)).steps[1].spec,
                               in_channels=n)
    (conv,) = im2col_ops.im2col_launches(1, 13, 13, n, 20, spec,
                                         dtype="bfloat16")
    assert conv.splits == im2col_ops.call_splits_16(1, 13, 13, n, 20)
    (wino,) = winograd_ops.winograd_launches(17, 64, 255, "float32")
    assert wino.splits == 1 and wino.k_ranges == ((0, 8),)

"""The 16-bit fused Winograd kernel's split of C and the 16-bit tuple
multiply's work items, on the CPU.

- The split rule (``kernels/winograd/ops.py::call_splits_16``): its ranges
  cover every 16-channel chunk, it never makes more splits than chunks,
  and it makes one where the grid already fills the card's 132 SMs.
- The plain version of the split path (each split's linear partial output
  A^T M_s A summed in the kernel's order, then bias and activation, one
  rounding) against the unsplit plain version and against the reference's
  ``fused_winograd_pallas`` in interpret mode, in bf16 and fp16, at the
  reference suite's 16-bit tolerance (tests/test_torch_cnn16.py).
- The kernels' shared memory and blocks a SM as the model prices them
  (``core/smem_model.py``), read from the CUDA sources.
- A plan cache file and a ``save`` artifact written with the tuple
  multiply's earlier tile (64, 32, 64) replan rather than hand it to the
  wrapper.
"""
import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels.winograd.kernel import fused_winograd_pallas
from repro_torch.core.codesign import conv_estimate
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.core.smem_model import (
    FUSED16_SMEM_BYTES,
    tuple16_resident,
    tuple16_smem_bytes,
)
from repro_torch.core.winograd import split_transformed, transform_weights
from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_ranges
from repro_torch.kernels.winograd.ops import (
    FUSED_BLOCKS_16,
    call_splits_16,
    three_pass_blocks_16,
)
from repro_torch.kernels.winograd.ref import (
    SPLIT_CHUNK_16,
    fused_winograd16_ref,
)
from repro_torch.models.cnn import init_cnn, random_batchnorm
from test_torch_slice import _models, _narrow_vgg16_3pass

DTYPES = ("bfloat16", "float16")
TOL = {"bfloat16": 2e-2, "float16": 5e-3}
# Two units of the last place at the largest output: the unsplit and the
# split plain versions round the same fp32 sums, summed in another order.
ULP2 = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}
CSRC = _build._KERNELS_DIR / "winograd" / "csrc"

# (T, C, O) of the fused calls of VGG-16 224 b1 (its seven Winograd layers,
# C padded to 8), YOLOv3-tiny 416 b1 and MODEL_20 608 b1, and small ones.
SHAPES = [(1444, 8, 64), (1444, 64, 64), (361, 64, 128), (361, 128, 128),
          (100, 128, 256), (100, 256, 256), (4900, 8, 16), (1225, 16, 32),
          (324, 32, 64), (81, 64, 128), (10404, 8, 32), (2601, 32, 64),
          (21, 16, 20), (7, 48, 40), (3, 256, 8)]


@pytest.mark.parametrize("t,c,o", SHAPES)
def test_fused16_split_rule(t, c, o):
    splits = call_splits_16(t, c, o)
    chunks = -(-c // SPLIT_CHUNK_16)
    assert 1 <= splits <= chunks
    ranges = split_ranges(chunks, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    bt, _, bo = FUSED_BLOCKS_16
    if -(-t // bt) * -(-o // bo) >= H100.sm_count:
        assert splits == 1


def test_fused16_split_rule_at_vgg16():
    """VGG-16's 56-block layers split in two (112 blocks on 132 SMs); the
    others, whose grids fill the card or would take a second wave, do
    not."""
    got = [call_splits_16(*s) for s in SHAPES[:6]]
    assert got == [1, 1, 1, 1, 2, 2]


def _operands(dtype, t, c, o, seed):
    rng = np.random.default_rng(seed)
    tiles = torch.from_numpy(rng.standard_normal((t, 8, 8, c)).astype(
        np.float32)).to(getattr(torch, dtype))
    w = rng.standard_normal((3, 3, c, o)).astype(np.float32) * (9 * c) ** -0.5
    u = transform_weights(torch.from_numpy(w))
    bias = rng.standard_normal(o).astype(np.float32)
    return tiles, u, split_transformed(u, getattr(torch, dtype)), bias


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("splits", [2, 3, 5])
def test_fused16_split_plain_equals_unsplit(dtype, splits):
    tiles, _, split, bias = _operands(dtype, 19, 80, 24, seed=splits)
    args = (tiles, split.hl, split.inv_scale, torch.from_numpy(bias), "leaky")
    whole = fused_winograd16_ref(*args).float()
    got = fused_winograd16_ref(*args, splits=splits)
    assert got.dtype == getattr(torch, dtype) and got.shape == whole.shape
    err = float((got.float() - whole).abs().max())
    assert err <= ULP2[dtype] * max(1.0, float(whole.abs().max())), err


def test_fused16_split_plain_refuses_more_splits_than_chunks():
    tiles, _, split, _ = _operands("bfloat16", 3, 32, 8, seed=0)
    with pytest.raises(ValueError, match="splits"):
        fused_winograd16_ref(tiles, split.hl, split.inv_scale, splits=3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,o,splits", [(21, 48, 20, 3), (10, 64, 16, 2)])
def test_fused16_split_plain_matches_pallas(dtype, t, c, o, splits):
    tiles, u, split, bias = _operands(dtype, t, c, o, seed=t)
    tp, op = -(-t // 8) * 8, -(-o // 8) * 8

    def pad(a, shape):
        return jnp.pad(a, [(0, s - d) for d, s in zip(a.shape, shape)])

    ref = fused_winograd_pallas(
        pad(jnp.asarray(tiles.float().numpy()).astype(getattr(jnp, dtype)),
            (tp, 8, 8, c)),
        pad(jnp.asarray(u.numpy()), (8, 8, c, op)), 8, 8, 8, interpret=True,
        bias=pad(jnp.asarray(bias), (op,))[None], activation="relu")
    ref = np.asarray(ref.astype(jnp.float32))[:t, ..., :o]
    got = fused_winograd16_ref(tiles, split.hl, split.inv_scale,
                               torch.from_numpy(bias), "relu", splits=splits)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= TOL[dtype] * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("o,n", [(8, 64), (64, 64), (65, 128), (128, 128),
                                 (200, 256), (256, 256), (512, 256)])
def test_tuple16_width_holds_all_of_o(o, n):
    assert three_pass_blocks_16(o) == (64, 64, n)


# ---------------------------------------------------------------------------
# The kernels' shared memory, as the CUDA sources declare it


def _constexprs(text: str) -> dict:
    """The file-scope ``constexpr int`` values of a source (and its
    integer #defines), evaluated in order."""
    env = {name: int(v) for name, v in
           re.findall(r"^#define (\w+) (\d+)$", text, re.MULTILINE)}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                 re.MULTILINE):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def test_fused16_smem_bytes_match_the_source():
    env = _constexprs((CSRC / "winograd_fused_16.cu").read_text())
    assert env["SMEM_BYTES"] == FUSED16_SMEM_BYTES <= H100.smem_per_block_bytes
    assert (env["BT"], env["BC"], env["BO"]) == FUSED_BLOCKS_16
    assert env["BC"] == SPLIT_CHUNK_16


def test_tuple16_blocks_a_sm_match_the_source():
    text = (CSRC / "winograd_3pass_16.cu").read_text()
    want = {int(n): int(r) for n, r in
            re.findall(r"TmTile<(\d+)>::RESIDENT == (\d+)", text)}
    assert want == {n: tuple16_resident(n) for n in (64, 128, 256)}
    for n in want:
        assert tuple16_smem_bytes(n) <= H100.smem_per_block_bytes


@pytest.mark.parametrize("spec,h,w,splits", [
    (ConvSpec(256, 256), 56, 56, 2), (ConvSpec(64, 64), 224, 224, 1)],
    ids=["split", "unsplit"])
def test_fused16_estimate_prices_the_reduce_of_a_split(spec, h, w, splits):
    est = conv_estimate(spec, h, w, ConvAlgorithm.WINOGRAD, dtype_bytes=2,
                        winograd_fused=True)
    kernels = [p.kernel for p in est.parts if p.kernel != "glue_16"]
    assert kernels == ["winograd_fused_16"] + (
        ["winograd_fused_16_reduce"] if splits > 1 else [])
    (fused,) = [p for p in est.parts if p.kernel == "winograd_fused_16"]
    assert fused.splits == splits


# ---------------------------------------------------------------------------
# Plans made with the tuple multiply's earlier tile replan

OLD_TILE = [64, 32, 64]


def _narrow_vgg(tmp_path):
    model, _ = _models(_narrow_vgg16_3pass(), (96, 96), "narrow")
    rng = np.random.default_rng(7)
    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    x = rng.standard_normal((2, 96, 96, 3)).astype(np.float32)
    opts = repro_torch.ExecutionOptions(
        impl="torch", device="cpu", dtype="bfloat16", winograd_fused=False,
        batch=2, cache_path=os.path.join(tmp_path, "plans.json"))
    return model, params, x, opts


def _age(plan: dict) -> bool:
    """Give a 16-bit 3-pass Winograd plan record the earlier tile."""
    if plan and plan["algorithm"] == "winograd" and not plan["winograd_fused"]:
        plan["kernel_blocks"] = list(OLD_TILE)
        return True
    return False


def _check_current(compiled):
    steps = [s for s in compiled.network_plan().steps if s.plan is not None]
    wino = [s for s in steps if s.plan.algorithm is ConvAlgorithm.WINOGRAD]
    assert wino and all(
        s.plan.kernel_blocks == three_pass_blocks_16(s.spec.out_channels)
        for s in wino)


def test_stale_tile_in_the_plan_cache_replans(tmp_path):
    model, params, x, opts = _narrow_vgg(tmp_path)
    first = repro_torch.compile(model, params, opts)
    y = first.run(x)
    first.save_plans()
    with open(opts.cache_path) as f:
        data = json.load(f)
    aged = sum(_age(p) for p in data["plans"].values())
    for entry in data["networks"].values():
        aged += sum(_age(s["plan"]) for s in entry["steps"])
    assert aged >= 4
    with open(opts.cache_path, "w") as f:
        json.dump(data, f)
    again = repro_torch.compile(model, params, opts)
    assert again.planner.network_hits == 0
    assert again.planner.stats["tunes"] >= 2
    _check_current(again)
    assert torch.equal(again.run(x), y)


def test_stale_tile_in_a_saved_artifact_replans(tmp_path):
    model, params, x, opts = _narrow_vgg(tmp_path)
    opts = dataclasses.replace(opts, cache_path=None)
    first = repro_torch.compile(model, params, opts)
    y = first.run(x)
    path = first.save(os.path.join(tmp_path, "narrow.json"))
    with open(path) as f:
        data = json.load(f)
    aged = sum(_age(s["plan"]) for entry in data["networks"].values()
               for s in entry["steps"])
    assert aged >= 2
    with open(path, "w") as f:
        json.dump(data, f)
    loaded = repro_torch.load(path, model, params)
    assert loaded.planner.network_hits == 0
    _check_current(loaded)
    assert torch.equal(loaded.run(x), y)


# ---------------------------------------------------------------------------
# chip_smoke.py's profile gate counts the reduce of every split call


@pytest.mark.parametrize("name,want", [("vgg16", 3), ("yolov3-tiny", 2),
                                       ("yolov3-20", 0)])
def test_planned_launches_count_the_fused16_reduce(name, want):
    import importlib.util
    import pathlib

    from repro_torch.configs import vgg16, yolov3
    from repro_torch.core.netplan import plan_network
    from repro_torch.core.planner import Planner

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = {"vgg16": vgg16.MODEL, "yolov3-tiny": yolov3.TINY_MODEL,
             "yolov3-20": yolov3.MODEL_20}[name]
    netplan = plan_network(model.layers, *model.input_hw,
                           Planner(impl="torch", device="cpu"),
                           in_channels=model.in_channels, batch=1,
                           dtype="bfloat16")
    planned = smoke.planned_cuda_launches(netplan)
    assert planned.get(smoke.WINOGRAD16_SPLIT_REDUCE, 0) == want
    fused = [s for s in netplan.steps if s.plan is not None
             and s.plan.algorithm is ConvAlgorithm.WINOGRAD]
    assert want == sum(call_splits_16(
        -(-s.out_hw[0] // 6) * -(-s.out_hw[1] // 6), s.in_layout.phys_c,
        s.spec.out_channels) > 1 for s in fused)

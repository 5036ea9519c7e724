"""The 16-bit GEMM and implicit-GEMM conv on wgmma, on the CPU.

- The split rule (``gemm/ops.py::call_splits_16``,
  ``im2col_gemm/ops.py::call_splits_16``) with its cluster cap: the ranges
  cover every chunk, there are never more splits than chunks or than the
  blocks of a cluster, and one where the grid already fills the card.
- The conv's pixel tiles (``pixel_tiles_16``) and windows
  (``conv16_geometry``), replayed as csrc/im2col_conv_16.cu computes them:
  every output pixel in exactly one tile, and every input pixel a tile's
  taps read inside the window its stage holds, at its window position, at
  stride 1 and 2.
- The 16-bit plain versions against the reference's ``matmul_pallas`` and
  ``conv2d_im2col_gemm_pallas`` in interpret mode, in bf16 and fp16: stride
  2, C = 8, O not a multiple of 64, and a GEMM with N = 255.
- The constants and the shared memory the planner and the model use, read
  from the CUDA sources.
- A plan cache file and a ``save`` artifact written with the 16-bit conv's
  earlier blocks (toh, 8, 64) replan rather than hand them to the wrapper.
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
from repro.kernels.gemm.kernel import matmul_pallas
from repro.kernels.im2col_gemm.kernel import conv2d_im2col_gemm_pallas
from repro.kernels.im2col_gemm.ops import pad_conv_operands
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.core.smem_model import BlockConfig, GemmShape, \
    predict_gemm, predict_im2col
from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_ranges
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ops import matmul16_bias_act
from repro_torch.kernels.im2col_gemm import ops as conv_ops
from repro_torch.kernels.im2col_gemm.ops import im2col_conv16
from repro_torch.models.cnn import init_cnn, random_batchnorm
from test_torch_slice import _models, _narrow_layers_20

DTYPES = ("bfloat16", "float16")
TOL = {"bfloat16": 2e-2, "float16": 5e-3}
GEMM_SRC = _build._KERNELS_DIR / "gemm" / "csrc" / "gemm_16.cu"
CONV_SRC = _build._KERNELS_DIR / "im2col_gemm" / "csrc" / "im2col_conv_16.cu"
WGMMA_SRC = _build._KERNELS_DIR / "csrc" / "wgmma16.cuh"
CELLS = {"yolov3-tiny 416": yolov3.TINY_MODEL, "yolov3-20 608": yolov3.MODEL_20,
         "vgg16 224": vgg16.MODEL}


def _calls(mode):
    """(kind, shape) of every 16-bit GEMM and im2col call of the three
    networks at batch 1 as ``mode`` plans them."""
    out = []
    for model in CELLS.values():
        plan = plan_network(model.layers, *model.input_hw,
                            Planner(impl="torch", device="cpu", mode=mode),
                            in_channels=model.in_channels, batch=1,
                            dtype="bfloat16")
        for s in plan.steps:
            if s.layer.kind != "conv":
                continue
            (h, w), (oh, ow) = s.in_hw, s.out_hw
            c, o = s.in_layout.phys_c, s.spec.out_channels
            if s.plan.algorithm is ConvAlgorithm.DIRECT:
                out.append(("gemm", (oh * ow, o, c)))
            elif s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM:
                out.append(("conv", (h, w, c, o, oh, ow, s.spec)))
    return out


CALLS = _calls("cost") + _calls("model")


def _const(src, name):
    """An int constant of a CUDA source: ``constexpr int NAME = v;``."""
    text = src.read_text()
    value = re.search(rf"constexpr int {name} = ([\d +]+);", text).group(1)
    return sum(int(v) for v in value.split("+"))


# ---------------------------------------------------------------------------
# The split rule with its cluster cap


def _split_case(kind, shape):
    if kind == "gemm":
        m, n, k = shape
        bm, bn, bk = gemm_ops.TILE_16
        return (gemm_ops.call_splits_16(m, n, k), -(-m // bm) * -(-n // bn),
                -(-k // bk), gemm_ops.RESIDENT_BLOCKS_16,
                gemm_ops.MAX_SPLITS_16)
    h, w, c, o, oh, ow, _ = shape
    grid = len(conv_ops.pixel_tiles_16(oh, ow)) * -(-o // conv_ops.BO_16)
    return (conv_ops.call_splits_16(1, oh, ow, c, o), grid,
            -(-c // conv_ops.CHUNK_16), conv_ops.RESIDENT_BLOCKS_16,
            conv_ops.MAX_SPLITS_16)


@pytest.mark.parametrize("kind,shape", CALLS + [
    ("gemm", (64, 64, 8)), ("gemm", (169, 255, 4096)),
    ("gemm", (100000, 512, 512)),
    ("conv", (7, 7, 4096, 64, 7, 7, ConvSpec(4096, 64))),
    ("conv", (224, 224, 64, 64, 224, 224, ConvSpec(64, 64))),
], ids=lambda v: str(v) if isinstance(v, str) else None)
def test_split_rule_covers_every_chunk_under_the_cluster_cap(kind, shape):
    splits, grid, chunks, resident, cap = _split_case(kind, shape)
    assert 1 <= splits <= min(chunks, cap)
    ranges = split_ranges(chunks, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if grid >= resident * H100.sm_count:
        assert splits == 1


def test_split_rule_prices_the_clusters_sum():
    """VGG-16's 14x14 convs fill few SMs, so they split to the cluster's
    cap; YOLOv3-tiny's 13x13 GEMMs split only where their K is deep enough
    to pay for the sum across the cluster (``SUM_STEPS_16``): 4 ways at K
    = 1024, 2 at 512, none at 256; MODEL_20's 608-wide conv fills the
    card unsplit."""
    assert conv_ops.call_splits_16(1, 14, 14, 512, 512) == \
        conv_ops.MAX_SPLITS_16
    assert conv_ops.call_splits_16(1, 304, 304, 32, 64) == 1
    got = [gemm_ops.call_splits_16(m, n, k) for m, n, k in (
        (169, 256, 1024), (169, 255, 512), (169, 128, 256), (676, 255, 256))]
    assert got == [4, 2, 1, 1]


# ---------------------------------------------------------------------------
# The conv's raster pixel tiles and their windows


def _windows(oh, ow, kh, kw, sh, sw, ph, pw):
    """Replay of the kernel's tile and window arithmetic (``tile_of``, the
    producer's boxes, the consumers' ``px0``): per tile, per pixel, its
    window pixel at tap (0, 0) and the top-left input pixel of its
    window segment, and the segment's first window pixel."""
    g = conv_ops.conv16_geometry(8, 64, oh, ow, kh, kw, sh, sw)
    bm, run = conv_ops.PIXELS_16, conv_ops.RUN_16
    rpr = -(-ow // run)
    tiles = []
    for pt in range(g["tiles_img"]):
        pix = []
        if g["raster"]:
            p0 = pt * bm
            oh_lo = p0 // ow
            seg = (oh_lo * sh - ph, -pw, 0)
            for p in range(p0, min(p0 + bm, oh * ow)):
                pix.append((p // ow, p % ow, (p // ow - oh_lo) * sh
                            * g["win_w"] + (p % ow) * sw, seg))
        else:
            for j in range(2):
                r = 2 * pt + j
                row, ow0 = r // rpr, (r % rpr) * run
                if row >= oh:
                    continue
                seg = (row * sh - ph, ow0 * sw - pw,
                       j * g["seg_h"] * g["win_w"])
                for k in range(min(run, ow - ow0)):
                    pix.append((row, ow0 + k, seg[2] + k * sw, seg))
        tiles.append(pix)
    return g, tiles


@pytest.mark.parametrize("h,w,k,s", [
    (14, 14, 3, 1), (13, 13, 3, 1), (26, 26, 3, 1), (28, 28, 3, 1),
    (112, 112, 3, 1), (224, 224, 3, 1), (19, 70, 3, 2), (608, 608, 3, 2),
    (152, 152, 3, 2), (9, 200, 3, 1), (11, 11, 5, 2), (5, 300, 1, 2),
    (3, 700, 3, 5),
])
def test_pixel_tiles_cover_the_map_and_windows_hold_every_tap(h, w, k, s):
    p = k // 2
    spec = ConvSpec(8, 64, (k, k), (s, s), (p, p))
    oh, ow = spec.out_hw(h, w)
    g, tiles = _windows(oh, ow, k, k, s, s, p, p)
    seen = [(r, c) for pix in tiles for r, c, _, _ in pix]
    assert sorted(seen) == [(r, c) for r in range(oh) for c in range(ow)]
    runs = conv_ops.pixel_tiles_16(oh, ow)
    assert [sum(n for _, _, n in t) for t in runs] == [len(t) for t in tiles]
    assert sorted((r, c + i) for t in runs for r, c, n in t
                  for i in range(n)) == sorted(seen)
    assert g["win_w"] % 8 == 0 and g["box_w"] <= conv_ops.MAX_BOX_16
    for pix in tiles:
        for r, c, px0, (ih0, iw0, base) in pix:
            for di in range(k):
                for dj in range(k):
                    wr = r * s - p + di - ih0
                    wc = c * s - p + dj - iw0
                    assert 0 <= wr < g["seg_h"] and 0 <= wc < g["win_w"]
                    assert (px0 + di * g["win_w"] + dj
                            == base + wr * g["win_w"] + wc)


# ---------------------------------------------------------------------------
# The 16-bit plain versions against the Pallas kernels


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    r = torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()
    return (jnp.asarray(r).astype(getattr(jnp, dtype)),
            torch.from_numpy(r).to(getattr(torch, dtype)))


def _check(got, ref, dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= TOL[dtype] * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,act", [(169, 255, 64, "linear"),
                                       (200, 72, 136, "leaky"),
                                       (64, 8, 8, "relu")])
def test_gemm16_plain_matches_matmul_pallas(dtype, m, n, k, act):
    rng = np.random.default_rng(1)
    (ja, a), (jb, b) = (_both(_np(rng, m, k), dtype),
                        _both(_np(rng, k, n, scale=k ** -0.5), dtype))
    bias = _np(rng, n)
    mp, np_, kp = -(-m // 8) * 8, -(-n // 128) * 128, -(-k // 128) * 128

    def pad(x, shape):
        return jnp.pad(x, [(0, s - d) for d, s in zip(x.shape, shape)])
    ref = matmul_pallas(pad(ja, (mp, kp)), pad(jb, (kp, np_)), 8, 128, 128,
                        interpret=True,
                        bias=pad(jnp.asarray(bias), (np_,))[None],
                        activation=act)
    got = matmul16_bias_act(a, b, torch.from_numpy(bias), act, impl="torch")
    _check(got, ref[:m, :n], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    dict(h=17, w=15, c=8, o=72, s=2, act="leaky"),
    dict(h=12, w=20, c=8, o=16, s=1, act="relu"),
    dict(h=9, w=9, c=40, o=80, s=1, act="linear"),
    dict(h=16, w=13, c=24, o=24, s=2, act="leaky"),
], ids=["s2-C8-O72", "C8", "O80", "s2-C24"])
def test_im2col16_plain_matches_conv_pallas(dtype, case):
    rng = np.random.default_rng(2)
    h, w, c, o, s = case["h"], case["w"], case["c"], case["o"], case["s"]
    spec = ConvSpec(c, o, (3, 3), (s, s))
    (jx, x), (jw, wt) = (_both(_np(rng, 1, h, w, c), dtype),
                         _both(_np(rng, 3, 3, c, o, scale=(9 * c) ** -0.5),
                               dtype))
    bias = _np(rng, o)
    from repro.core.conv_spec import ConvSpec as JConvSpec

    oh, ow = spec.out_hw(h, w)
    toh, bc, bo = 4, 8, 128
    x_p, w_p, bias_p = pad_conv_operands(
        jx, jw, JConvSpec(c, o, (3, 3), (s, s), (1, 1)), (toh, bc, bo),
        bias=jnp.asarray(bias))
    ref = conv2d_im2col_gemm_pallas(
        x_p, w_p, s, s, oh, ow, toh, bc, bo, interpret=True, bias=bias_p,
        activation=case["act"])
    got = im2col_conv16(x, wt, spec, conv_ops.pick_blocks(oh, ow, dtype),
                        torch.from_numpy(bias), case["act"], impl="torch")
    _check(got, ref[:, :oh, :, :o], dtype)


def test_im2col16_refuses_other_blocks():
    """A 16-bit call's blocks must be the 16-bit kernel's tile: the earlier
    row tile (toh, 8, 64) is refused, not run."""
    x = torch.zeros(1, 8, 8, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="blocks"):
        im2col_conv16(x, w, ConvSpec(8, 16), (8, 8, 64), impl="torch")


# ---------------------------------------------------------------------------
# The constants and shared memory, read from the sources


def test_gemm16_constants_match_the_source():
    assert gemm_ops.TILE_16 == tuple(_const(GEMM_SRC, n)
                                     for n in ("BM", "BN", "BK"))
    assert gemm_ops.RESIDENT_BLOCKS_16 == _const(GEMM_SRC, "MIN_BLOCKS")
    assert gemm_ops.MAX_SPLITS_16 == _const(GEMM_SRC, "MAX_SPLITS")
    assert gemm_ops.MAX_STAGES_16 == _const(GEMM_SRC, "MAX_STAGES")
    assert gemm_ops.RED_LD_16 == _const(WGMMA_SRC, "RED_LD")
    # The codesign sweep prices the same ring at the compiled tile.
    bm, bn, bk = gemm_ops.TILE_16
    assert BlockConfig(bm, bn, bk).smem_bytes(2) == (
        _const(GEMM_SRC, "MAX_STAGES") * (bm * bk + bk * bn) * 2)


def test_conv16_constants_match_the_source():
    assert (conv_ops.PIXELS_16, conv_ops.BO_16, conv_ops.CHUNK_16) == tuple(
        _const(CONV_SRC, n) for n in ("BM", "BN", "CK"))
    for name, src in (("RESIDENT_BLOCKS_16", "MIN_BLOCKS"),
                      ("MAX_SPLITS_16", "MAX_SPLITS"),
                      ("MAX_STAGES_16", "MAX_STAGES"),
                      ("MAX_SMEM_16", "MAX_SMEM"), ("MAX_BOX_16", "MAX_BOX")):
        assert getattr(conv_ops, name) == _const(CONV_SRC, src), name
    assert conv_ops.RED_LD_16 == _const(WGMMA_SRC, "RED_LD")


@pytest.mark.parametrize("m,n,k", [(92416, 32, 64), (23104, 64, 128),
                                   (5776, 128, 256), (169, 256, 1024),
                                   (169, 128, 256), (676, 255, 256)])
def test_gemm16_smem_is_what_the_model_prices(m, n, k):
    """The source's smem_bytes(stages_for(K, splits), splits): a 64 x 64 A
    box and B box (2 bytes a value) a stage, one stage a chunk of 64 of a
    split up to MAX_STAGES; the 64 x RED_LD fp32 partial after the ring
    (splits == 1) or over it; two mbarriers a stage of MAX_STAGES; 1 KB to
    align."""
    bm, bn, bk = (_const(GEMM_SRC, n) for n in ("BM", "BN", "BK"))
    most = _const(GEMM_SRC, "MAX_STAGES")
    splits = gemm_ops.call_splits_16(m, n, k)
    stages = max(1, min(most, -(-(-(-k // bk)) // splits)))
    ring = stages * (bm * bk + bk * bn) * 2
    red = bm * _const(WGMMA_SRC, "RED_LD") * 4
    want = ((ring + red if splits == 1 else max(ring, red))
            + 2 * most * 8 + 1024)
    assert gemm_ops.gemm16_smem_bytes(k, splits) == want
    est = predict_gemm(GemmShape(m, n, k), dtype_bytes=2)
    assert est.parts[0].smem_bytes == want and est.parts[0].splits == splits
    assert want + 1024 <= H100.smem_per_sm_bytes // gemm_ops.RESIDENT_BLOCKS_16


@pytest.mark.parametrize("kind,shape", [c for c in CALLS if c[0] == "conv"])
def test_conv16_smem_fits_and_is_what_the_model_prices(kind, shape):
    h, w, c, o, oh, ow, spec = shape
    splits = conv_ops.call_splits_16(1, oh, ow, c, o)
    g = conv_ops.conv16_geometry(c, o, oh, ow, spec.kh, spec.kw,
                                 *spec.stride, splits)
    assert g["stage_bytes"] % 1024 == 0 and g["w_bytes"] % 1024 == 0
    assert g["stage_bytes"] >= g["tx_bytes"]
    assert 1 <= g["stages"] <= min(conv_ops.MAX_STAGES_16,
                                   -(-(-(-c // conv_ops.CHUNK_16)) // splits))
    red = conv_ops.PIXELS_16 * conv_ops.RED_LD_16 * 4
    ring = g["stages"] * g["stage_bytes"]
    # The partial after the ring for persistent blocks, over it otherwise.
    assert (g["red_off"], g["bar_off"]) == (
        (ring, ring + red) if splits == 1 else (0, max(ring, red)))
    assert g["smem"] <= conv_ops.MAX_SMEM_16
    est = predict_im2col(spec, h, w, 1, c, o, dtype_bytes=2)
    (part,) = est.parts
    assert part.kernel == "im2col_conv_16" and part.smem_bytes == g["smem"]
    assert part.splits == conv_ops.call_splits_16(1, oh, ow, c, o)


# ---------------------------------------------------------------------------
# Plans made with the 16-bit conv's earlier blocks replan

OLD_BLOCKS = [4, 8, 64]


def _narrow_20(tmp_path):
    model, _ = _models(_narrow_layers_20(), (64, 56), "narrow")
    rng = np.random.default_rng(5)
    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    x = rng.standard_normal((1, 64, 56, 3)).astype(np.float32)
    opts = repro_torch.ExecutionOptions(
        impl="torch", device="cpu", dtype="bfloat16",
        cache_path=os.path.join(tmp_path, "plans.json"))
    return model, params, x, opts


def _age(plan: dict) -> bool:
    """Give a 16-bit im2col plan record the earlier blocks."""
    if plan and plan["algorithm"] == "im2col_gemm":
        plan["kernel_blocks"] = list(OLD_BLOCKS)
        return True
    return False


def _check_current(compiled):
    steps = [s for s in compiled.network_plan().steps if s.plan is not None]
    im2col = [s for s in steps
              if s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM]
    assert im2col and all(
        tuple(s.plan.kernel_blocks) == conv_ops.pick_blocks(
            *s.out_hw, "bfloat16") for s in im2col)


def test_old_conv16_blocks_in_the_plan_cache_replan(tmp_path):
    model, params, x, opts = _narrow_20(tmp_path)
    first = repro_torch.compile(model, params, opts)
    y = first.run(x)
    first.save_plans()
    with open(opts.cache_path) as f:
        data = json.load(f)
    aged = sum(_age(p) for p in data["plans"].values())
    for entry in data["networks"].values():
        aged += sum(_age(s["plan"]) for s in entry["steps"])
    assert aged >= 2
    with open(opts.cache_path, "w") as f:
        json.dump(data, f)
    again = repro_torch.compile(model, params, opts)
    assert again.planner.network_hits == 0
    assert again.planner.stats["tunes"] >= 1
    _check_current(again)
    assert torch.equal(again.run(x), y)


def test_old_conv16_blocks_in_a_saved_artifact_replan(tmp_path):
    model, params, x, opts = _narrow_20(tmp_path)
    opts = dataclasses.replace(opts, cache_path=None)
    first = repro_torch.compile(model, params, opts)
    y = first.run(x)
    path = first.save(os.path.join(tmp_path, "narrow.json"))
    with open(path) as f:
        data = json.load(f)
    aged = sum(_age(s["plan"]) for entry in data["networks"].values()
               for s in entry["steps"])
    assert aged >= 1
    with open(path, "w") as f:
        json.dump(data, f)
    loaded = repro_torch.load(path, model, params)
    assert loaded.planner.network_hits == 0
    _check_current(loaded)
    assert torch.equal(loaded.run(x), y)


# ---------------------------------------------------------------------------
# chip_smoke.py's profile gate: no reduce kernel for the 16-bit GEMM and
# im2col, whatever they split


@pytest.mark.parametrize("cell", list(CELLS))
def test_planned_launches_hold_no_16bit_gemm_or_im2col_reduce(cell):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = CELLS[cell]
    for mode in ("cost", "model"):
        netplan = plan_network(model.layers, *model.input_hw,
                               Planner(impl="torch", device="cpu", mode=mode),
                               in_channels=model.in_channels, batch=1,
                               dtype="bfloat16")
        planned = smoke.planned_cuda_launches(netplan)
        launches = netplan.kernel_launches()
        for kernel in ("gemm_16", "im2col_conv_16"):
            assert planned.get(smoke.CUDA_NAMES[kernel], 0) == \
                launches.get(kernel, 0)
        assert not any("16" in name and "splitk" in name for name in planned)
        assert all("splitk" not in name for name in smoke.REDUCE_NAMES
                   if "16" in name)


# ---------------------------------------------------------------------------
# A head's 16-bit GEMM weights keep rows TMA can read


@pytest.mark.parametrize("o", [255, 20, 64])
def test_16bit_gemm_weights_rows_are_padded_to_a_multiple_of_8(o):
    """The 16-bit GEMM reads B by TMA, whose row strides are 16-byte
    multiples: ``prepare_net_params`` keeps a 1x1 conv's weights with N %
    8 != 0 as a view of the first N columns of rows padded to a multiple
    of 8, once; the values are the plain rounding of the folded weights."""
    from repro_torch.core.netplan import prepare_net_params
    from repro_torch.models.cnn import params_from_numpy

    model, _ = _models([dict(kind="conv", out_channels=16),
                        dict(kind="conv", out_channels=o, kernel=1,
                             batch_norm=False, activation="linear")],
                       (8, 8), "head")
    rng = np.random.default_rng(3)
    params = params_from_numpy(init_cnn(rng, model.layers), "cpu")
    netplan = plan_network(model.layers, 8, 8,
                           Planner(impl="torch", device="cpu"),
                           in_channels=3, batch=1, dtype="bfloat16")
    head = netplan.steps[-1]
    assert head.plan.algorithm is ConvAlgorithm.DIRECT
    w = prepare_net_params(netplan, params)[-1]["w"]
    assert w.dtype == torch.bfloat16 and w.shape[-1] == o
    assert w.stride(-1) == 1 and w.stride(-2) == -(-o // 8) * 8
    want = params[-1]["w"].to(torch.bfloat16)
    assert torch.equal(w[..., :want.shape[2], :], want)


def _offset(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` one value past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.arange(n + 1, dtype=torch.float32).to(dtype)[1:].view(shape)


@pytest.mark.parametrize("make,kept", [
    (lambda: torch.ones(64, 64, dtype=torch.bfloat16), True),
    (lambda: torch.ones(3, 3, 8, 64, dtype=torch.float16), True),
    (lambda: gemm_ops.tma_rows16(torch.ones(64, 255, dtype=torch.bfloat16)),
     True),
    (lambda: gemm_ops.tma_rows16(torch.ones(3, 3, 8, 20,
                                            dtype=torch.float16)), True),
    (lambda: torch.ones(64, 255, dtype=torch.bfloat16), False),
    (lambda: torch.ones(1, 1, 512, 255, dtype=torch.bfloat16), False),
    (lambda: torch.ones(64, 72, dtype=torch.bfloat16).t(), False),
    (lambda: torch.ones(8, 3, 3, 64, dtype=torch.bfloat16).permute(1, 2, 0, 3),
     False),
    (lambda: _offset((64, 64)), False),
], ids=["gemm-64", "conv-64", "gemm-255-padded", "conv-20-padded",
        "gemm-255", "head-255", "transposed", "taps-apart", "misaligned"])
def test_tma_rows16_keeps_ready_layouts_and_pads_the_rest(make, kept):
    """The one layout both 16-bit kernels read weights in: rows a multiple
    of 8 values apart, the dimensions before them packed, 16-byte aligned.
    ``tma_rows16`` returns such a tensor itself and makes anything else
    so, with the same values; the row stride is what the wrappers pass."""
    w = make()
    got = gemm_ops.tma_rows16(w)
    assert (got is w) == kept
    assert torch.equal(got, w) and got.dtype == w.dtype
    assert got.stride(-1) == 1 and got.data_ptr() % 16 == 0
    ld = got.stride(-2)
    assert ld % 8 == 0 and ld >= got.shape[-1]
    assert ld < got.shape[-1] + 8
    step = ld * got.shape[-2]
    for d in range(got.dim() - 3, -1, -1):
        assert got.shape[d] == 1 or got.stride(d) == step
        step *= got.shape[d]
    assert gemm_ops.tma_rows16(got) is got


@pytest.mark.parametrize("mode", ["cost", "model"])
@pytest.mark.parametrize("o", [255, 20, 64])
def test_16bit_weights_of_every_gemm_and_im2col_step_keep_tma_rows(mode, o):
    """Every 16-bit weight the GEMM and the implicit-GEMM conv read
    (``prepare_net_params``) is in ``tma_rows16``'s layout already, so a
    forward pads nothing per call: a stride-2 3x3 conv (the im2col
    kernel) and a 1x1 head with O = ``o``."""
    from repro_torch.core.netplan import prepare_net_params
    from repro_torch.models.cnn import params_from_numpy

    model, _ = _models([dict(kind="conv", out_channels=o, stride=2),
                        dict(kind="conv", out_channels=o, kernel=1,
                             batch_norm=False, activation="linear")],
                       (16, 16), "head")
    rng = np.random.default_rng(4)
    params = params_from_numpy(init_cnn(rng, model.layers), "cpu")
    netplan = plan_network(model.layers, 16, 16,
                           Planner(impl="torch", device="cpu", mode=mode),
                           in_channels=3, batch=1, dtype="bfloat16")
    algos = [s.plan.algorithm for s in netplan.steps if s.layer.kind == "conv"]
    assert algos == [ConvAlgorithm.IM2COL_GEMM, ConvAlgorithm.DIRECT]
    prepared = prepare_net_params(netplan, params)
    for s, p in zip(netplan.steps, prepared):
        if s.layer.kind == "conv":
            assert p["w"].dtype == torch.bfloat16
            assert gemm_ops.tma_rows16(p["w"]) is p["w"], s.index

"""The fp32 implicit-GEMM conv's split-K plan, and the wrapper's refusals.

``split_k`` picks, from the shape alone, how many contiguous ranges of
the C / 8 channel chunks the CUDA kernel's reduction is cut into; the
kernel computes each split's range with ``split_ranges``' formula.  These
tests hold it at every fp32 im2col call of the four CNN cells the card
runs (YOLOv3-tiny 416 at batch 1 and 4, MODEL_20 608, VGG-16 224 with the
fused and the 3-pass Winograd kernels, and every conv measure mode could
send to im2col), and pin the fp32 plans the redesigned kernel must not
change.  They need neither a card nor nvcc.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.hw import H100
from repro_torch.kernels.im2col_gemm.ops import (
    BC,
    RESIDENT_BLOCKS,
    call_splits,
    grid_blocks,
    im2col_conv,
    split_k,
    split_ranges,
    tile_width,
)
from repro_torch.models.cnn import init_cnn

SLOTS = RESIDENT_BLOCKS * H100.sm_count


class _EveryConvIm2col(Planner):
    """Plans every conv as the implicit-GEMM conv: the calls measure mode
    could make, since im2col is a candidate of every conv."""

    def _tune_cost(self, spec, h, w, batch, dtype="float32"):
        return self._candidate(spec, ConvAlgorithm.IM2COL_GEMM, False, h, w,
                               batch, "measured", dtype=dtype)


CELLS = {
    "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, 1, Planner(impl="torch", device="cpu")),
    "yolov3-tiny 416 b4": (yolov3.TINY_MODEL, 4, Planner(impl="torch", device="cpu")),
    "yolov3-20 608 b1": (yolov3.MODEL_20, 1, Planner(impl="torch", device="cpu")),
    "vgg16 224 b1": (vgg16.MODEL, 1, Planner(impl="torch", device="cpu")),
    "vgg16 224 b1 winograd_fused=False": (
        vgg16.MODEL, 1, Planner(impl="torch", device="cpu", winograd_fused=False)),
    "vgg16 224 b1 mode=measure (any conv)": (
        vgg16.MODEL, 1, _EveryConvIm2col(impl="torch", device="cpu")),
}


def _im2col_calls(cell):
    """(label, batch, OH, OW, physical C, O, toh) of each fp32 im2col call."""
    model, batch, planner = CELLS[cell]
    netplan = plan_network(model.layers, *model.input_hw, planner,
                           in_channels=model.in_channels, batch=batch)
    return [(f"{cell} L{s.index}", batch, *s.out_hw, s.in_layout.phys_c,
             s.spec.out_channels, s.plan.kernel_blocks[0])
            for s in netplan.steps
            if s.layer.kind == "conv"
            and s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM]


@pytest.mark.parametrize("cell", list(CELLS))
def test_split_k_partitions_every_call(cell):
    calls = _im2col_calls(cell)
    assert calls
    for label, b, oh, ow, c, o, toh in calls:
        chunks = c // BC
        blocks = grid_blocks(b, oh, ow, o, toh)
        splits = call_splits(b, oh, ow, c, o, toh)
        assert splits == split_k(blocks, chunks)
        assert 1 <= splits <= chunks, label
        if blocks >= SLOTS:
            assert splits == 1, label
        else:
            # Split only as far as the card's block slots take the blocks.
            assert blocks * splits <= SLOTS or splits == 1, label
        ranges = split_ranges(chunks, splits)
        covered = [k for lo, hi in ranges for k in range(lo, hi)]
        assert covered == list(range(chunks)), label
        assert all(hi > lo for lo, hi in ranges), label


def test_split_k_at_yolov3_tiny_b1():
    """The deep layers of YOLOv3-tiny at batch 1 split, filling the slots;
    the same layers at batch 4 and MODEL_20's large maps do not."""
    def splits(cell):
        return {call[0].split()[-1]: call_splits(*call[1:])
                for call in _im2col_calls(cell)}

    assert splits("yolov3-tiny 416 b1") == {"L8": 4, "L10": 8, "L12": 4,
                                            "L14": 8, "L20": 5}
    assert set(splits("yolov3-20 608 b1").values()) == {1}
    # 256 blocks at batch 4: another split would start a second wave.
    assert splits("yolov3-tiny 416 b4")["L12"] == 1


@pytest.mark.parametrize("blocks,chunks,want", [
    (SLOTS, 64, 1), (10 * SLOTS, 3, 1), (1, 1, 1), (1, 7, 7), (100, 5, 2),
])
def test_split_k_edges(blocks, chunks, want):
    assert split_k(blocks, chunks) == want
    ranges = split_ranges(chunks, want)
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("chunks,splits", [(64, 5), (7, 3), (16, 16), (9, 1)])
def test_split_ranges_cover_chunks_not_divisible(chunks, splits):
    ranges = split_ranges(chunks, splits)
    assert len(ranges) == splits
    assert [k for lo, hi in ranges for k in range(lo, hi)] == list(range(chunks))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


def test_split_ranges_refuse_more_splits_than_chunks():
    with pytest.raises(ValueError, match="splits"):
        split_ranges(4, 5)
    with pytest.raises(ValueError, match="splits"):
        split_ranges(4, 0)


def test_grid_blocks_counts_tiles_channel_blocks_and_images():
    # 13x13 with 4-row tiles: 4 row tiles x 1 column tile x 16 channel
    # blocks of 64; OW > 64 takes 8x8 tiles with a ragged column tile.
    assert grid_blocks(1, 13, 13, 1024, 4) == 64
    assert grid_blocks(2, 13, 13, 1024, 4) == 128
    assert tile_width(8, 80) == 8
    assert grid_blocks(1, 9, 80, 16, 8) == 2 * 10


def test_wrapper_refuses_cpu_tensors_and_ragged_channels():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((1, 6, 6, 16)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((3, 3, 16, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        im2col_conv(x, w, ConvSpec(16, 4))
    x12, w12 = x[..., :12].contiguous(), w[:, :, :12].contiguous()
    for impl in ("cuda", "torch"):
        with pytest.raises(ValueError, match="multiple of 8"):
            im2col_conv(x12, w12, ConvSpec(12, 4), impl=impl)


# YOLOv3-tiny 416 b1's fp32 plan as it stood before the im2col kernel
# split its reduction: (index, algorithm, kernel_blocks, in_layout
# [logical C, pad]).  The split-K kernel keeps BC = 8 and the (toh, 8, 64)
# blocks, so none of it moves.  The fused Winograd layers carry that
# kernel's compiled tile (winograd/ops.py::FUSED_BLOCKS, 16 tiles x 32 out
# channels, in-channel steps of 8), whatever their shape.
TINY_416_B1_PLAN = [
    (0, "winograd", [16, 8, 32], [3, 5]),
    (2, "winograd", [16, 8, 32], [16, 0]),
    (4, "winograd", [16, 8, 32], [32, 0]),
    (6, "winograd", [16, 8, 32], [64, 0]),
    (8, "im2col_gemm", [2, 8, 64], [128, 0]),
    (10, "im2col_gemm", [4, 8, 64], [256, 0]),
    (12, "im2col_gemm", [4, 8, 64], [512, 0]),
    (13, "direct", [64, 64, 16], [1024, 0]),
    (14, "im2col_gemm", [4, 8, 64], [256, 0]),
    (15, "direct", [64, 64, 16], [512, 0]),
    (17, "direct", [64, 64, 16], [256, 0]),
    (20, "im2col_gemm", [2, 8, 64], [384, 0]),
    (21, "direct", [64, 64, 16], [256, 0]),
]


def test_yolov3_tiny_416_plan_unchanged():
    model = yolov3.TINY_MODEL
    params = init_cnn(np.random.default_rng(0), model.layers)
    compiled = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cpu"))
    report = compiled.plan_report()
    rows = [(r["index"], r["algorithm"], r["kernel_blocks"], r["in_layout"])
            for r in report["layers"]]
    assert rows == TINY_416_B1_PLAN
    assert all(r["dtype"] == "float32" for r in report["layers"])
    assert report["elided_boundaries"] == 0
    assert compiled.network_plan(1).kernel_launches() == {
        "winograd_fused": 4, "im2col_conv": 5, "gemm": 4}

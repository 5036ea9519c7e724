"""The int8 implicit-GEMM conv's split-K on the CPU: the split counts at
every int8 im2col call of the three int8 cells the card runs, the
resident-block count the rule reads from the kernel's launch bounds, and
the kernel's split arithmetic replayed in torch against the plain version
and the JAX package's Pallas int8 body.

The kernel (csrc/im2col_conv_q8.cu) sums chunks of ``CHUNK_Q8`` = 32
channels, all taps each, exactly in int32 on the tensor cores; split s of
n chunks takes the chunks ``split_ranges(n, splits)[s]``, and the reduce
kernel adds the int32 partials in split order before the fp32 epilogue
(float(acc) * scale, then + bias, each rounded on its own, then the
activation).  Integer sums are exact, so every split count gives the
plain version's output bit for bit; the replay here holds that.  The
kernel itself runs on the card (tests/test_torch_cuda.py).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.kernels.im2col_gemm.kernel import conv2d_im2col_gemm_pallas
from repro.kernels.im2col_gemm.ops import pad_conv_operands
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.core.im2col import im2col
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.hw import H100
from repro_torch.kernels import _build, _splitk
from repro_torch.kernels.im2col_gemm import ops as im2col_ops
from repro_torch.kernels.im2col_gemm.ops import (
    BC_Q8,
    CHUNK_Q8,
    RESIDENT_BLOCKS_Q8,
    call_splits_q8,
    grid_blocks,
    im2col_conv_q8,
    pick_blocks,
    split_ranges,
)
from repro_torch.kernels.im2col_gemm.ref import im2col_conv_q8_ref

SOURCE = (Path(im2col_ops.__file__).parent / "csrc" / "im2col_conv_q8.cu")
SLOTS = RESIDENT_BLOCKS_Q8 * H100.sm_count
RTOL = 1e-6          # tests/test_torch_int8.py's gate against the Pallas body

# (grid blocks before the split, chunks of 32 channels, splits) of every
# int8 im2col call of the three int8 plans at batch 1: the 13x13 and 26x26
# layers of YOLOv3-tiny and VGG-16's 28x28 and 14x14 layers split until
# their blocks fill the card's slots (2 a SM, 264); MODEL_20's large maps
# and VGG-16's 112x112 and 56x56 layers already do.
INT8_SPLITS = {
    "yolov3-tiny 416 b1 int8": {
        "L4": (169, 1, 1), "L6": (104, 2, 2), "L8": (52, 4, 4),
        "L10": (32, 8, 8), "L12": (64, 16, 4), "L14": (32, 8, 8),
        "L20": (52, 12, 4)},
    "vgg16 224 b1 int8": {
        "L3": (392, 2, 1), "L4": (392, 4, 1), "L6": (224, 4, 1),
        "L7": (224, 8, 1), "L8": (224, 8, 1), "L10": (112, 8, 2),
        "L11": (112, 16, 2), "L12": (112, 16, 2), "L14": (56, 16, 4),
        "L15": (56, 16, 4), "L16": (56, 16, 4)},
    "yolov3-20 608 b1 int8": {
        "L1": (1444, 1, 1), "L5": (722, 2, 1), "L7": (722, 2, 1),
        "L10": (722, 2, 1), "L12": (380, 4, 1), "L14": (380, 4, 1),
        "L17": (380, 4, 1)},
}
MODELS = {"yolov3-tiny 416 b1 int8": yolov3.TINY_MODEL,
          "vgg16 224 b1 int8": vgg16.MODEL,
          "yolov3-20 608 b1 int8": yolov3.MODEL_20}


def _int8_calls(cell):
    """label -> (batch, OH, OW, physical C, O, toh) of each int8 im2col
    call of the cell's int8 plan, as the executor hands them over."""
    model = MODELS[cell]
    netplan = plan_network(model.layers, *model.input_hw,
                           Planner(impl="torch", device="cpu"),
                           in_channels=model.in_channels, batch=1,
                           dtype="int8")
    return {f"L{s.index}": (1, *s.out_hw, s.in_layout.phys_c,
                            s.out_layout.phys_c, s.plan.kernel_blocks[0])
            for s in netplan.steps
            if s.layer.kind == "conv" and s.plan.dtype == "int8"
            and s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM}


@pytest.mark.parametrize("cell", list(INT8_SPLITS))
def test_int8_split_counts_at_the_cells(cell):
    calls = _int8_calls(cell)
    got = {label: (grid_blocks(b, oh, ow, o, toh), -(-c // CHUNK_Q8),
                   call_splits_q8(b, oh, ow, c, o, toh))
           for label, (b, oh, ow, c, o, toh) in calls.items()}
    assert got == INT8_SPLITS[cell]
    for label, (blocks, chunks, splits) in got.items():
        assert splits == _splitk.split_k(blocks, chunks, RESIDENT_BLOCKS_Q8)
        assert 1 <= splits <= chunks, label
        assert blocks * splits <= SLOTS or splits == 1, label
        covered = [k for lo, hi in split_ranges(chunks, splits)
                   for k in range(lo, hi)]
        assert covered == list(range(chunks)), label


def test_resident_blocks_q8_is_the_kernels_launch_bounds():
    """``RESIDENT_BLOCKS_Q8`` is the minimum the int8 kernel's
    ``__launch_bounds__`` asks of ptxas (its ``MIN_BLOCKS``)."""
    text = SOURCE.read_text()
    m = re.search(r"__launch_bounds__\(([^)]*)\)\s*\n\s*im2col_conv_q8_kernel\(",
                  text)
    assert m and m.group(1).replace(" ", "") == "THREADS,MIN_BLOCKS"
    min_blocks = int(re.search(r"constexpr int MIN_BLOCKS = (\d+);", text).group(1))
    chunk = int(re.search(r"constexpr int CK = (\d+);", text).group(1))
    assert RESIDENT_BLOCKS_Q8 == min_blocks
    assert CHUNK_Q8 == chunk and CHUNK_Q8 % BC_Q8 == 0
    # The tensor-core inner product, in the source or the shared s8 header
    # it includes, and no dp4a left.
    code = text + "".join(h.read_text()
                          for h in _build.included_headers(SOURCE))
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in code
    assert "__dp4a" not in code


@pytest.mark.parametrize("b,oh,ow,c,o,toh,want", [
    (1, 13, 13, 16, 64, 4, 1),        # one chunk (C = 16): nothing to split
    (1, 13, 13, 48, 64, 4, 2),        # C % 32 == 16: two chunks
    (1, 13, 13, 512, 1024, 4, 4),     # YOLOv3-tiny L12
    (4, 13, 13, 512, 1024, 4, 1),     # 256 blocks at batch 4: one wave
    (1, 152, 152, 64, 128, 8, 1),     # the grid fills the slots
])
def test_int8_split_k_edges(b, oh, ow, c, o, toh, want):
    assert call_splits_q8(b, oh, ow, c, o, toh) == want


# ---------------------------------------------------------------------------
# The split arithmetic, replayed


def _replay(x, w, spec, scale, bias, act, splits):
    """The kernel's sums: int32 partials over chunks of 32 channels (all
    taps) for each split's chunk range, added in split order, then the
    epilogue as the kernels round it."""
    b, h, ww, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = spec.out_hw(h, ww)
    patches = im2col(x.to(torch.int64), spec.kernel_size, spec.stride,
                     spec.padding, spec.dilation).reshape(-1, kh * kw, c)
    wt = w.to(torch.int64).reshape(kh * kw, c, o)
    chunks = -(-c // CHUNK_Q8)
    acc = torch.zeros((patches.shape[0], o), dtype=torch.int32)
    for lo, hi in split_ranges(chunks, splits):
        cs = slice(lo * CHUNK_Q8, min(hi * CHUNK_Q8, c))
        partial = torch.einsum("mtc,tco->mo", patches[:, :, cs], wt[:, cs])
        assert partial.abs().max() < 2 ** 31
        acc = acc + partial.to(torch.int32)
    v = acc.to(torch.float32) * scale
    if bias is not None:
        v = v + bias
    if act == "leaky":
        v = torch.where(v > 0, v, 0.1 * v)
    elif act == "relu":
        v = torch.clamp_min(v, 0)
    return v.reshape(b, oh, ow, o)


@pytest.mark.parametrize("stride,c,o,act", [
    (1, 48, 20, "leaky"),     # C % 32 == 16: the last chunk half zero
    (2, 64, 9, "relu"),       # stride 2, ragged O
    (1, 96, 36, "linear"),    # three chunks
])
def test_split_k_replay_is_exact(stride, c, o, act):
    """Every split count the kernel could take gives the plain version bit
    for bit, and the Pallas int8 body (interpret mode) within its gate."""
    rng = np.random.default_rng(stride * 100 + c + o)
    b, h, w = 2, 11, 9
    x = rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    wt = rng.integers(-127, 128, (3, 3, c, o)).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, o) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    spec = ConvSpec(c, o, (3, 3), (stride, stride), (1, 1))
    tx, tw, ts, tb = (torch.from_numpy(v) for v in (x, wt, scale, bias))
    ref = im2col_conv_q8_ref(tx, tw, spec, ts, tb, act)
    for splits in range(1, -(-c // CHUNK_Q8) + 1):
        got = _replay(tx, tw, spec, ts, tb, act, splits)
        assert torch.equal(got, ref), splits
    assert torch.equal(_replay(tx, tw, spec, ts, None, act, 2 if c > 32 else 1),
                       im2col_conv_q8_ref(tx, tw, spec, ts, None, act))
    # The wrapper's plain route is the same function.
    assert torch.equal(im2col_conv_q8(tx, tw, spec, ts, bias=tb, activation=act,
                                      impl="torch"), ref)

    jspec = JConvSpec(c, o, (3, 3), (stride, stride), (1, 1))
    oh, ow = jspec.out_hw(h, w)
    toh, bc, bo = 4, BC_Q8, 128
    x_p, w_p, bias_p = pad_conv_operands(jnp.asarray(x), jnp.asarray(wt), jspec,
                                         (toh, bc, bo), bias=jnp.asarray(bias))
    pallas = np.asarray(conv2d_im2col_gemm_pallas(
        x_p, w_p, stride, stride, oh, ow, toh, bc, bo, interpret=True,
        bias=bias_p, activation=act,
        scale=jnp.asarray(np.pad(scale, (0, bo - o)))[None]))[:, :oh, :, :o]
    got = _replay(tx, tw, spec, ts, tb, act, -(-c // CHUNK_Q8)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(pallas).max())))


def test_int8_wrapper_takes_the_plans_tile_and_refuses_cpu_tensors():
    """The plan's (toh, BC_Q8, BO) tuple passes the wrapper's checks; a CPU
    tensor with impl='cuda' raises, never falls back."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 13, 13, 32)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (3, 3, 32, 8)).astype(np.int8))
    scale = torch.full((8,), 1e-3)
    spec = ConvSpec(32, 8, (3, 3), (1, 1), (1, 1))
    blocks = pick_blocks(13, 13, "int8")
    assert blocks[1:] == (BC_Q8, 64)
    out = im2col_conv_q8(x, wt, spec, scale, blocks, impl="torch")
    assert torch.equal(out, im2col_conv_q8_ref(x, wt, spec, scale))
    with pytest.raises(ValueError, match="CUDA tensors"):
        im2col_conv_q8(x, wt, spec, scale, blocks)

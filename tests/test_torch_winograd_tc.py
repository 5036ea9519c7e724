"""The fused Winograd kernel on the tensor cores (winograd/csrc/
winograd_fused.cu), on the CPU: its arithmetic replayed in numpy against
the JAX package's fused Pallas kernel, its compiled tile, and the plans
that carry it.

The kernel transforms each chunk of 8 channels as B^T d B (rows, then
columns, with BT's zeros and symmetric row pairs taken out), runs the 64
per-position products M[p] += V[p] . U[p] as three TF32 products per fp32
product (lo.hi, hi.lo, hi.hi into one fp32 accumulator, k8 steps), and
applies A^T M A (columns, then rows, AT's symmetric pairs taken out),
bias and the activation once, after the last chunk.
The replay follows that order (the products by scripts/tf32x3_replay.py,
the 3-pass tuple multiply's replay) and is held at the kernel's own gate,
5e-4 of max(1, max|ref|) (chip_smoke.py's KERNEL_TOL).  The kernel
itself runs on the card (tests/test_torch_cuda.py).
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.winograd import transform_weights as j_transform_weights
from repro.kernels.winograd.kernel import fused_winograd_pallas
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.core.winograd import AT, BT
from repro_torch.kernels import _build
from repro_torch.kernels.winograd import ops as winograd_ops
from repro_torch.kernels.winograd.ops import (
    FUSED_BLOCKS,
    THREE_PASS_BLOCKS,
    fused_winograd,
    pick_blocks,
)
from repro_torch.kernels.winograd.ref import fused_winograd_ref

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "tf32x3_replay", REPO / "scripts" / "tf32x3_replay.py")
replay_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(replay_mod)

SOURCE = Path(winograd_ops.__file__).parent / "csrc" / "winograd_fused.cu"
GATE = 5e-4


def _f32(x):
    return np.asarray(x, np.float32)


def _fma(a, b, c):
    """fmaf: one rounding of the exact a * b + c."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


def _bt8(d):
    """B^T along the last axis as the kernel computes it (bt8), every step
    but the fmaf in fp32."""
    d = [d[..., j].astype(np.float32) for j in range(8)]
    fma = _fma
    r = [None] * 8
    r[0] = fma(5.25, d[4] - d[2], d[0] - d[6])
    r[7] = fma(5.25, d[3] - d[5], d[7] - d[1])
    a1, b1 = fma(-4.25, d[4], d[2] + d[6]), fma(-4.25, d[3], d[1] + d[5])
    r[1], r[2] = a1 + b1, a1 - b1
    a3 = fma(0.25, d[2], fma(-1.25, d[4], d[6]))
    b3 = fma(0.5, d[1], fma(-2.5, d[3], _f32(2 * d[5])))
    r[3], r[4] = a3 + b3, a3 - b3
    a5 = fma(4.0, d[2], fma(-5.0, d[4], d[6]))
    b5 = fma(2.0, d[1], fma(-2.5, d[3], _f32(0.5 * d[5])))
    r[5], r[6] = a5 + b5, a5 - b5
    return np.stack(r, axis=-1)


def _at8(m):
    """A^T along the last axis as the kernel computes it (at8)."""
    m = [m[..., a].astype(np.float32) for a in range(8)]
    s12, d12 = m[1] + m[2], m[1] - m[2]
    s34, d34 = m[3] + m[4], m[3] - m[4]
    s56, d56 = m[5] + m[6], m[5] - m[6]
    return np.stack([
        m[0] + s12 + s34 + s56,
        _fma(2.0, d34, _fma(0.5, d56, d12)),
        _fma(4.0, s34, _fma(0.25, s56, s12)),
        _fma(8.0, d34, _fma(0.125, d56, d12)),
        _fma(16.0, s34, _fma(0.0625, s56, s12)),
        _fma(32.0, d34, _fma(0.03125, d56, d12)) + m[7],
    ], axis=-1)


def replay(tiles, u, bias, act, terms=3):
    """(T, 8, 8, C) x (8, 8, C, O) -> (T, 6, 6, O) with the fused kernel's
    arithmetic; ``terms`` as scripts/tf32x3_replay.py (1: plain TF32)."""
    t, _, _, c = tiles.shape
    o = u.shape[-1]
    d = np.moveaxis(tiles.astype(np.float32), 3, 1)          # (T, C, i, j)
    rows = _bt8(d)                                           # (T, C, i, b)
    v = np.swapaxes(_bt8(np.swapaxes(rows, 2, 3)), 2, 3)     # (T, C, a, b)
    v = np.moveaxis(v.reshape(t, c, 64), 2, 0)               # (64, T, C)
    m = np.stack([replay_mod.replay(v[p], u.reshape(64, c, o)[p], terms)
                  for p in range(64)])                       # (64, T, O)
    m = m.reshape(8, 8, t, o).transpose(2, 3, 1, 0)          # (T, O, b, a)
    cols = _at8(m)                                           # (T, O, b, x)
    y = _at8(np.swapaxes(cols, 2, 3))                        # (T, O, x, y)
    y = y.transpose(0, 2, 3, 1) + bias
    return np.where(y > 0, y, np.float32(0.1) * y) if act == "leaky" else y


@pytest.mark.parametrize("t,c,o,real_c", [
    (21, 16, 20, 16),      # two chunks; T and O not block multiples
    (21, 8, 20, 3),        # a first layer: 3 channels padded to 8
])
def test_replay_matches_fused_winograd_pallas(t, c, o, real_c):
    rng = np.random.default_rng(t + c + o + real_c)
    tiles = rng.standard_normal((t, 8, 8, c)).astype(np.float32)
    w3 = rng.standard_normal((3, 3, c, o)).astype(np.float32)
    tiles[..., real_c:] = 0.0
    w3[:, :, real_c:] = 0.0
    bias = rng.standard_normal(o).astype(np.float32)
    u = np.array(j_transform_weights(jnp.asarray(w3)))
    bt, bc, bo = 8, 8, 8
    tp, op = -(-t // bt) * bt, -(-o // bo) * bo
    ref = np.asarray(fused_winograd_pallas(
        jnp.asarray(np.pad(tiles, ((0, tp - t), (0, 0), (0, 0), (0, 0)))),
        jnp.asarray(np.pad(u, ((0, 0), (0, 0), (0, 0), (0, op - o)))),
        bt, bc, bo, interpret=True,
        bias=jnp.asarray(np.pad(bias, (0, op - o)))[None], activation="leaky",
    ))[:t, ..., :o]
    scale = max(1.0, float(np.abs(ref).max()))
    err = {terms: float(np.abs(replay(tiles, u, bias, "leaky", terms) - ref).max())
           / scale for terms in (3, 1)}
    assert err[3] <= GATE
    # Three TF32 products keep fp32's accuracy; one does not.
    assert err[3] < 1e-5 < err[1]
    # The plain version (the CPU route of the wrapper) agrees too.
    plain = fused_winograd(torch.from_numpy(tiles), torch.from_numpy(u),
                           bias=torch.from_numpy(bias), activation="leaky",
                           impl="torch").numpy()
    assert float(np.abs(plain - ref).max()) / scale <= GATE


@pytest.mark.parametrize("name", ["bt8", "at8"])
def test_sparse_transforms_are_bt_and_at(name):
    """The kernel's bt8 and at8 (zeros and symmetric row pairs taken out)
    compute B^T d and A^T m to fp32 rounding."""
    d = np.random.default_rng(4).standard_normal((1000, 8)).astype(np.float32)
    fn, mat = {"bt8": (_bt8, BT), "at8": (_at8, AT)}[name]
    dense = d.astype(np.float64) @ mat.T
    np.testing.assert_allclose(fn(d), dense, rtol=0,
                               atol=1e-5 * np.abs(dense).max())


def test_pick_blocks_is_the_kernels_compiled_tile():
    text = SOURCE.read_text()
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
              for k in ("BT", "BO", "BC", "THREADS")}
    assert FUSED_BLOCKS == (consts["BT"], consts["BC"], consts["BO"])
    assert consts["BT"] * consts["BO"] == consts["THREADS"]
    assert winograd_ops.BC == consts["BC"]
    for t, c, o in ((4900, 8, 16), (169, 128, 256), (1, 8, 1000)):
        assert pick_blocks(t, c, o) == FUSED_BLOCKS
        assert pick_blocks(t, c, o, fused=False) == THREE_PASS_BLOCKS
    # The products run on the shared 3xTF32 helpers; no CUDA-core FMA loop
    # over U is left.
    assert "tc::mma_tf32" in text and "tc::split_tf32" in text
    assert "__ldg(u" not in text
    header = _build._KERNELS_DIR / _build.SHARED_INCLUDE / "sgemm_3xtf32.cuh"
    assert header in _build.included_headers(SOURCE)


def test_wrapper_takes_the_compiled_tile_only():
    rng = np.random.default_rng(5)
    tiles = torch.from_numpy(rng.standard_normal((5, 8, 8, 8)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((8, 8, 8, 12)).astype(np.float32))
    ref = fused_winograd_ref(tiles, u)
    for blocks in (None, pick_blocks(5, 8, 12), FUSED_BLOCKS):
        assert torch.equal(fused_winograd(tiles, u, blocks, impl="torch"), ref)
    for blocks in ((4, 8, 64), (16, 8, 16), (16, 16, 32)):
        with pytest.raises(ValueError, match="compiled tile"):
            fused_winograd(tiles, u, blocks, impl="torch")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_winograd(tiles, u)


# The fused Winograd layers of the three fp32 cells the card runs: the
# cost-mode planner's choice, unchanged, each with the compiled tile.
FUSED_LAYERS = {
    "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, [0, 2, 4, 6]),
    "yolov3-20 608 b1": (yolov3.MODEL_20, [0, 3, 7, 10, 14, 17]),
    "vgg16 224 b1": (vgg16.MODEL, [0, 1, 3, 4, 6, 7, 8]),
}


@pytest.mark.parametrize("cell", list(FUSED_LAYERS))
def test_fused_plans_carry_the_compiled_tile(cell):
    model, layers = FUSED_LAYERS[cell]
    netplan = plan_network(model.layers, *model.input_hw,
                           Planner(impl="torch", device="cpu"),
                           in_channels=model.in_channels, batch=1)
    steps = [s for s in netplan.steps if s.layer.kind == "conv"
             and s.plan.algorithm is ConvAlgorithm.WINOGRAD]
    assert [s.index for s in steps] == layers
    for s in steps:
        assert s.plan.winograd_fused is True
        assert s.plan.kernel_blocks == FUSED_BLOCKS
        assert s.in_layout.phys_c % FUSED_BLOCKS[1] == 0

"""The fp32 tensor-core GEMM core (kernels/csrc/sgemm_3xtf32.cuh) on the CPU:
the split-K plan of the GEMM that uses it, its arithmetic replayed in numpy
(scripts/tf32x3_replay.py) against the JAX package's Pallas kernels, and
the build digest that must follow the shared header.

The kernels themselves need the card (tests/test_torch_cuda.py); nothing
here needs nvcc.  The plans the GEMM's tile enters are pinned unchanged in
tests/test_torch_splitk.py, tests/test_torch_int8.py and
tests/test_torch_slice.py.
"""
import importlib.util
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.gemm.kernel import matmul_pallas
from repro.kernels.winograd.kernel import tuple_multiply_pallas
from repro_torch.configs import yolov3
from repro_torch.core.conv_spec import ConvAlgorithm
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.hw import H100
from repro_torch.kernels import _build, _splitk
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.im2col_gemm import ops as im2col_ops

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "tf32x3_replay", REPO / "scripts" / "tf32x3_replay.py")
replay_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(replay_mod)

GATE = 1e-4          # chip_smoke.py's KERNEL_TOL for both kernels


# ---------------------------------------------------------------------------
# Split-K of the GEMM


def _gemm_calls(model, batch):
    """{"L<i>": (M, K, N)} of each fp32 GEMM call of the planned forward."""
    netplan = plan_network(model.layers, *model.input_hw,
                           Planner(impl="torch", device="cpu"),
                           in_channels=model.in_channels, batch=batch)
    return {f"L{s.index}": (batch * s.out_hw[0] * s.out_hw[1],
                            s.in_layout.phys_c, s.out_layout.phys_c)
            for s in netplan.steps
            if s.layer.kind == "conv"
            and s.plan.algorithm is ConvAlgorithm.DIRECT}


# The rule over 4 resident blocks a SM (528 slots): the batch-1 heads of
# YOLOv3-tiny split until their 6 to 44 tiles fill the slots; MODEL_20's
# 1444- and 361-tile calls do not split, its 182-tile ones split in two.
GEMM_SPLITS = {
    ("yolov3-tiny 416", 1): {"L13": ((169, 1024, 256), 32),
                             "L15": ((169, 512, 255), 32),
                             "L17": ((169, 256, 128), 16),
                             "L21": ((676, 256, 255), 8)},
    ("yolov3-tiny 416", 4): {"L13": ((676, 1024, 256), 11),
                             "L15": ((676, 512, 255), 11),
                             "L17": ((676, 256, 128), 16),
                             "L21": ((2704, 256, 255), 3)},
    ("yolov3-20 608", 1): {"L2": ((92416, 64, 32), 1),
                           "L6": ((23104, 128, 64), 1),
                           "L9": ((23104, 128, 64), 1),
                           "L13": ((5776, 256, 128), 2),
                           "L16": ((5776, 256, 128), 2),
                           "L19": ((5776, 256, 128), 2)},
}
MODELS = {"yolov3-tiny 416": yolov3.TINY_MODEL, "yolov3-20 608": yolov3.MODEL_20}


@pytest.mark.parametrize("cell", list(GEMM_SPLITS),
                         ids=[f"{n} b{b}" for n, b in GEMM_SPLITS])
def test_gemm_split_counts_at_the_cells(cell):
    name, batch = cell
    got = {label: ((m, k, n), gemm_ops.call_splits(m, n, k))
           for label, (m, k, n) in _gemm_calls(MODELS[name], batch).items()}
    assert got == GEMM_SPLITS[cell]
    slots = gemm_ops.RESIDENT_BLOCKS * H100.sm_count
    for label, ((m, k, n), splits) in got.items():
        chunks = -(-k // gemm_ops.TILE[2])
        tiles = -(-m // 64) * -(-n // 64)
        assert 1 <= splits <= chunks, label
        assert tiles * splits <= slots or splits == 1, label
        covered = [c for lo, hi in _splitk.split_ranges(chunks, splits)
                   for c in range(lo, hi)]
        assert covered == list(range(chunks)), label


def test_split_k_is_one_function_for_both_wrappers():
    assert gemm_ops.split_k is im2col_ops.split_k is _splitk.split_k
    assert im2col_ops.split_ranges is _splitk.split_ranges
    # Each wrapper counts its own kernel's resident blocks.
    assert gemm_ops.call_splits(169, 256, 1024) == _splitk.split_k(12, 64, 4)
    assert im2col_ops.call_splits(1, 13, 13, 512, 1024, 4) == \
        _splitk.split_k(64, 64, 2)


def _launch_bounds_min_blocks(source: Path, kernel: str) -> str:
    text = source.read_text()
    m = re.search(r"__launch_bounds__\(([^)]*)\)\s*\n\s*" + kernel + r"\(", text)
    assert m, (source, kernel)
    return m.group(1).split(",")[1].strip()


def test_resident_blocks_are_the_kernels_launch_bounds():
    """``RESIDENT_BLOCKS`` of each wrapper is the minimum its kernel's
    ``__launch_bounds__`` asks of ptxas."""
    kernels = REPO / "src" / "repro_torch" / "kernels"
    core = (kernels / "csrc" / "sgemm_3xtf32.cuh").read_text()
    min_blocks = int(re.search(r"constexpr int MIN_BLOCKS = (\d+);", core).group(1))
    assert gemm_ops.RESIDENT_BLOCKS == min_blocks
    assert _launch_bounds_min_blocks(kernels / "gemm" / "csrc" / "gemm.cu",
                                     "gemm_bias_act_kernel") == "tc::MIN_BLOCKS"
    assert _launch_bounds_min_blocks(
        kernels / "winograd" / "csrc" / "winograd_3pass.cu",
        "winograd_tuple_multiply_kernel") == "sgemm_tc::MIN_BLOCKS"
    assert _launch_bounds_min_blocks(
        kernels / "im2col_gemm" / "csrc" / "im2col_conv.cu",
        "im2col_conv_kernel") == str(im2col_ops.RESIDENT_BLOCKS)


@pytest.mark.parametrize("m,n,k,want", [
    (64, 64, 16, 1),          # one chunk: nothing to split
    (64, 64, 0, 1),           # K = 0
    (64 * 528, 64, 4096, 1),  # the grid fills the slots
    (70, 100, 37, 3),         # 4 tiles, 3 chunks: one chunk each
])
def test_gemm_split_k_edges(m, n, k, want):
    assert gemm_ops.call_splits(m, n, k) == want


# ---------------------------------------------------------------------------
# The 3xTF32 arithmetic


def test_tf32_rounds_ties_away_from_zero():
    tf32 = replay_mod.tf32
    ulp = 2.0 ** -10
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
                  0.0], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + ulp, -(1 + ulp), 1, 1 + ulp, 0], np.float32))
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi, lo = replay_mod.split(v)
    assert np.array_equal(tf32(hi), hi) and np.array_equal(tf32(lo), lo)
    assert np.all(np.abs(hi.astype(np.float64) + lo - v) <= 2.0 ** -22 * np.abs(v))


@pytest.mark.parametrize("m,k,n", [(64, 256, 64), (37, 512, 70), (16, 1024, 48)])
def test_tf32x3_holds_the_gate_and_plain_tf32_does_not(m, k, n):
    """The kernel's arithmetic stays two orders of magnitude inside the
    1e-4 gate; dropping a correction term, or both, fails it."""
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    err = {t: replay_mod.rel_error(replay_mod.replay(a, b, t), a, b)
           for t in (3, 2, 1)}
    assert err[3] < 1e-5
    assert err[2] > GATE and err[1] > GATE


def test_tf32x3_replay_matches_matmul_pallas():
    """The replayed GEMM against the reference's Pallas GEMM (interpret
    mode), bias and activation as the kernel's epilogue adds them."""
    rng = np.random.default_rng(1)
    m, k, n = 40, 256, 100
    a, b = (rng.standard_normal(s).astype(np.float32) for s in ((m, k), (k, n)))
    bias = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(matmul_pallas(
        jnp.asarray(a), jnp.asarray(np.pad(b, ((0, 0), (0, 28)))), 8, 128, 128,
        interpret=True, bias=jnp.asarray(np.pad(bias, (0, 28)))[None],
        activation="leaky"))[:, :n]
    for terms, ok in ((3, True), (1, False)):
        y = replay_mod.replay(a, b, terms) + bias
        y = np.where(y > 0, y, np.float32(0.1) * y)
        err = np.abs(y - ref).max() / max(1.0, np.abs(ref).max())
        assert (err <= GATE) == ok, (terms, err)
        if ok:
            assert err < 1e-5


def test_tf32x3_replay_matches_tuple_multiply_pallas():
    """The replay at each of the 64 Winograd positions against the
    reference's tuple multiply (interpret mode)."""
    rng = np.random.default_rng(2)
    t, c, o = 16, 256, 24
    v = rng.standard_normal((64, t, c)).astype(np.float32)
    u = rng.standard_normal((64, c, o)).astype(np.float32)
    ref = np.asarray(tuple_multiply_pallas(
        jnp.asarray(v), jnp.asarray(np.pad(u, ((0, 0), (0, 0), (0, 128 - o)))),
        16, 128, 128, interpret=True))[:, :, :o]
    got = np.stack([replay_mod.replay(v[p], u[p]) for p in range(64)])
    assert np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) < 1e-5


# ---------------------------------------------------------------------------
# The build digest


@pytest.mark.parametrize("header,users", [
    ("csrc/sgemm_3xtf32.cuh", {"gemm", "winograd_3pass", "winograd_fused",
                               "flash_attention", "flash_attention_bwd"}),
    ("winograd/csrc/winograd_transforms.cuh", {"winograd_fused", "winograd_3pass"}),
    ("flash_attention/csrc/flash_attention_bf16.cuh", {"flash_attention"}),
    ("flash_attention/csrc/flash_attention_fp32.cuh", {"flash_attention"}),
    ("flash_attention/csrc/flash_common.cuh", {"flash_attention",
                                               "flash_attention_bwd"}),
    ("flash_attention/csrc/flash_attention_bwd_bf16.cuh", {"flash_attention_bwd"}),
    ("flash_attention/csrc/flash_attention_bwd_fp32.cuh", {"flash_attention_bwd"}),
    ("csrc/hmma16.cuh", {"gemm_16", "im2col_conv_16", "winograd_fused_16",
                         "winograd_3pass_16", "flash_attention_bwd"}),
    ("csrc/s8_mma.cuh", {"gemm_q8", "im2col_conv_q8"}),
])
def test_library_path_follows_every_included_header(tmp_path, monkeypatch,
                                                    header, users):
    """Editing a header changes the library path of exactly the sources
    that include it, the shared directory's header included."""
    copy = tmp_path / "kernels"
    shutil.copytree(_build._KERNELS_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "_KERNELS_DIR", copy)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(copy / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == users


def test_nvcc_sees_the_shared_include_directory():
    flags = list(_build.NVCC_FLAGS)
    assert flags[flags.index("-I") + 1] == _build.SHARED_INCLUDE
    shared = _build._KERNELS_DIR / _build.SHARED_INCLUDE
    assert (shared / "sgemm_3xtf32.cuh").is_file()
    for name in ("gemm", "winograd_3pass", "winograd_fused"):
        src = _build._KERNELS_DIR / _build.SOURCES[name]
        assert shared / "sgemm_3xtf32.cuh" in _build.included_headers(src)

"""The int8 GEMM on the tensor cores (gemm/csrc/gemm_q8.cu), on the CPU:
its arithmetic replayed in torch against the plain version and the JAX
package's Pallas int8 body, the split counts at every int8 GEMM call of
the three int8 cells the card runs, the tile and resident-block count the
wrapper reads from the source, and the wrapper's refusals.

The kernel sums chunks of ``CHUNK_Q8`` = 32 of K exactly in int32
(s8 ``mma.sync``, four chunks a staged 128-byte line); split s of n chunks
takes the chunks ``split_ranges(n, splits)[s]``, and the reduce kernel
adds the int32 partials in split order before the fp32 epilogue
(float(acc) * scale, then + bias, each rounded on its own, then the
activation).  Integer sums are exact, so every split count gives the
plain version's output bit for bit.  The Pallas body sums in int32 too
and equals it bit for bit without a bias; with one, XLA contracts its
product and bias add into one fused multiply-add on the CPU, one rounding
fewer, so there it is held at tests/test_torch_int8.py's 1e-6 (1 ulp,
observed).  The kernel itself runs on the card (tests/test_torch_cuda.py).
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm.kernel import matmul_pallas
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm, apply_activation
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.hw import H100
from repro_torch.kernels import _build, _splitk
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ops import (
    CHUNK_Q8,
    K_MULTIPLE_Q8,
    RESIDENT_BLOCKS_Q8,
    TILES_Q8,
    call_splits_q8,
    matmul_q8_bias_act,
    tile_q8,
)
from repro_torch.kernels.gemm.ref import matmul_q8_ref

SOURCE = Path(gemm_ops.__file__).parent / "csrc" / "gemm_q8.cu"
HEADER = _build._KERNELS_DIR / _build.SHARED_INCLUDE / "s8_mma.cuh"
REPO = Path(__file__).resolve().parents[1]
SLOTS = RESIDENT_BLOCKS_Q8 * H100.sm_count
RTOL = 1e-6          # tests/test_torch_int8.py's gate against the Pallas body

# ((M, K, N), tile, blocks before the split, chunks of 32, splits) of every
# int8 GEMM call of the three int8 plans at batch 1: YOLOv3-tiny's 169-row
# calls split until their blocks fill the card's slots (2 a SM, 264);
# MODEL_20's large-M calls already fill them (its N = 32 layer on the
# 128 x 32 tile); VGG-16's int8 plan has no 1x1 conv.
INT8_GEMM_SPLITS = {
    "yolov3-tiny 416 b1 int8": {
        "L13": ((169, 1024, 256), (64, 64), 12, 32, 16),
        "L15": ((169, 512, 255), (64, 64), 12, 16, 16),
        "L17": ((169, 256, 128), (64, 64), 6, 8, 8)},
    "vgg16 224 b1 int8": {},
    "yolov3-20 608 b1 int8": {
        "L2": ((92416, 64, 32), (128, 32), 722, 2, 1),
        "L6": ((23104, 128, 64), (64, 64), 361, 4, 1),
        "L9": ((23104, 128, 64), (64, 64), 361, 4, 1),
        "L13": ((5776, 256, 128), (64, 64), 182, 8, 1),
        "L16": ((5776, 256, 128), (64, 64), 182, 8, 1),
        "L19": ((5776, 256, 128), (64, 64), 182, 8, 1)},
}
MODELS = {"yolov3-tiny 416 b1 int8": yolov3.TINY_MODEL,
          "vgg16 224 b1 int8": vgg16.MODEL,
          "yolov3-20 608 b1 int8": yolov3.MODEL_20}


def _int8_plan(cell):
    model = MODELS[cell]
    return plan_network(model.layers, *model.input_hw,
                        Planner(impl="torch", device="cpu"),
                        in_channels=model.in_channels, batch=1, dtype="int8")


def _gemm_calls(netplan):
    """label -> (M, K, N) of each int8 GEMM call, as the executor hands
    it over: M the output pixels, K and N the physical channels."""
    return {f"L{s.index}": (netplan.batch * s.out_hw[0] * s.out_hw[1],
                            s.in_layout.phys_c, s.out_layout.phys_c)
            for s in netplan.steps
            if s.layer.kind == "conv" and s.plan.dtype == "int8"
            and s.plan.algorithm is ConvAlgorithm.DIRECT}


@pytest.mark.parametrize("cell", list(INT8_GEMM_SPLITS))
def test_int8_gemm_split_counts_at_the_cells(cell):
    got = {}
    for label, (m, k, n) in _gemm_calls(_int8_plan(cell)).items():
        bm, bn = tile_q8(n)
        got[label] = ((m, k, n), (bm, bn), -(-m // bm) * -(-n // bn),
                      -(-k // CHUNK_Q8), call_splits_q8(m, n, k))
    assert got == INT8_GEMM_SPLITS[cell]
    for label, (_, _, blocks, chunks, splits) in got.items():
        assert splits == _splitk.split_k(blocks, chunks, RESIDENT_BLOCKS_Q8)
        assert 1 <= splits <= chunks, label
        assert blocks * splits <= SLOTS or splits == 1, label
        covered = [c for lo, hi in _splitk.split_ranges(chunks, splits)
                   for c in range(lo, hi)]
        assert covered == list(range(chunks)), label


@pytest.mark.parametrize("m,n,k,want", [
    (169, 256, 16, 1),        # one chunk (K = 16): nothing to split
    (169, 256, 48, 2),        # K % 32 == 16: two chunks
    (4 * 169, 256, 1024, 6),  # batch 4: 44 tiles, 6 x 44 = 264 blocks
    (100, 20, 160, 5),        # N <= 32: one 128 x 32 tile, 5 chunks
    (92416, 32, 64, 1),       # the grid fills the slots
])
def test_int8_gemm_split_k_edges(m, n, k, want):
    assert call_splits_q8(m, n, k) == want


@pytest.mark.parametrize("n,tile", [(1, (128, 32)), (32, (128, 32)),
                                    (33, (64, 64)), (255, (64, 64))])
def test_tile_from_n(n, tile):
    """The 128 x 32 tile up to N = 32, the 64 x 64 one above."""
    assert tile_q8(n) == tile


def test_source_matches_the_wrapper():
    """``RESIDENT_BLOCKS_Q8`` is the minimum the kernel's
    ``__launch_bounds__`` asks of ptxas, ``CHUNK_Q8`` its k32 step,
    ``TILES_Q8`` its two compiled tiles (16·WM x 32·(8/WM), WM = 4 for bn
    64 and 8 for bn 32); the products are s8 mma.sync, in the source or the
    shared header it includes, and no dp4a is left."""
    text = SOURCE.read_text()
    m = re.search(r"__launch_bounds__\(([^)]*)\)\s*\n\s*gemm_q8_bias_act_kernel\(",
                  text)
    assert m and m.group(1).replace(" ", "") == "THREADS,MIN_BLOCKS"
    min_blocks = int(re.search(r"constexpr int MIN_BLOCKS = (\d+);", text).group(1))
    assert RESIDENT_BLOCKS_Q8 == min_blocks
    assert CHUNK_Q8 == int(re.search(r"constexpr int CK = (\d+);", text).group(1))
    assert CHUNK_Q8 % K_MULTIPLE_Q8 == 0
    assert "static constexpr int BM = 16 * WM;" in text
    assert "static constexpr int BN = 32 * (8 / WM);" in text
    assert re.search(r"bn == 32 \? launch<8>\(", text)
    assert {(16 * wm, 32 * (8 // wm)) for wm in (4, 8)} == set(TILES_Q8)
    assert _build.included_headers(SOURCE) == sorted(
        [HEADER, HEADER.parent / "describe.cuh",
         HEADER.parent / "per_device.cuh"])
    code = text + HEADER.read_text()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in code
    assert "__dp4a" not in code
    # The reduce kernel has a profiler name of its own.
    assert "gemm_q8_splitk_reduce_kernel(" in text


def test_both_int8_kernels_include_the_shared_header():
    for name in ("gemm_q8", "im2col_conv_q8"):
        src = _build._KERNELS_DIR / _build.SOURCES[name]
        assert HEADER in _build.included_headers(src)
        text = src.read_text()
        # The helpers are the header's, not copies.
        for helper in ("void mma_s8(", "void ldmatrix_x4(", "void cp_async16(",
                       "__byte_perm(", "void splitk_reduce("):
            assert helper not in text, (name, helper)


# ---------------------------------------------------------------------------
# The kernel's arithmetic, replayed


def _replay(a, b, scale, bias, act, splits):
    """The kernel's sums: int32 partials over chunks of 32 of K for each
    split's chunk range, added in split order, then the epilogue as the
    kernel rounds it (the product, then the bias, each its own fp32
    operation)."""
    m, k = a.shape
    chunks = -(-k // CHUNK_Q8)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    acc = torch.zeros((m, b.shape[1]), dtype=torch.int32)
    for lo, hi in _splitk.split_ranges(chunks, splits):
        part = torch.zeros_like(acc, dtype=torch.int64)
        for c in range(lo, hi):
            ks = slice(c * CHUNK_Q8, min((c + 1) * CHUNK_Q8, k))
            part += a64[:, ks] @ b64[ks]
        assert part.abs().max() < 2 ** 31
        acc = acc + part.to(torch.int32)
    v = acc.to(torch.float32) * scale
    if bias is not None:
        v = v + bias
    return apply_activation(v, act)


def _pad_to(x, shape):
    return np.pad(x, [(0, s - d) for d, s in zip(x.shape, shape)])


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ["linear", "leaky"])
@pytest.mark.parametrize("m,n,k", [(70, 100, 48), (169, 255, 144)])
def test_replay_is_exact(m, n, k, act, with_bias):
    """Ragged M and N (the 255-wide head), K % 32 == 16: every split count
    the kernel could take gives the plain version bit for bit, and the
    Pallas int8 body (interpret mode) on the same numpy inputs that too
    without a bias, within 1e-6 with one (its fused bias add)."""
    rng = np.random.default_rng(m + n + k)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, n) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    ta, tb, ts = (torch.from_numpy(v) for v in (a, b, scale))
    tbias = None if bias is None else torch.from_numpy(bias)
    ref = matmul_q8_ref(ta, tb, ts, tbias, act)
    for splits in range(1, -(-k // CHUNK_Q8) + 1):
        assert torch.equal(_replay(ta, tb, ts, tbias, act, splits), ref), splits
    # The wrapper's plain route is the same function.
    assert torch.equal(matmul_q8_bias_act(ta, tb, ts, tbias, act, impl="torch"),
                       ref)

    bm, bn, bk = -(-m // 8) * 8, 128, 128
    np_, kp = -(-n // bn) * bn, -(-k // bk) * bk
    pallas = np.asarray(matmul_pallas(
        jnp.asarray(_pad_to(a, (bm, kp))), jnp.asarray(_pad_to(b, (kp, np_))),
        bm, bn, bk, interpret=True, activation=act,
        bias=None if bias is None else jnp.asarray(_pad_to(bias, (np_,)))[None],
        scale=jnp.asarray(_pad_to(scale, (np_,)))[None]))[:m, :n]
    if bias is None:
        np.testing.assert_array_equal(ref.numpy(), pallas)
    else:
        np.testing.assert_allclose(
            ref.numpy(), pallas, rtol=RTOL,
            atol=RTOL * max(1.0, float(np.abs(pallas).max())))


def test_cuda_impl_refuses_cpu_tensors():
    """impl='cuda' on CPU tensors raises, never falls back; the plain route
    takes them."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, (8, 32)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (32, 5)).astype(np.int8))
    scale = torch.full((5,), 1e-3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        matmul_q8_bias_act(a, b, scale)
    assert torch.equal(matmul_q8_bias_act(a, b, scale, impl="torch"),
                       matmul_q8_ref(a, b, scale))


# ---------------------------------------------------------------------------
# chip_smoke.py's profile gate


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profiler_names_hold_no_other():
    """The profile gate counts a kernel by substring: no name holds
    another, the int8 GEMM's reduce kernel among them."""
    smoke = _chip_smoke()
    names = [*smoke.CUDA_NAMES.values(), *smoke.REDUCE_NAMES]
    assert "gemm_q8_splitk_reduce_kernel" in smoke.REDUCE_NAMES
    assert len(set(names)) == len(names)
    for a in names:
        for b in names:
            assert a == b or a not in b, (a, b)


@pytest.mark.parametrize("cell,want", [("yolov3-tiny 416 b1 int8", 3),
                                       ("yolov3-20 608 b1 int8", 0)])
def test_planned_launches_count_the_gemm_reduce(cell, want):
    """One reduce launch per int8 GEMM call that splits: YOLOv3-tiny's
    three, none of MODEL_20's."""
    smoke = _chip_smoke()
    planned = smoke.planned_cuda_launches(_int8_plan(cell))
    assert planned.get(smoke.GEMM_Q8_SPLITK_REDUCE, 0) == want
    assert planned[smoke.CUDA_NAMES["gemm_q8"]] == len(INT8_GEMM_SPLITS[cell])

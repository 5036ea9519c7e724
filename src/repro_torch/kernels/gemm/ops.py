"""Wrappers of the hand-written GEMM kernels (csrc/gemm.cu, csrc/gemm_16.cu,
csrc/gemm_q8.cu).

``matmul_bias_act`` computes act(a @ b + bias) in fp32;
``matmul16_bias_act`` the same on bf16 or fp16 operands, summed in fp32
and rounded to their type; ``matmul_q8_bias_act`` computes act(float(a_q @ b_q) * scale + bias) from
int8 operands with an exact int32 sum.  ``impl='cuda'`` launches the
kernel on CUDA tensors and raises on anything else; ``impl='torch'`` runs
the plain version (ref.py), on any device.  The kernels mask the ragged
M, N and K edges themselves (the int8 one takes K in multiples of 16), so
no operand is padded here.  Both kernels run on the tensor cores (the
fp32 one as 3xTF32, the int8 one as s8 ``mma.sync``, the 16-bit one as
``wgmma``) and split their reduction over their K chunks (16, 32 and 64
deep) across blocks where their grid alone would leave the card's block
slots empty (``call_splits``, ``call_splits_q8``, ``call_splits_16``);
the fp32 and int8 kernels sum the splits in a second kernel, the 16-bit
one across a thread block cluster in the same launch.  One wrapper call
is one product, whatever the number of CUDA kernels it launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import ACTIVATION_CODES
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_k
from repro_torch.kernels.gemm.ref import matmul16_ref, matmul_q8_ref, matmul_ref
from repro_torch.util import HALF_DTYPES

#: The kernel's compiled tile: 64x64 outputs per block, K steps of 16.
TILE: Tuple[int, int, int] = (64, 64, 16)
#: Blocks of the fp32 kernel resident on one SM: its launch bounds'
#: minimum, ``MIN_BLOCKS`` in csrc/sgemm_3xtf32.cuh.
RESIDENT_BLOCKS = 4

#: The 16-bit kernel's compiled tile (csrc/gemm_16.cu, BM, BN, BK): 64x64
#: outputs per block (one wgmma m64n64 warpgroup), K chunks of 64 (128-byte
#: rows, four k16 steps).
TILE_16: Tuple[int, int, int] = (64, 64, 64)
#: Blocks of the 16-bit kernel resident on one SM: its launch bounds'
#: minimum, ``MIN_BLOCKS`` in csrc/gemm_16.cu.
RESIDENT_BLOCKS_16 = 3
#: The 16-bit kernel's K multiple (TMA wants 16-byte row strides of A).
K_MULTIPLE_16 = 8
#: The most K splits of one 16-bit tile: the blocks of a portable thread
#: block cluster, which sums them (``MAX_SPLITS`` in csrc/gemm_16.cu).
MAX_SPLITS_16 = 8
#: What adding a split tile's partials across its cluster costs the 16-bit
#: kernel, in chunk steps a split (``split_k``'s ``sum_steps``): its
#: distributed-shared-memory reads take about as long as a chunk of 64 a
#: partial (scripts/conv16_variants.py on an NVIDIA H100 80GB HBM3 at
#: 700 W).
SUM_STEPS_16 = 1
#: Stages of the 16-bit kernel's ring at most (``MAX_STAGES``); a call
#: with fewer chunks of K takes one a chunk.
MAX_STAGES_16 = 3
#: The 16-bit kernel's fp32 partial tile: 64 rows of 64 + 8 floats
#: (``wgmma16::RED_LD`` in csrc/wgmma16.cuh).
RED_LD_16 = 72

#: The int8 kernel's K multiple (A's rows go as 16-byte copies).
K_MULTIPLE_Q8 = 16
#: The int8 kernel's K chunk: one m16n8k32 step.
CHUNK_Q8 = 32
#: The int8 kernel's compiled tiles (bm, bn): 64 x 64, and 128 x 32 for
#: N <= 32, where a 64-wide tile would mask half its columns.
TILES_Q8: Tuple[Tuple[int, int], ...] = ((64, 64), (128, 32))
#: Blocks of the int8 kernel resident on one SM: its launch bounds'
#: minimum, ``MIN_BLOCKS`` in csrc/gemm_q8.cu.
RESIDENT_BLOCKS_Q8 = 2

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGTYPES_Q8 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_16 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def default_block(m: int, n: int, k: int,
                  dtype: str = "float32") -> Tuple[int, int, int]:
    """(bm, bn, bk) for an (m, k) x (k, n) product: the compiled tile of
    the kernel that runs ``dtype`` (``TILE_16`` for bf16 and fp16, else
    ``TILE``).

    Ragged edges are masked in the kernel, so the tile does not depend on
    the shape; the arguments keep the reference's signature.
    """
    return TILE_16 if dtype in HALF_DTYPES else TILE


def call_splits(m: int, n: int, k: int) -> int:
    """``split_k`` for one fp32 GEMM call: its grid of 64x64 tiles and its
    ceil(K / 16) chunks, over the kernel's ``RESIDENT_BLOCKS`` a SM."""
    bm, bn, bk = TILE
    return split_k(-(-m // bm) * -(-n // bn), -(-k // bk), RESIDENT_BLOCKS)


def call_splits_16(m: int, n: int, k: int) -> int:
    """``split_k`` for one 16-bit GEMM call: its grid of 64x64 tiles and its
    ceil(K / 64) chunks, over the kernel's ``RESIDENT_BLOCKS_16`` a SM, at
    most ``MAX_SPLITS_16`` (one cluster a tile), the cluster's sum priced
    at ``SUM_STEPS_16``."""
    bm, bn, bk = TILE_16
    return split_k(-(-m // bm) * -(-n // bn), -(-k // bk), RESIDENT_BLOCKS_16,
                   MAX_SPLITS_16, SUM_STEPS_16)


def tma_rows16(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., N) 16-bit weights (a GEMM's B, a conv's HWIO) as the
    16-bit GEMM and conv kernels read them by TMA: rows of N contiguous
    values a multiple of 8 apart (16 bytes), the dimensions before them
    packed, 16-byte aligned.  ``w`` itself where it is so laid out, else a
    view of the first N columns of a copy with rows padded with zeros to a
    multiple of 8 (YOLOv3's heads have N = 255).  The network plan makes
    it once, where the weights are prepared; the wrappers pass anything
    else through it on each call."""
    if _tma_rows(w):
        return w
    n = w.shape[-1]
    return F.pad(w, (0, -(-n // 8) * 8 - n)).contiguous()[..., :n]


def _tma_rows(w: torch.Tensor) -> bool:
    """Whether ``w`` is laid out as ``tma_rows16`` returns it."""
    if w.dim() < 2 or w.stride(-1) != 1 or w.data_ptr() % 16:
        return False
    ld = w.stride(-2)
    if ld % 8 or ld < w.shape[-1]:
        return False
    step = ld * w.shape[-2]
    for size, stride in zip(reversed(w.shape[:-2]), reversed(w.stride()[:-2])):
        if size != 1 and stride != step:
            return False
        step *= size
    return True


def gemm16_smem_bytes(k: int, splits: int = 1) -> int:
    """Dynamic shared memory of one 16-bit GEMM launch with K = ``k`` cut
    into ``splits`` (``smem_bytes(stages_for(K, splits), splits)`` in
    csrc/gemm_16.cu): a stage a chunk of 64 of a split, at most
    ``MAX_STAGES_16``, each A's and B's 64 x 64 boxes; the fp32 partial
    tile after the ring (persistent blocks, splits == 1) or over it; two
    8-byte mbarriers a stage of the most, and 1 KB to align the ring."""
    bm, bn, bk = TILE_16
    stages = max(1, min(MAX_STAGES_16, -(-(-(-k // bk)) // splits)))
    ring, red = stages * (bm * bk + bk * bn) * 2, bm * RED_LD_16 * 4
    body = ring + red if splits == 1 else max(ring, red)
    return body + 2 * MAX_STAGES_16 * 8 + 1024


def tile_q8(n: int) -> Tuple[int, int]:
    """(bm, bn): the int8 kernel's tile for an N-wide product."""
    return TILES_Q8[1] if n <= TILES_Q8[1][1] else TILES_Q8[0]


def call_splits_q8(m: int, n: int, k: int) -> int:
    """``split_k`` for one int8 GEMM call: its grid of ``tile_q8(n)``
    tiles and its ceil(K / 32) chunks, over ``RESIDENT_BLOCKS_Q8`` a SM."""
    bm, bn = tile_q8(n)
    return split_k(-(-m // bm) * -(-n // bn), -(-k // CHUNK_Q8),
                   RESIDENT_BLOCKS_Q8)


def matmul_bias_act(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(M, K) x (K, N) -> act(a @ b + bias), fp32; ``bias`` is (N,) or None.

    With ``call_splits(M, N, K) > 1`` the partial sums go through a
    workspace of ``splits * M * N`` floats from PyTorch's caching
    allocator.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"gemm: shapes {tuple(a.shape)} x {tuple(b.shape)}"
                         f" with bias {None if bias is None else tuple(bias.shape)}")
    _build.require_dtype("gemm", torch.float32, a, b, bias)
    if impl == "torch":
        return matmul_ref(a, b, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("gemm", a, b, bias)
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    if m and n:
        fn = _build.load("gemm", "repro_gemm_bias_act", _ARGTYPES)
        splits = call_splits(m, n, k)
        ws = (torch.empty((splits, m, n), device=a.device, dtype=torch.float32)
              if splits > 1 else None)
        err = fn(a.data_ptr(), b.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 m, n, k, ACTIVATION_CODES[activation], splits,
                 _build.stream_handle(a))
        _build.check(err, "gemm")
        matmul_bias_act.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
matmul_bias_act.launches = 0


def matmul16_bias_act(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(M, K) x (K, N) bf16 or fp16 -> act(a @ b + bias) in a's type, the
    products summed in fp32 and rounded once; ``bias`` fp32 (N,) or None.
    Under ``impl='cuda'`` K % 8 == 0 and A 16-byte aligned; B goes
    through ``tma_rows16`` (a copy unless it is laid out so already, as
    ``core/netplan.py`` keeps a head's weights).  One launch, split K or
    not (``call_splits_16``): the splits of a tile are summed in its
    thread block cluster, with no workspace.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"gemm_16: shapes {tuple(a.shape)} x {tuple(b.shape)}"
                         f" with bias {None if bias is None else tuple(bias.shape)}")
    dtype = _build.require_16bit("gemm_16", a, b)
    _build.require_dtype("gemm_16", torch.float32, bias)
    if impl == "torch":
        return matmul16_ref(a, b, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("gemm_16", a, dtype=dtype)
    _build.require_cuda_operands("gemm_16", bias)
    if b.device != a.device:
        raise ValueError("gemm_16: B must lie on A's card")
    b = tma_rows16(b)
    if k % K_MULTIPLE_16 or a.data_ptr() % 16:
        raise ValueError(f"gemm_16: K must be a multiple of {K_MULTIPLE_16} "
                         f"and A 16-byte aligned, got K = {k}")
    out = torch.empty((m, n), device=a.device, dtype=dtype)
    if m and n:
        fn = _build.load("gemm_16", "repro_gemm16_bias_act", _ARGTYPES_16)
        err = fn(a.data_ptr(), b.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), m, n, k, b.stride(0),
                 ACTIVATION_CODES[activation], call_splits_16(m, n, k),
                 _build.DTYPE16_CODES[dtype], _build.stream_handle(a))
        _build.check(err, "gemm_16")
        matmul16_bias_act.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
matmul16_bias_act.launches = 0


def matmul_q8_bias_act(
    a_q: torch.Tensor,
    b_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(M, K) x (K, N) int8 -> act(float(a_q @ b_q) * scale + bias), fp32;
    ``scale`` is (N,), ``bias`` (N,) or None.  Raises when K * 127^2 could
    overflow the int32 sum, and under ``impl='cuda'`` unless K % 16 == 0.
    With ``call_splits_q8(M, N, K) > 1`` the int32 partial sums go through
    a workspace of ``splits * M * N`` int32 from PyTorch's caching
    allocator.
    """
    m, k = a_q.shape
    k2, n = b_q.shape
    if k != k2 or scale.shape != (n,) or (bias is not None
                                          and bias.shape != (n,)):
        raise ValueError(
            f"gemm_q8: shapes {tuple(a_q.shape)} x {tuple(b_q.shape)} with "
            f"scale {tuple(scale.shape)} and bias "
            f"{None if bias is None else tuple(bias.shape)}")
    _build.require_int32_exact("gemm_q8", k)
    if impl == "torch":
        return matmul_q8_ref(a_q, b_q, scale, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("gemm_q8", a_q, b_q, dtype=torch.int8)
    _build.require_cuda_operands("gemm_q8", scale, bias)
    if k % K_MULTIPLE_Q8 or a_q.data_ptr() % 16:
        raise ValueError(f"gemm_q8: K must be a multiple of {K_MULTIPLE_Q8} "
                         f"and A 16-byte aligned, got K = {k}")
    out = torch.empty((m, n), device=a_q.device, dtype=torch.float32)
    if m and n:
        fn = _build.load("gemm_q8", "repro_gemm_q8_bias_act", _ARGTYPES_Q8)
        splits = call_splits_q8(m, n, k)
        ws = (torch.empty((splits, m, n), device=a_q.device,
                          dtype=torch.int32) if splits > 1 else None)
        err = fn(a_q.data_ptr(), b_q.data_ptr(), scale.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 m, n, k, ACTIVATION_CODES[activation], tile_q8(n)[1],
                 splits, _build.stream_handle(a_q))
        _build.check(err, "gemm_q8")
        matmul_q8_bias_act.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
matmul_q8_bias_act.launches = 0

"""Wrappers of the hand-written GEMM kernels (csrc/gemm.cu, csrc/gemm_q8.cu).

``matmul_bias_act`` computes act(a @ b + bias) in fp32;
``matmul_q8_bias_act`` computes act(float(a_q @ b_q) * scale + bias) from
int8 operands with an exact int32 sum.  ``impl='cuda'`` launches the
kernel on CUDA tensors and raises on anything else; ``impl='torch'`` runs
the plain version (ref.py), on any device.  The kernels mask the ragged
M, N and K edges themselves (the int8 one takes K in multiples of 16), so
no operand is padded here.  Both kernels run on the tensor cores (the
fp32 one as 3xTF32, the int8 one as s8 ``mma.sync``) and split their
reduction over their K chunks (16 deep, 32 deep) across blocks where
their grid alone would leave the card's block slots empty
(``call_splits``, ``call_splits_q8``); one wrapper call is one product,
whatever the number of CUDA kernels it launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_k
from repro_torch.kernels.gemm.ref import matmul_q8_ref, matmul_ref

#: The kernel's compiled tile: 64x64 outputs per block, K steps of 16.
TILE: Tuple[int, int, int] = (64, 64, 16)
#: Blocks of the fp32 kernel resident on one SM: its launch bounds'
#: minimum, ``MIN_BLOCKS`` in csrc/sgemm_3xtf32.cuh.
RESIDENT_BLOCKS = 4

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


def default_block(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """(bm, bn, bk) for an (m, k) x (k, n) product: the one compiled tile.

    Ragged edges are masked in the kernel, so the tile does not depend on
    the shape; the arguments keep the reference's signature.
    """
    return TILE


def call_splits(m: int, n: int, k: int) -> int:
    """``split_k`` for one fp32 GEMM call: its grid of 64x64 tiles and its
    ceil(K / 16) chunks, over the kernel's ``RESIDENT_BLOCKS`` a SM."""
    bm, bn, bk = TILE
    return split_k(-(-m // bm) * -(-n // bn), -(-k // bk), RESIDENT_BLOCKS)


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

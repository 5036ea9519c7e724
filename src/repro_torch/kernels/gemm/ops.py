"""Wrapper of the hand-written GEMM kernel (csrc/gemm.cu).

``matmul_bias_act`` computes act(a @ b + bias).  ``impl='cuda'`` launches
the kernel on CUDA tensors and raises on anything else; ``impl='torch'``
runs the plain version (ref.py), on any device.  The kernel masks the
ragged M, N and K edges itself, so no operand is padded here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES
from repro_torch.kernels import _build
from repro_torch.kernels.gemm.ref import matmul_ref

#: The kernel's compiled tile: 64x64 outputs per block, K steps of 16.
TILE: Tuple[int, int, int] = (64, 64, 16)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def default_block(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """(bm, bn, bk) for an (m, k) x (k, n) product: the one compiled tile.

    Ragged edges are masked in the kernel, so the tile does not depend on
    the shape; the arguments keep the reference's signature.
    """
    return TILE


def matmul_bias_act(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(M, K) x (K, N) -> act(a @ b + bias), fp32; ``bias`` is (N,) or None."""
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
        err = fn(a.data_ptr(), b.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), m, n, k, ACTIVATION_CODES[activation],
                 _build.stream_handle(a))
        _build.check(err, "gemm")
        matmul_bias_act.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
matmul_bias_act.launches = 0

"""Plain PyTorch versions of the GEMM kernels (fp32 and int8): the
functions they must compute."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv_spec import Epilogue, apply_activation, apply_epilogue


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               activation: str = "linear") -> torch.Tensor:
    """act(a @ b + bias) in fp32."""
    out = a @ b
    if bias is not None:
        out = out + bias
    return apply_activation(out, activation)


def matmul_q8_ref(a_q: torch.Tensor, b_q: torch.Tensor, scale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  activation: str = "linear") -> torch.Tensor:
    """act(float(a_q @ b_q) * scale + bias): int8 (M, K) x (K, N), the sum
    exact, then the fp32 epilogue in the kernel's order.

    The product runs in float64, exact while |sum| < 2^53 (the wrappers
    cap it below 2^31), on any device: an int32 matmul has no CUDA
    implementation, and a float32 one is not exact at K = 9 * 1024.
    """
    acc = (a_q.double() @ b_q.double()).to(torch.int32)
    return apply_epilogue(acc, Epilogue(bias, activation, scale))

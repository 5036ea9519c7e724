"""Wrapper of the hand-written flash-attention kernels, both on the
tensor cores (csrc/flash_attention.cu, one C entry: fp32 as 3xTF32 in
csrc/flash_attention_fp32.cuh, bf16 in csrc/flash_attention_bf16.cuh).

``flash_attention(q, k, v, causal, window, logit_cap)`` computes
softmax-attention with q (B, S, H, hd) and k, v (B, Sk, KV, hd) read in
place (query head h on KV head h // (H // KV)), masks and softcap as
``attention_ref``.  ``impl='cuda'`` launches the kernel on CUDA tensors
and raises on anything else; ``impl='torch'`` runs the plain version
(ref.py), on any device.  The kernel masks ragged S and Sk itself, so
nothing is padded, transposed or broadcast here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: Head dims the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: Input types the kernel is compiled for, with the entry's type code.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_void_p])


def _check(q, k, v, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, S, H, hd), k and v "
                         f"(B, Sk, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    bk, sk, kv, hdk = k.shape
    if bk != b or hdk != hd or kv < 1 or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not go "
                         f"with k/v {tuple(k.shape)} (H must be a multiple "
                         f"of KV)")
    if s < 1 or sk < 1:
        raise ValueError("flash_attention: empty sequence")
    if window > 0 and s >= sk + window:
        # Query rows s >= Sk + window - 1 would see no key at all.
        raise ValueError(f"flash_attention: with window {window}, query rows "
                         f"at or beyond {sk + window - 1} have no key in "
                         f"Sk = {sk}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, impl: str = "cuda") -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Sk, KV, hd) -> (B, S, H, hd) in q's dtype."""
    _check(q, k, v, window)
    if impl == "torch":
        return attention_ref(q, k, v, causal, window, logit_cap)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: needs float32 or bfloat16, "
                         f"got {q.dtype}")
    _build.require_cuda_operands("flash_attention", q, k, v, dtype=q.dtype)
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned (the kernels copy 16 bytes at a time)")
    out = torch.empty_like(q)
    fn = _build.load("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, sk, h, kv, hd, DTYPES[q.dtype], int(bool(causal)),
             int(window), float(logit_cap), _build.stream_handle(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
flash_attention.launches = 0

"""Wrappers of the hand-written flash-attention kernels: the forward on the
tensor cores (csrc/flash_attention.cu, one C entry: fp32 as 3xTF32 in
csrc/flash_attention_fp32.cuh, bf16 in csrc/flash_attention_bf16.cuh) and
its backward (csrc/flash_attention_bwd.cu, one C entry, both bodies on the
tensor cores: bf16 in csrc/flash_attention_bwd_bf16.cuh, fp32 as 3xTF32 in
csrc/flash_attention_bwd_fp32.cuh).

``flash_attention(q, k, v, causal, window, logit_cap)`` computes
softmax-attention with q (B, S, H, hd) and k, v (B, Sk, KV, hd) read in
place (query head h on KV head h // (H // KV)), masks and softcap as
``attention_ref``.  ``impl='cuda'`` launches the kernel on CUDA tensors
and raises on anything else; ``impl='torch'`` runs the plain version
(ref.py), on any device.  The kernel masks ragged S and Sk itself, so
nothing is padded, transposed or broadcast here.

Under autograd (grad enabled and q, k or v requiring grad) the call is
``FlashAttention.apply``: its forward also writes the row statistic
``lse`` (B, H, S) fp32 that the backward reads, and its backward is the
backward kernel (``flash_attention_bwd``), or under ``impl='torch'`` the
plain ``attention_bwd_ref``, so the CPU runs the same wiring as the card.
Otherwise (``no_grad``, ``inference_mode``, no input requiring grad: every
serving path and CUDA graph) the forward launches as it always has, with
no ``lse`` written.

``lse`` is in base 2, in the kernels' units: with s~ the scaled (and
softcapped) score of a pair, x = s~ log2 e, ``lse = m + log2(l)`` for the
row's running max m of x and sum l of exp2(x - m), so p = exp2(x - lse);
it is the natural log-sum-exp of s~ times log2 e, which is how
``attention_ref_lse`` computes it.

The backward's dk/dv launch (both bodies) has one block a (batch, KV head,
key block), each looping over the G = H / KV query heads of its KV head.
Where those blocks are too few for the card (MQA: recurrentgemma-9b's B 1,
KV 1, G 16 at hd 256 gives 128 for 132 SMs), ``bwd_head_split`` splits the
G heads into groups, each group's blocks write fp32 partial dk and dv to
a workspace allocated here, and the kernel's reduce launch sums the groups
in group order (in bf16 then rounds once), so the gradients do not depend
on the split's timing.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_ref,
    attention_ref_lse,
)

#: Head dims the kernels are compiled for.
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: Input types the kernels are compiled for, with the entries' type code.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_F] + [_P] + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 9 + [_F] + [_P] + [_I] + [_P]

#: The backward's keys a dk/dv block at each head dim, the same in both
#: bodies (``Cfg<HD>::BK`` of csrc/flash_attention_bwd_bf16.cuh and of
#: csrc/flash_attention_bwd_fp32.cuh).
BWD_BLOCK_KEYS = {hd: 32 if hd == 256 else 64 for hd in HEAD_DIMS}
#: dk/dv blocks an SM the head split aims for: two are resident at every
#: head dim but fp32's hd 256, so fewer leave an SM's second slot idle.
#: fp32 at hd 256 holds one, and there the rule's split of 4 for
#: recurrentgemma-9b's MQA gives 512 blocks, about 3.9 waves over 132
#: SMs; split 2 (256 blocks) timed 14 % slower there and split 8 2 %
#: faster on an H100 (scripts/flash_bwd_variants.py --dtype fp32
#: --splits 2 4 8).
BWD_BLOCKS_PER_SM = 2


def bwd_head_split(b: int, kv: int, sk: int, g: int, hd: int,
                   sms: int = 132) -> int:
    """The groups that the backward's dk/dv launch splits the ``g``
    query heads of a KV head into: the fewest, among the divisors of g,
    that give ``b * kv * ceil(sk / BK)`` blocks times the groups at least
    ``BWD_BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, else g.  With 1
    the blocks store dk and dv themselves; above 1 each group writes fp32
    partials to a workspace of ``bwd_workspace_shape``."""
    blocks = b * kv * -(-sk // BWD_BLOCK_KEYS[hd])
    for split in range(1, g + 1):
        if g % split == 0 and blocks * split >= BWD_BLOCKS_PER_SM * sms:
            return split
    return g


def bwd_workspace_shape(split: int, b: int, sk: int, kv: int, hd: int):
    """The fp32 partials of a split launch: dk's groups, then dv's."""
    return (2, split, b, sk, kv, hd)


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


def _check_cuda(what: str, *tensors) -> None:
    """What both kernels take: fp32 or bf16 CUDA tensors of one type,
    contiguous, 16-byte aligned, at a compiled head dim."""
    dtype = tensors[0].dtype
    if dtype not in DTYPES:
        raise ValueError(f"{what}: needs float32 or bfloat16, got {dtype}")
    _build.require_cuda_operands(what, *tensors, dtype=dtype)
    hd = tensors[0].shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: q, k and v must be 16-byte aligned (the "
                         f"kernels copy 16 bytes at a time)")


def _forward_cuda(q, k, v, causal, window, logit_cap,
                  lse: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the forward kernel; it writes ``lse`` when given."""
    _check_cuda("flash_attention", q, k, v)
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.load("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, sk, h, kv, hd, DTYPES[q.dtype], int(bool(causal)),
             int(window), float(logit_cap), _build.stream_handle(q),
             None if lse is None else lse.data_ptr())
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True,
                        window: int = 0, logit_cap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention(q, k, v, ...)`` from its output
    ``out``, the output's gradient ``dout`` and the forward's ``lse``: one
    call of the backward kernel's entry (its row-dot, dk/dv, with a head
    split its reduce, and dq launches), on CUDA tensors only."""
    _check(q, k, v, window)
    _check_cuda("flash_attention_bwd", q, k, v, out, dout)
    _build.require_cuda_operands("flash_attention_bwd", lse,
                                 dtype=torch.float32)
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: out and dout like q "
                         f"{tuple(q.shape)}, lse (B, H, S); got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowdot = torch.empty_like(lse)       # D = rowsum(dout * out), workspace
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split = bwd_head_split(b, kv, sk, h // kv, hd, sms)
    ws = (torch.empty(bwd_workspace_shape(split, b, sk, kv, hd),
                      dtype=torch.float32, device=q.device)
          if split > 1 else None)
    fn = _build.load("flash_attention_bwd", "repro_flash_attention_bwd",
                     _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), rowdot.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, s, sk, h, kv, hd, DTYPES[q.dtype], int(bool(causal)),
             int(window), float(logit_cap), _build.stream_handle(q), split,
             None if ws is None else ws.data_ptr())
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The flash forward that saves ``lse``, and its backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, impl):
        if impl == "torch":
            out, lse = attention_ref_lse(q, k, v, causal, window, logit_cap)
        else:
            b, s, h, _ = q.shape
            lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
            out = _forward_cuda(q, k, v, causal, window, logit_cap, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, logit_cap, impl)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, logit_cap, impl = ctx.args
        bwd = attention_bwd_ref if impl == "torch" else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, dout.contiguous(), lse, causal, window,
                         logit_cap)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, impl: str = "cuda") -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Sk, KV, hd) -> (B, S, H, hd) in q's dtype;
    differentiable in q, k and v (``FlashAttention``)."""
    _check(q, k, v, window)
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, logit_cap, impl)
    if impl == "torch":
        return attention_ref(q, k, v, causal, window, logit_cap)
    return _forward_cuda(q, k, v, causal, window, logit_cap, None)


#: Kernel launches since the count was last set to 0: forward launches
#: (with or without lse) and backward calls.
flash_attention.launches = 0
flash_attention_bwd.launches = 0

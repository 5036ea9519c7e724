from repro_torch.kernels.flash_attention.ops import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_ref,
    attention_ref_lse,
)

__all__ = ["FlashAttention", "attention_bwd_ref", "attention_ref",
           "attention_ref_lse", "flash_attention", "flash_attention_bwd"]

"""LM configuration schema: the port's copy of ``repro/configs/base.py``'s
``ModelConfig``, field for field, and its input-shape cells (``ShapeSpec``,
``SHAPES``, ``cell_is_runnable``).  The JAX-free module is copied, not
imported, so the port never loads the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # Block pattern, cycled over layers.  Entries: 'attn' (global), 'local'
    # (sliding window), 'rglru', 'mlstm', 'slstm'.
    layer_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 4096

    # Attention options
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    use_post_norm: bool = False      # gemma2 sandwich norms
    embed_scale: bool = False        # gemma families scale embeds by sqrt(d)

    # MLP
    mlp_type: str = "swiglu"         # swiglu | gelu | none

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0            # arctic's parallel dense residual MLP
    capacity_factor: float = 1.25
    moe_sharded_dispatch: bool = False  # DP-sharded dispatch buffers (§Perf)

    # Recurrent families
    d_rnn: int = 0                   # rglru width (0 -> d_model)
    conv_width: int = 4

    # Modality frontends (stubs per assignment: precomputed embeddings)
    frontend: str = "none"           # none | audio_frames | vision_patches
    frontend_dim: int = 0
    num_patches: int = 0             # vlm: patches prepended to the sequence

    encoder_only: bool = False       # hubert
    causal: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # Engineering knobs (perf-iteration surface)
    remat: str = "full"              # none | full | dots
    attn_chunked_threshold: int = 8192
    scan_layers: bool = True
    loss_vocab_chunk: int = 0        # 0 = unchunked cross-entropy

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def pattern_layers(self) -> Tuple[str, ...]:
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def subquadratic(self) -> bool:
        """True if no layer needs global quadratic attention (long_500k ok)."""
        return all(t != "attn" for t in self.pattern_layers)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        h, kv = self.num_heads, self.num_kv_heads
        n = self.vocab_size * d  # embeddings (tied head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for t in self.pattern_layers:
            if t in ("attn", "local"):
                n += d * hd * (h + 2 * kv) + h * hd * d
            elif t == "rglru":
                dr = self.resolved_d_rnn
                n += 2 * d * dr + dr * d + self.conv_width * dr + 2 * dr * dr + dr
            elif t == "mlstm":
                n += d * 2 * d + 3 * d * d + d * d
            elif t == "slstm":
                n += d * 4 * d + h * (d // h) * 4 * (d // h) + d * d
            if self.num_experts:
                n += d * self.num_experts
                n += self.num_experts * 3 * d * f
                if self.moe_dense_ff:
                    n += 3 * d * self.moe_dense_ff
            elif f > 0:
                n += (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * f
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_layer_unused = (self.num_experts - self.top_k) * 3 * d * f
        return self.param_count() - len(self.pattern_layers) * per_layer_unused


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """The reference's skip rules, with its reasons."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention: 500k context infeasible"
    return True, ""

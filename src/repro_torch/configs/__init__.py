"""Model configurations as plain data: the paper's CNN layer tables
(``yolov3``, ``vgg16``) and the ten LM configs of the reference (dense,
MoE, recurrent, audio and vision).

``get_config(name)`` returns an LM arch's full-size config and
``smoke_config(name)`` its reduced variant for CPU tests, the same
reduction as ``repro/configs/__init__.py``; ``input_specs`` the inputs of
an (arch, shape) cell as ``(shape, torch.dtype)`` pairs (the reference's
``jax.ShapeDtypeStruct``s) and ``all_cells`` every cell's verdict.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeSpec,
    cell_is_runnable,
)

#: The LM archs, in the reference's order, and their modules.
_MODULES = {
    "hubert-xlarge": "hubert_xlarge",
    "granite-34b": "granite_34b",
    "qwen1.5-0.5b": "qwen15_05b",
    "llama3.2-1b": "llama32_1b",
    "gemma2-27b": "gemma2_27b",
    "arctic-480b": "arctic_480b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "internvl2-2b": "internvl2_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-125m": "xlstm_125m",
}
ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    """The full-size config of LM arch ``name``."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def smoke_config(name: str, seq_len: int = 32) -> ModelConfig:
    """Reduced config of the same family: small width, layers and vocab,
    the same block pattern and feature flags, fp32."""
    cfg = get_config(name)
    pat = cfg.layer_pattern
    num_layers = min(cfg.num_layers, 2 * len(pat) + 1)
    heads = 4
    kv = max(1, round(heads * cfg.num_kv_heads / cfg.num_heads))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 128),
        vocab_size=128,
        num_experts=min(cfg.num_experts, 8),
        top_k=min(cfg.top_k, 4) if cfg.top_k else 0,
        moe_dense_ff=min(cfg.moe_dense_ff, 64),
        d_rnn=64 if cfg.d_rnn else 0,
        frontend_dim=16 if cfg.frontend_dim else 0,
        num_patches=4 if cfg.num_patches else 0,
        local_window=min(cfg.local_window, seq_len // 2),
        attn_chunked_threshold=cfg.attn_chunked_threshold,
        dtype="float32",
    )


def input_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The inputs of one (arch x shape) cell, name -> (shape, dtype).

    train/prefill: full-sequence inputs (tokens, frames or tokens after
    patches; labels, or audio targets and mask, to train).  decode: one
    new token (the cache is sized by ``init_cache``).
    """
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32
    if shape.kind == "decode":
        return {"tokens": ((b, 1), i32)}
    if cfg.frontend == "audio_frames":
        specs = {"frames": ((b, s, cfg.frontend_dim), f32)}
        if shape.kind == "train":
            specs["targets"] = ((b, s), i32)
            specs["mask"] = ((b, s), torch.bool)
        return specs
    s_text = s - cfg.num_patches if cfg.frontend == "vision_patches" else s
    specs = {"tokens": ((b, s_text), i32)}
    if cfg.frontend == "vision_patches":
        specs["patch_embeds"] = ((b, cfg.num_patches, cfg.frontend_dim), f32)
    if shape.kind == "train":
        specs["labels"] = ((b, s_text), i32)
    return specs


def all_cells():
    """Every (arch, shape name, runnable, reason)."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, reason = cell_is_runnable(cfg, shape)
            yield arch, shape.name, ok, reason


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "all_cells",
           "cell_is_runnable", "get_config", "input_specs", "smoke_config"]

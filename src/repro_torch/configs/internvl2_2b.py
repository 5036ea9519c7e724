"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) ff=8192 vocab=92553.

InternViT-300M frontend is a STUB per assignment: input_specs provide 256
precomputed patch embeddings (dim 1024) per image, projected and prepended
to the token sequence; the InternLM2 backbone is implemented fully.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision_patches",
    frontend_dim=1024,
    num_patches=256,
    mlp_type="swiglu",
)

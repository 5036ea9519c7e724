"""granite-34b [dense]: 88L d=6144 48H (GQA kv=1, i.e. MQA) ff=24576
vocab=49152.  Llama-architecture code model.  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="swiglu",
)

"""xlstm-125m [ssm]: 12L d=768 4H ff=0 (blocks carry their own projections)
vocab=50304.  mLSTM:sLSTM = 7:1 pattern.  Sub-quadratic -> runs long_500k.
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    mlp_type="none",
)

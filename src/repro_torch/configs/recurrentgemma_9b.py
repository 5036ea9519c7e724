"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) ff=12288
vocab=256000.  Griffin pattern: (RG-LRU, RG-LRU, local-attention) repeated,
window 2048, head_dim 256, sqrt(d)-scaled embeddings.  Sub-quadratic ->
runs long_500k.  [arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    d_rnn=4096,
    conv_width=4,
    embed_scale=True,
    mlp_type="geglu",
)

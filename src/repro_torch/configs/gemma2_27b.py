"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) ff=36864 vocab=256000.

Local(4096-window)/global alternating attention, attention logit softcap 50,
final logit softcap 30, sandwich (post) norms, sqrt(d)-scaled embeddings,
head_dim fixed at 128.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    layer_pattern=("local", "attn"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norm=True,
    embed_scale=True,
    mlp_type="geglu",
)

"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) ff=5120 vocab=504.

Encoder-only transformer (same backbone as wav2vec2-XL); the convolutional
waveform frontend is a STUB per the assignment: input_specs provide
precomputed frame embeddings (dim 512).  Trains with masked-frame
prediction over 504 cluster targets.  [arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_type="gelu",
    encoder_only=True,
    causal=False,
    frontend="audio_frames",
    frontend_dim=512,
    tie_embeddings=False,
)

from repro_torch.data.images import image_batch
from repro_torch.data.tokens import batch_for, markov_tokens

__all__ = ["batch_for", "image_batch", "markov_tokens"]

from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    global_norm,
    init,
    update,
)
from repro_torch.optim.quantized_state import QTensor, dequantize, quantize
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "QTensor", "constant", "dequantize",
           "global_norm", "init", "quantize", "update", "warmup_cosine"]

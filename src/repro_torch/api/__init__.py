from repro_torch.api.compiled import CompiledCNN, CompiledLM, compile, load
from repro_torch.api.model import CNNModel, is_lm_config
from repro_torch.api.options import ExecutionOptions

__all__ = ["CNNModel", "CompiledCNN", "CompiledLM", "ExecutionOptions",
           "compile", "is_lm_config", "load"]

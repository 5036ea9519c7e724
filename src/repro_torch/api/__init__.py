from repro_torch.api.compiled import CompiledCNN, compile
from repro_torch.api.model import CNNModel
from repro_torch.api.options import ExecutionOptions

__all__ = ["CNNModel", "CompiledCNN", "ExecutionOptions", "compile"]

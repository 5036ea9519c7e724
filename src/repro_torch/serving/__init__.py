"""LM serving: the continuous-batching engine and its typed errors."""
from repro_torch.serving.engine import EagerServingEngine, Request, ServingEngine
from repro_torch.serving.resilience import (
    InvalidRequest,
    QueueNotDrained,
    ServingError,
    validate_prompt,
)

__all__ = ["EagerServingEngine", "InvalidRequest", "QueueNotDrained", "Request", "ServingEngine",
           "ServingError", "validate_prompt"]

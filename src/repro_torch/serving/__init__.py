"""Serving: the CNN bucket-ladder engine, the LM continuous-batching
engine, their resilience machinery and typed errors, and fault injection."""
from repro_torch.serving.cnn_engine import CNNServingEngine, ImageRequest
from repro_torch.serving.engine import EagerServingEngine, Request, ServingEngine
from repro_torch.serving.faults import (
    FakeClock,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    corrupt_cache_file,
)
from repro_torch.serving.resilience import (
    Backpressure,
    DeadlineExceeded,
    InvalidRequest,
    QueueNotDrained,
    RequestFailed,
    ResilientEngine,
    ServingError,
    is_failure,
    validate_image,
    validate_prompt,
)

__all__ = [
    "ServingEngine", "EagerServingEngine", "Request", "CNNServingEngine",
    "ImageRequest", "Backpressure", "DeadlineExceeded", "InvalidRequest",
    "QueueNotDrained", "RequestFailed", "ResilientEngine", "ServingError",
    "is_failure", "validate_image", "validate_prompt", "FakeClock",
    "FaultPlan", "FaultSpec", "InjectedFault", "corrupt_cache_file",
]

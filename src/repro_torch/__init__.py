"""repro_torch: the PyTorch + CUDA port of the co-design CNN inference
stack, and of its dense LM stack, for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
neither it nor JAX.  The public surface mirrors it::

    import repro_torch
    from repro_torch.configs import yolov3

    compiled = repro_torch.compile(yolov3.TINY_MODEL, params,
                                   repro_torch.ExecutionOptions())
    y = compiled.run(x)          # (B, 416, 416, 3) NHWC on the card
    engine = compiled.serve()    # buckets 1/4/8: submit(image), run()

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("llama3.2-1b")
    lm = repro_torch.compile(cfg, init_params(cfg, generator))
    logits = lm.run(tokens)      # (B, S) -> (B, S, V), prefill
    engine = lm.serve(batch_size=4, capacity=128)

``ExecutionOptions(impl='cuda')`` (the default) runs the hand-written CUDA
kernels under ``kernels/*/csrc``, built with nvcc at first use;
``impl='torch'`` runs their plain PyTorch versions.  ``mode='model'``
plans each conv by the card's cost model (core/codesign.py); with a
``cache_path`` the plans persist, and ``compiled.save()`` /
``repro_torch.load(path, model, params)`` rebuild a compiled CNN without
re-tuning.
"""
__version__ = "0.1.0"

from repro_torch.api import (
    CNNModel,
    CompiledCNN,
    CompiledLM,
    ExecutionOptions,
    compile,
    load,
)
from repro_torch.core import (
    ConvAlgorithm,
    ConvPlan,
    ConvSpec,
    Epilogue,
    Layout,
    NetworkExecutor,
    NetworkPlan,
    Planner,
    conv2d,
    conv2d_reference,
)
from repro_torch.serving import (
    Backpressure,
    CNNServingEngine,
    DeadlineExceeded,
    FakeClock,
    FaultPlan,
    FaultSpec,
    ImageRequest,
    InjectedFault,
    InvalidRequest,
    QueueNotDrained,
    Request,
    RequestFailed,
    ResilientEngine,
    ServingEngine,
    ServingError,
    corrupt_cache_file,
    is_failure,
)

__all__ = [
    "CNNModel",
    "CompiledCNN",
    "CompiledLM",
    "ExecutionOptions",
    "compile",
    "load",
    "ConvAlgorithm",
    "ConvPlan",
    "ConvSpec",
    "Epilogue",
    "Layout",
    "NetworkExecutor",
    "NetworkPlan",
    "Planner",
    "conv2d",
    "conv2d_reference",
    "Backpressure",
    "CNNServingEngine",
    "DeadlineExceeded",
    "FakeClock",
    "FaultPlan",
    "FaultSpec",
    "ImageRequest",
    "InjectedFault",
    "InvalidRequest",
    "QueueNotDrained",
    "Request",
    "RequestFailed",
    "ResilientEngine",
    "ServingEngine",
    "ServingError",
    "corrupt_cache_file",
    "is_failure",
]

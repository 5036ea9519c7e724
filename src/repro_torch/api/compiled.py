"""``compile(model, params, options) -> CompiledCNN`` — the facade core.

The port of ``repro/api/compiled.py``'s CNN path: plan (per-layer
ConvPlans + whole-network layouts) -> prepare (batchnorm fold, channel
padding, offline Winograd weight transform; under int8, calibration and
weight quantization) -> run.  Serving, save and load come in a later
slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.api.model import CNNModel
from repro_torch.api.options import ExecutionOptions


class CompiledCNN:
    """A CNN compiled end to end: a NetworkPlan and a NetworkExecutor per
    batch size.  ``options.batch`` is planned and prepared eagerly; other
    batch sizes on first use."""

    def __init__(self, model: CNNModel, params: Sequence[Dict],
                 options: ExecutionOptions, calibration: Optional[Any] = None):
        from repro_torch.core.planner import Planner
        from repro_torch.models.cnn import params_from_numpy

        self.model = model
        self.options = options
        self.device = torch.device(options.device)
        self.params = params_from_numpy(params, self.device)
        # int8 activation-scale calibration batch (B, H, W, C); None: the
        # seeded default batch, made only if some layer resolves to int8.
        self.calibration = calibration
        self.planner = Planner(impl=options.impl, mode=options.mode,
                               winograd_fused=options.winograd_fused,
                               device=self.device)
        self._netplans: Dict[int, Any] = {}
        self._executors: Dict[int, Any] = {}
        self.executor(options.batch)

    def network_plan(self, batch: Optional[int] = None):
        """The (cached) whole-network plan for one batch size."""
        from repro_torch.core.netplan import plan_network

        b = int(batch) if batch is not None else self.options.batch
        if b not in self._netplans:
            self._netplans[b] = plan_network(
                self.model.layers, *self.model.input_hw, self.planner,
                in_channels=self.model.in_channels, batch=b,
                dtype=self.options.dtype,
            )
        return self._netplans[b]

    def executor(self, batch: Optional[int] = None):
        """The (cached) NetworkExecutor for one batch size."""
        from repro_torch.core.netplan import NetworkExecutor

        b = int(batch) if batch is not None else self.options.batch
        if b not in self._executors:
            self._executors[b] = NetworkExecutor(
                self.network_plan(b), self.params,
                pretransform=self.options.pretransform,
                calibration=self.calibration,
            )
        return self._executors[b]

    def run(self, x) -> torch.Tensor:
        """Whole-network inference on a (B, H, W, C) batch (tensor or
        array), on ``options.device``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim != 4:
            raise ValueError(
                f"run() expects (B, H, W, C), got shape {tuple(x.shape)}"
            )
        return self.executor(int(x.shape[0]))(x.contiguous())

    def __call__(self, x) -> torch.Tensor:
        return self.run(x)

    def plan_report(self, batch: Optional[int] = None) -> Dict[str, Any]:
        """The resolved per-layer decisions, machine-readable."""
        netplan = self.network_plan(batch)
        rows = [
            {
                "index": s.index,
                "algorithm": s.plan.algorithm.value,
                "dtype": s.plan.dtype,
                "impl": s.plan.impl,
                "kernel": getattr(s.layer, "kernel", None),
                "stride": getattr(s.layer, "stride", None),
                "in_hw": list(s.in_hw),
                "kernel_blocks": list(s.plan.kernel_blocks),
                "winograd_fused": s.plan.winograd_fused,
                "source": s.plan.source,
                "measured_ms": dict(s.plan.measured_ms),
                "in_layout": [s.in_layout.c, s.in_layout.pad_c],
                "elided": not s.out_layout.trivial,
            }
            for s in netplan.steps if s.layer.kind == "conv"
        ]
        return {
            "model": self.model.name,
            "kind": "cnn",
            "batch": netplan.batch,
            "impl": netplan.impl,
            "dtype": netplan.dtype,
            "mode": self.planner.mode,
            "winograd_fused": self.planner.winograd_fused,
            "device": str(self.device),
            "elided_boundaries": netplan.elided_boundaries,
            "layers": rows,
            "tunes": self.planner.stats["tunes"],
            "hits": self.planner.stats["hits"],
        }


def compile(  # noqa: A001 - deliberate: mirrors repro.compile
    model: CNNModel,
    params: Sequence[Dict],
    options: Optional[ExecutionOptions] = None,
    calibration: Optional[Any] = None,
) -> CompiledCNN:
    """Plan, prepare and return a runnable CNN.

    ``params`` is the reference's parameter list (numpy arrays or tensors,
    HWIO conv weights); it is moved to ``options.device`` as float32.
    ``options`` defaults to ``ExecutionOptions()``: the CUDA kernels on the
    card.  ``calibration`` is an fp32 (B, H, W, C) sample batch that
    calibrates the int8 activation scales under ``dtype='int8'``
    (``quant.default_calibration_batch`` when None); unused otherwise.
    """
    return CompiledCNN(model, params,
                       options if options is not None else ExecutionOptions(),
                       calibration=calibration)

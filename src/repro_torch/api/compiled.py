"""``compile(model, params, options)`` — the facade core.

The port of ``repro/api/compiled.py``.  A CNN compiles to a
``CompiledCNN``: plan (per-layer ConvPlans + whole-network layouts) ->
prepare (batchnorm fold, channel padding, offline Winograd weight
transform; under int8, calibration and weight quantization) -> run.  An LM
``ModelConfig`` compiles to a ``CompiledLM``: the full-sequence forward
(prefill) for ``run``, the continuous-batching engine for ``serve``.  CNN
serving, save and load come in a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.api.model import CNNModel, is_lm_config
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
        # One memory pool for the executors' CUDA graphs, as for
        # CompiledLM's: they replay one at a time and clone their outputs.
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
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
                calibration=self.calibration, pool=self._pool,
            )
        return self._executors[b]

    def run(self, x) -> torch.Tensor:
        """Whole-network inference on a (B, H, W, C) batch (tensor or
        array), on ``options.device``: on the card a replay of the batch's
        CUDA graph (``NetworkExecutor``); ``executor(b).eager(x)`` runs
        the same forward eagerly."""
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


class CompiledLM:
    """An LM config compiled through the same facade: the full-sequence
    forward for ``run`` (every attention through the flash-attention
    kernel under ``impl='cuda'``, its plain version under
    ``impl='torch'``), the continuous-batching engine for ``serve``.  The
    model computes in ``cfg.dtype``.

    On the card ``run`` replays a CUDA graph of the forward
    (``graphs.CapturedCall``), one per (B, S) token shape, captured at the
    shape's first call, as ``jax.jit`` keeps one trace per shape.  The
    graphs share one memory pool: they replay one at a time and each call
    clones its logits, so a later capture reuses the activations of the
    earlier ones, and the pool holds about the largest shape's forward
    plus each graph's static logits, where the eager forward frees its
    activations after each call.  ``eager`` runs the forward eagerly."""

    def __init__(self, cfg, params, options: ExecutionOptions):
        from repro_torch.models import transformer as tf

        tf.check_supported(cfg)
        if options.dtype != "float32":
            raise ValueError(f"dtype={options.dtype!r} applies to CNNs; an LM "
                             f"computes in its config's dtype ({cfg.dtype})")
        self.model = cfg
        self.options = options
        self.device = torch.device(options.device)
        self._tf = tf
        self.params = tf.tree_map(lambda t: t.to(self.device), params)
        self._graphs: Dict[Tuple[int, ...], Any] = {}
        self._pool = None

    def _tokens(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        if tokens.ndim != 2:
            raise ValueError(f"run() expects (B, S) tokens, got shape "
                             f"{tuple(tokens.shape)}")
        return tokens

    def eager(self, tokens) -> torch.Tensor:
        """The full-sequence forward, run eagerly."""
        tokens = self._tokens(tokens)
        with torch.inference_mode():
            return self._tf.forward(self.model, self.params, tokens,
                                    impl=self.options.impl)

    def run(self, tokens) -> torch.Tensor:
        """Full-sequence logits: (B, S) int tokens (tensor or array) ->
        (B, S, V) in ``cfg.dtype``, on ``options.device``."""
        tokens = self._tokens(tokens)
        if self.device.type != "cuda":
            return self.eager(tokens)
        shape = tuple(tokens.shape)
        if shape not in self._graphs:
            from repro_torch.graphs import CapturedCall

            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._graphs[shape] = CapturedCall(
                self.eager, (tokens,),
                f"the {self.model.name} forward at (B, S) = {shape}",
                pool=self._pool)
        return self._graphs[shape](tokens)

    def __call__(self, tokens) -> torch.Tensor:
        return self.run(tokens)

    def serve(self, batch_size: Optional[int] = None, capacity: int = 256,
              **engine_opts):
        """A continuous-batching ServingEngine for this model;
        ``batch_size`` defaults to ``options.batch``."""
        from repro_torch.serving.engine import ServingEngine

        return ServingEngine.from_compiled(
            self, batch_size=batch_size, capacity=capacity, **engine_opts)

    def plan_report(self) -> Dict[str, Any]:
        return {
            "model": self.model.name,
            "kind": "lm",
            "num_layers": self.model.num_layers,
            "layer_pattern": list(self.model.pattern_layers),
            "supports_decode": self.model.supports_decode,
            "dtype": self.model.dtype,
            "impl": self.options.impl,
            "device": str(self.device),
            "attention": ("flash_attention kernel" if self.options.impl == "cuda"
                          else "attention_ref (plain)"),
        }


def compile(  # noqa: A001 - deliberate: mirrors repro.compile
    model: Any,
    params: Any,
    options: Optional[ExecutionOptions] = None,
    calibration: Optional[Any] = None,
):
    """Plan, prepare and return a runnable model.

    ``model`` is a ``CNNModel`` or an LM ``ModelConfig``
    (``repro_torch.configs.get_config``).  For a CNN, ``params`` is the
    reference's parameter list (numpy arrays or tensors, HWIO conv
    weights), moved to ``options.device`` as float32, and ``calibration``
    an fp32 (B, H, W, C) sample batch that calibrates the int8 activation
    scales under ``dtype='int8'`` (``quant.default_calibration_batch`` when
    None; unused otherwise).  For an LM, ``params`` is the port's
    (``transformer.init_params``, or ``transformer.params_from_numpy`` of
    the reference's tree).
    ``options`` defaults to ``ExecutionOptions()``: the CUDA kernels on the
    card.
    """
    opts = options if options is not None else ExecutionOptions()
    if is_lm_config(model):
        return CompiledLM(model, params, opts)
    return CompiledCNN(model, params, opts, calibration=calibration)

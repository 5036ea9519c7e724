"""``compile(model, params, options)`` — the facade core.

The port of ``repro/api/compiled.py``.  A CNN compiles to a
``CompiledCNN``: plan (per-layer ConvPlans + whole-network layouts) ->
prepare (batchnorm fold, channel padding, offline Winograd weight
transform; under int8, calibration and weight quantization) -> run.  An LM
``ModelConfig`` compiles to a ``CompiledLM``: the full-sequence forward
(prefill) for ``run``, the continuous-batching engine for ``serve``.
``save`` writes a small JSON artifact: the model's identity, the option
surface and, of a CNN, the whole-network plans of its planned batch
sizes; ``load`` rebuilds the compiled model from it and re-tunes nothing,
with or without a plan cache.  CNN serving comes in a later slice.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.api.model import CNNModel, is_lm_config
from repro_torch.api.options import ExecutionOptions

#: The ``format`` of a ``save`` artifact.
SAVE_FORMAT = "repro_torch.api/1"


def _save_payload(kind: str, model_desc: Dict[str, Any],
                  options: ExecutionOptions, path: Optional[str],
                  networks: Optional[Dict[str, Any]] = None) -> str:
    """Write a ``save`` artifact; a ``path`` of None puts it beside the plan
    cache as ``<name>.compiled.json``, and raises without a cache."""
    payload = {"format": SAVE_FORMAT, "kind": kind, "model": model_desc,
               "options": options.to_json()}
    if networks is not None:
        payload["networks"] = networks
    if path is None:
        if not options.cache_path:
            raise ValueError("save() needs a path when options.cache_path "
                             "is None")
        base = os.path.dirname(options.cache_path) or "."
        path = os.path.join(base, f"{model_desc.get('name', 'model')}"
                                  f".compiled.json")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return path


class CompiledCNN:
    """A CNN compiled end to end: a NetworkPlan and a NetworkExecutor per
    batch size.  ``options.batch`` is planned and prepared eagerly; other
    batch sizes on first use.  ``networks`` (a ``save`` artifact's
    whole-network entries) go into the planner before anything is
    planned, where it holds no entry of its own under their keys."""

    def __init__(self, model: CNNModel, params: Sequence[Dict],
                 options: ExecutionOptions, calibration: Optional[Any] = None,
                 planner=None, networks: Optional[Dict[str, Any]] = None):
        from repro_torch.models.cnn import params_from_numpy

        self.model = model
        self.options = options
        self.device = torch.device(options.device)
        self.params = params_from_numpy(params, self.device)
        # int8 activation-scale calibration batch (B, H, W, C); None: the
        # seeded default batch, made only if some layer resolves to int8.
        self.calibration = calibration
        # A planner made here is this model's to save; a caller's (maybe
        # shared) planner keeps its own persistence: compiling never
        # rewrites its cache file.
        self._own_planner = planner is None
        self.planner = planner if planner is not None else options.make_planner()
        for key, entry in (networks or {}).items():
            if self.planner.network_entry(key) is None:
                self.planner.put_network_entry(key, entry)
        self._netplans: Dict[int, Any] = {}
        self._executors: Dict[int, Any] = {}
        # One memory pool for the executors' CUDA graphs, as for
        # CompiledLM's: they replay one at a time and clone their outputs.
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self.executor(options.batch)

    def save_plans(self) -> None:
        """Write the planner's cache file (``Planner.save``: only what came
        since the last save) when this model owns the planner."""
        if self._own_planner:
            self.planner.save()

    def save(self, path: Optional[str] = None) -> str:
        """Persist this compilation: the plan cache, where there is one,
        and a JSON artifact of the model's identity, the option surface
        and the whole-network entry of each planned batch size, whose
        path is returned.  ``load`` rebuilds it and re-tunes nothing."""
        from repro_torch.core.netplan import network_key

        self.save_plans()
        networks = {}
        for b in self._netplans:
            key = network_key(self.model.layers, *self.model.input_hw,
                              self.model.in_channels, b, self.planner,
                              self.options.dtype)
            networks[key] = self.planner.network_entry(key)
        return _save_payload("cnn", {
            "name": self.model.name,
            "digest": self.model.digest,
            "input_hw": list(self.model.input_hw),
            "in_channels": self.model.in_channels,
        }, self.options, path, networks)

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
            self.save_plans()
        return self._executors[b]

    def run(self, x) -> torch.Tensor:
        """Whole-network inference on a (B, H, W, C) batch (tensor or
        array), cast to ``options.input_dtype``, on ``options.device``: on
        the card a replay of the batch's CUDA graph (``NetworkExecutor``);
        ``executor(b).eager(x)`` runs the same forward eagerly."""
        x = torch.as_tensor(x, device=self.device).to(
            getattr(torch, self.options.input_dtype))
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
                "predicted_s": s.plan.predicted_s,
                "measured_ms": dict(s.plan.measured_ms),
                "in_layout": [s.in_layout.c, s.in_layout.pad_c],
                "elided": not s.out_layout.trivial,
            }
            for s in netplan.steps if s.layer.kind == "conv"
        ]
        predicted = [r["predicted_s"] for r in rows]
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
            "predicted_total_s": (None if None in predicted
                                  else sum(predicted)),
            "tunes": self.planner.stats["tunes"],
            "hits": self.planner.stats["hits"],
            "network_hits": self.planner.network_hits,
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

    def save(self, path: Optional[str] = None) -> str:
        """A JSON artifact of the config's name and the option surface
        (an LM has no plans); ``load`` rebuilds it."""
        return _save_payload("lm", {"name": self.model.name}, self.options,
                             path)


def compile(  # noqa: A001 - deliberate: mirrors repro.compile
    model: Any,
    params: Any,
    options: Optional[ExecutionOptions] = None,
    calibration: Optional[Any] = None,
    planner=None,
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
    card.  ``planner`` is a runtime resource, not saved: a Planner shared
    by several compilations pools their plans (and keeps its own cache
    file's persistence); None, a planner of ``options``.
    """
    opts = options if options is not None else ExecutionOptions()
    if is_lm_config(model):
        return CompiledLM(model, params, opts)
    return CompiledCNN(model, params, opts, calibration=calibration,
                       planner=planner)


def load(path: str, model: Any, params: Any, planner=None,
         calibration: Optional[Any] = None):
    """Rebuild a compiled model from a ``save`` artifact: a CNN's saved
    whole-network plans go into its planner (``planner``, or one of the
    saved options), so it re-tunes nothing, with or without a plan cache.
    Raises ``ValueError`` when ``model`` is not the one saved (the layer
    table's digest and the input geometry of a CNN, the config's name of
    an LM)."""
    with open(path) as f:
        data = json.load(f)
    if data.get("format") != SAVE_FORMAT:
        raise ValueError(f"{path}: not a {SAVE_FORMAT} artifact "
                         f"(format={data.get('format')!r})")
    opts = ExecutionOptions.from_json(data.get("options", {}))
    saved = data.get("model", {})
    if data.get("kind") == "cnn":
        if not isinstance(model, CNNModel):
            raise ValueError(f"{path} was saved from a CNN; got {type(model)}")
        if saved.get("digest") != model.digest:
            raise ValueError(
                f"{path}: saved layer-table digest {saved.get('digest')} does "
                f"not match the given model's ({model.digest})")
        if (tuple(saved.get("input_hw", ())) != tuple(model.input_hw)
                or int(saved.get("in_channels", -1)) != model.in_channels):
            raise ValueError(
                f"{path}: saved for input {saved.get('input_hw')} x "
                f"{saved.get('in_channels')}, the given model takes "
                f"{model.input_hw} x {model.in_channels}")
    elif data.get("kind") == "lm":
        if getattr(model, "name", None) != saved.get("name"):
            raise ValueError(f"{path}: saved LM config {saved.get('name')!r}"
                             f" does not match the given "
                             f"{getattr(model, 'name', None)!r}")
        return CompiledLM(model, params, opts)
    else:
        raise ValueError(f"{path}: unknown kind {data.get('kind')!r}")
    return CompiledCNN(model, params, opts, calibration=calibration,
                       planner=planner, networks=data.get("networks"))

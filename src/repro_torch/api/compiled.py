"""``compile(model, params, options)`` — the facade core.

The port of ``repro/api/compiled.py``.  A CNN compiles to a
``CompiledCNN``: plan (per-layer ConvPlans + whole-network layouts) ->
prepare (batchnorm fold, channel padding, offline Winograd weight
transform; under int8, calibration and weight quantization) -> run.  An LM
``ModelConfig`` compiles to a ``CompiledLM``: the full-sequence forward
(prefill) for ``run``, the continuous-batching engine for ``serve``.
``serve`` of a CNN returns the bucket-ladder engine
(serving/cnn_engine.py), of an LM the decode engine (serving/engine.py).
``save`` writes a small JSON artifact: the model's identity, the option
surface and, of a CNN, the whole-network plans and stage partitions of its
planned batch sizes; ``load`` rebuilds the compiled model from it and
re-tunes and re-partitions nothing, with or without a plan cache.  The
devices a CNN runs on (``compile(..., devices=)``: batch shards or
pipeline stages) are a runtime resource and are not saved.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.api.model import CNNModel, is_lm_config
from repro_torch.api.options import ExecutionOptions

#: The ``format`` of a ``save`` artifact.
SAVE_FORMAT = "repro_torch.api/1"


def _save_payload(kind: str, model_desc: Dict[str, Any],
                  options: ExecutionOptions, path: Optional[str],
                  networks: Optional[Dict[str, Any]] = None,
                  pipelines: Optional[Dict[str, Any]] = None) -> str:
    """Write a ``save`` artifact; a ``path`` of None puts it beside the plan
    cache as ``<name>.compiled.json``, and raises without a cache."""
    payload = {"format": SAVE_FORMAT, "kind": kind, "model": model_desc,
               "options": options.to_json()}
    if networks is not None:
        payload["networks"] = networks
    if pipelines:
        payload["pipelines"] = pipelines
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
    """A CNN compiled end to end: a NetworkPlan and an executor per batch
    size, a NetworkExecutor (batch-sharded over ``devices`` where more
    than one is given and ``options.shard_batch``) or, under
    ``options.pipeline_stages``, a PipelineExecutor over a cached stage
    partition.  ``options.batch`` is planned and prepared eagerly; other
    batch sizes on first use.  ``networks`` and ``pipelines`` (a ``save``
    artifact's whole-network and stage-partition entries) go into the
    planner before anything is planned, where it holds no entry of its
    own under their keys.  ``devices`` (None: every visible card, or the
    CPU of a CPU compile) is a runtime resource, not saved.
    ``options.validate`` gates every executor on ``verify_report`` (a
    pipeline on ``verify_pipeline``): an error finding raises
    ``PlanVerificationError`` and the executor is not kept; ``reports``
    keeps each gate's report (by batch, a pipeline's by ("pipeline",
    batch))."""

    def __init__(self, model: CNNModel, params: Sequence[Dict],
                 options: ExecutionOptions, calibration: Optional[Any] = None,
                 planner=None, networks: Optional[Dict[str, Any]] = None,
                 pipelines: Optional[Dict[str, Any]] = None,
                 devices: Optional[Sequence[Any]] = None):
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
        for key, entry in (pipelines or {}).items():
            if self.planner.pipeline_entry(key) is None:
                self.planner.put_pipeline_entry(key, entry)
        self._devices = None if devices is None else list(devices)
        self._netplans: Dict[int, Any] = {}
        self._executors: Dict[int, Any] = {}
        self._pipeplans: Dict[int, Any] = {}
        self._pipe_executors: Dict[int, Any] = {}
        # The gate's report of each executor built under options.validate:
        # by batch, and by ("pipeline", batch) for a pipeline's.
        self.reports: Dict[Any, Any] = {}
        # One memory pool for the single-device executors' CUDA graphs, as
        # for CompiledLM's: they replay one at a time and clone their
        # outputs.  Shards and stages replay at the same time: each of
        # their graphs has a pool of its own (graphs.DeviceCall).
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._executor_for(options.batch)

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
        from repro_torch.core.netplan import network_key, pipeline_key

        self.save_plans()
        m = self.model
        networks, pipelines = {}, {}
        for b in self._netplans:
            key = network_key(m.layers, *m.input_hw, m.in_channels, b,
                              self.planner, self.options.dtype)
            networks[key] = self.planner.network_entry(key)
        for b in self._pipeplans:
            key = pipeline_key(m.layers, *m.input_hw, m.in_channels, b,
                               self.options.pipeline_stages, self.planner,
                               self.options.dtype)
            pipelines[key] = self.planner.pipeline_entry(key)
        return _save_payload("cnn", {
            "name": m.name,
            "digest": m.digest,
            "input_hw": list(m.input_hw),
            "in_channels": m.in_channels,
        }, self.options, path, networks, pipelines)

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

    def devices(self) -> List[torch.device]:
        """The devices this model runs on: ``compile``'s ``devices``, else
        every visible card (the CPU of a CPU compile)."""
        from repro_torch.launch.mesh import visible_devices

        if self._devices is not None:
            return [torch.device(d) for d in self._devices]
        return visible_devices(self.device)

    def executor(self, batch: Optional[int] = None):
        """The (cached) NetworkExecutor for one batch size: sharded over
        ``devices()`` where ``options.shard_batch`` holds, there is more
        than one and the batch divides their count, else on the first
        (by default, on one visible card: the single graph in this
        model's pool)."""
        from repro_torch.core.netplan import NetworkExecutor

        b = int(batch) if batch is not None else self.options.batch
        if b not in self._executors:
            devices = self.devices()
            if not self.options.shard_batch:
                devices = devices[:1]
            if len(devices) == 1 and self._devices is None:
                devices = None          # the params' device: this model's
            self._executors[b] = NetworkExecutor(
                self.network_plan(b), self.params,
                pretransform=self.options.pretransform,
                calibration=self.calibration, pool=self._pool,
                devices=devices,
            )
            if self.options.validate != "off":
                from repro_torch.analysis import PlanVerificationError

                report = self.verify_report(batch=b,
                                            level=self.options.validate)
                self.reports[b] = report
                if not report.ok:
                    del self._executors[b]
                    raise PlanVerificationError(report)
            self.save_plans()
        return self._executors[b]

    def pipeline_plan(self, batch: Optional[int] = None):
        """The (cached) cost-balanced stage partition for one batch size
        (``core/netplan.plan_pipeline``, through the plan cache:
        ``planner.pipeline_hits`` counts the partitions taken from it).
        Needs ``options.pipeline_stages >= 2``."""
        from repro_torch.core.netplan import plan_pipeline

        if self.options.pipeline_stages < 2:
            raise ValueError(f"pipeline_plan() needs ExecutionOptions("
                             f"pipeline_stages=...) >= 2, got "
                             f"{self.options.pipeline_stages}")
        b = int(batch) if batch is not None else self.options.batch
        if b not in self._pipeplans:
            self._pipeplans[b] = plan_pipeline(
                self.model.layers, *self.model.input_hw, self.planner,
                self.options.pipeline_stages,
                in_channels=self.model.in_channels, batch=b,
                dtype=self.options.dtype, netplan=self.network_plan(b))
        return self._pipeplans[b]

    def _n_micro(self, batch: int) -> int:
        """The microbatch count the pipeline of ``batch`` runs."""
        mb = self.options.microbatch
        return self.pipeline_plan(batch).n_micro if mb == "auto" else int(mb)

    def pipeline_executor(self, batch: Optional[int] = None):
        """The (cached) PipelineExecutor for one batch size, its stages on
        the first ``options.pipeline_stages`` of ``devices()``."""
        from repro_torch.distributed.pipeline import PipelineExecutor

        b = int(batch) if batch is not None else self.options.batch
        if b not in self._pipe_executors:
            if self.options.validate != "off":
                self._verify_pipeline_gate(b)
            self._pipe_executors[b] = PipelineExecutor(
                self.network_plan(b), self.pipeline_plan(b), self.params,
                devices=self.devices(),
                pretransform=self.options.pretransform,
                calibration=self.calibration, n_micro=self._n_micro(b))
            self.save_plans()
        return self._pipe_executors[b]

    def _prepared(self, batch: int):
        """(prepared params, pretransform flags) of the plan at ``batch``:
        the executor's own where it holds them on one device, else prepared
        here on ``options.device`` as an executor prepares them."""
        from repro_torch.core.netplan import (
            prepare_net_params,
            pretransform_flags,
        )

        netplan = self.network_plan(batch)
        ex = self._executors.get(batch)
        if ex is not None and ex.params is not None:
            return ex.params, ex.pretransformed
        prepared = prepare_net_params(netplan, self.params,
                                      pretransform=self.options.pretransform,
                                      calibration=self.calibration)
        return prepared, pretransform_flags(netplan,
                                            self.options.pretransform)

    def verify_report(self, batch: Optional[int] = None,
                      level: Optional[str] = None):
        """Statically verify this compilation (repro_torch/analysis).

        Runs the plan verifier over the plan of ``batch`` and, beyond
        ``level='plan'``, over one forward recorded on zeros with the
        prepared params the executor runs (on ``options.device``: on the
        card the kernels launch, on the CPU their plain versions run), and
        returns the ``VerifyReport``.  ``level`` defaults to 'full'.
        Independent of ``options.validate``: that option makes every
        executor gate on this report; this method only produces it.
        """
        from repro_torch.analysis import verify_network

        lvl = level if level not in (None, "off") else "full"
        b = int(batch) if batch is not None else self.options.batch
        netplan = self.network_plan(b)
        if lvl == "plan":
            return verify_network(netplan, level="plan",
                                  name=self.model.name)
        params, flags = self._prepared(b)
        return verify_network(netplan, params, pretransformed=flags,
                              level=lvl, name=self.model.name)

    def _verify_pipeline_gate(self, batch: int) -> None:
        """The pipeline executor's gate: ``verify_pipeline`` of the stage
        partition the executor runs (its microbatch count), at 'kernel'
        under ``validate`` 'kernel' or 'full' (each stage's forward
        recorded at microbatch size), else at 'plan'."""
        import dataclasses

        from repro_torch.analysis import PlanVerificationError, verify_pipeline

        pipeplan = dataclasses.replace(self.pipeline_plan(batch),
                                       n_micro=self._n_micro(batch))
        kw = {}
        lvl = ("kernel" if self.options.validate in ("kernel", "full")
               else "plan")
        if lvl == "kernel":
            params, flags = self._prepared(batch)
            kw = dict(params=params, pretransformed=flags)
        report = verify_pipeline(self.network_plan(batch), pipeplan,
                                 name=self.model.name, level=lvl, **kw)
        self.reports[("pipeline", batch)] = report
        if not report.ok:
            raise PlanVerificationError(report)

    def _executor_for(self, batch: Optional[int] = None):
        """The executor ``run()`` and serving use: the pipeline's when
        ``options.pipeline_stages`` is set, the (maybe sharded)
        NetworkExecutor's otherwise."""
        if self.options.pipeline_stages >= 2:
            return self.pipeline_executor(batch)
        return self.executor(batch)

    def run(self, x) -> torch.Tensor:
        """Whole-network inference on a (B, H, W, C) batch (tensor or
        array), cast to ``options.input_dtype``, on ``options.device``: on
        the card a replay of the batch's CUDA graph (``NetworkExecutor``;
        each shard's or stage's graph under ``shard_batch`` or
        ``pipeline_stages``); ``executor(b).eager(x)`` runs the same
        forward eagerly."""
        x = torch.as_tensor(x, device=self.device).to(
            getattr(torch, self.options.input_dtype))
        if x.ndim != 4:
            raise ValueError(
                f"run() expects (B, H, W, C), got shape {tuple(x.shape)}"
            )
        return self._executor_for(int(x.shape[0]))(x.contiguous())

    def __call__(self, x) -> torch.Tensor:
        return self.run(x)

    def serve(self, buckets: Optional[Sequence[int]] = None, **kw):
        """A ``CNNServingEngine`` on this compilation: one executor (on the
        card one CUDA graph; a pipeline of them under ``pipeline_stages``)
        per bucket of ``buckets`` (None:
        ``options.buckets``), each planned and captured now; admission,
        deadlines and retries from the options.  ``clock=`` and
        ``faults=`` pass through."""
        from repro_torch.serving.cnn_engine import CNNServingEngine

        return CNNServingEngine.from_compiled(self, buckets=buckets, **kw)

    def plan_report(self, batch: Optional[int] = None) -> Dict[str, Any]:
        """The resolved per-layer decisions, machine-readable.  Under
        ``pipeline_stages`` every row gains a ``stage`` column and the
        report a ``pipeline`` block: the stage bounds, each stage's
        predicted seconds, the microbatch count the executor runs, the
        modeled bubble fraction and latency at it, and
        ``pipeline_hits``."""
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
        report = {
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
        if self.options.pipeline_stages >= 2:
            pipe = self.pipeline_plan(netplan.batch)
            n_micro = self._n_micro(netplan.batch)
            for row in rows:
                row["stage"] = next(s for s, (a, z)
                                    in enumerate(pipe.stage_bounds)
                                    if a <= row["index"] < z)
            report["pipeline"] = {
                "n_stages": pipe.n_stages,
                "stage_bounds": [list(b) for b in pipe.stage_bounds],
                "stage_seconds": list(pipe.stage_seconds),
                "n_micro": n_micro,
                "bubble_fraction": pipe.bubble_fraction(n_micro),
                "modeled_latency_s": pipe.modeled_latency_s(n_micro),
                "pipeline_hits": self.planner.pipeline_hits,
            }
        return report


class CompiledLM:
    """An LM config compiled through the same facade: the full-sequence
    forward for ``run`` (every attention through the flash-attention
    kernel under ``impl='cuda'``, its plain version under
    ``impl='torch'``), the continuous-batching engine for ``serve``.  The
    model computes in ``cfg.dtype``.

    On the card ``run`` replays a CUDA graph of the forward
    (``graphs.CapturedCall``), one per input signature (the (B, S) token
    shape, or the keys and shapes of a model-input dict), captured at its
    first call, as ``jax.jit`` keeps one trace per shape.  The
    graphs share one memory pool: they replay one at a time and each call
    clones its logits, so a later capture reuses the activations of the
    earlier ones, and the pool holds about the largest shape's forward
    plus each graph's static logits, where the eager forward frees its
    activations after each call.  ``eager`` runs the forward eagerly."""

    def __init__(self, cfg, params, options: ExecutionOptions):
        from repro_torch.models import transformer as tf

        if options.dtype != "float32":
            raise ValueError(f"dtype={options.dtype!r} applies to CNNs; an LM "
                             f"computes in its config's dtype ({cfg.dtype})")
        self.model = cfg
        self.options = options
        self.device = torch.device(options.device)
        self._tf = tf
        self.params = tf.tree_map(lambda t: t.to(self.device), params)
        self._graphs: Dict[Tuple[Any, ...], Any] = {}
        self._pool = None

    def _inputs(self, inputs) -> Dict[str, torch.Tensor]:
        """The model-input dict on the device: (B, S) tokens (a tensor or
        an array) become ``{"tokens"}``; a dict's ``tokens`` are int64,
        its ``frames`` and ``patch_embeds`` kept in their float type."""
        if not isinstance(inputs, dict):
            tokens = torch.as_tensor(inputs, device=self.device).long()
            if tokens.ndim != 2:
                raise ValueError(f"run() expects (B, S) tokens, got shape "
                                 f"{tuple(tokens.shape)}")
            return {"tokens": tokens}
        batch = {}
        for k, v in sorted(inputs.items()):
            t = torch.as_tensor(v, device=self.device)
            batch[k] = t.long() if k == "tokens" else t
        return batch

    def eager(self, inputs) -> torch.Tensor:
        """The full-sequence forward, run eagerly."""
        batch = self._inputs(inputs)
        with torch.inference_mode():
            return self._tf.forward(self.model, self.params, batch,
                                    impl=self.options.impl)

    def run(self, inputs) -> torch.Tensor:
        """Full-sequence logits: (B, S) int tokens (tensor or array), or a
        model-input dict for the frontend archs (``{"frames"}``,
        ``{"tokens", "patch_embeds"}``) -> (B, S, V) in ``cfg.dtype``, on
        ``options.device``."""
        batch = self._inputs(inputs)
        if self.device.type != "cuda":
            return self.eager(batch)
        keys = tuple(batch)
        sig = tuple((k, tuple(t.shape), t.dtype) for k, t in batch.items())
        if sig not in self._graphs:
            from repro_torch.graphs import CapturedCall

            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._graphs[sig] = CapturedCall(
                lambda *ts: self.eager(dict(zip(keys, ts))),
                tuple(batch.values()),
                f"the {self.model.name} forward at "
                + ", ".join(f"{k} {tuple(t.shape)}" for k, t in batch.items()),
                pool=self._pool)
        return self._graphs[sig](*batch.values())

    def __call__(self, inputs) -> torch.Tensor:
        return self.run(inputs)

    def serve(self, batch_size: Optional[int] = None, capacity: int = 256,
              **engine_opts):
        """A continuous-batching ServingEngine for this model;
        ``batch_size`` defaults to ``options.batch``, admission, deadlines
        and retries come from the options (``engine_opts`` win).  An
        encoder-only model has no decode step: ValueError."""
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
    devices: Optional[Sequence[Any]] = None,
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
    file's persistence); None, a planner of ``options``.  So is
    ``devices``, a CNN's batch shards or pipeline stages
    (``options.shard_batch``, ``options.pipeline_stages``): a list of
    devices, where one may repeat; None, every visible card.
    """
    opts = options if options is not None else ExecutionOptions()
    if is_lm_config(model):
        if devices is not None:
            raise ValueError("devices= shards or pipelines a CNN; an LM "
                             "runs on options.device")
        return CompiledLM(model, params, opts)
    return CompiledCNN(model, params, opts, calibration=calibration,
                       planner=planner, devices=devices)


def load(path: str, model: Any, params: Any, planner=None,
         calibration: Optional[Any] = None,
         devices: Optional[Sequence[Any]] = None):
    """Rebuild a compiled model from a ``save`` artifact: a CNN's saved
    whole-network plans and stage partitions go into its planner
    (``planner``, or one of the saved options), so it re-tunes and
    re-partitions nothing, with or without a plan cache; ``devices`` as
    ``compile``'s.
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
                       planner=planner, networks=data.get("networks"),
                       pipelines=data.get("pipelines"), devices=devices)

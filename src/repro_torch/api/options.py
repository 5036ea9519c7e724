"""ExecutionOptions: the option surface of the ``repro_torch`` facade.

The port of ``repro/api/options.py``, cut to what the port runs: no
``fallback`` (the port's serving engines have one rung, the kernels, and
a batch that fails on them after its retries fails its requests), and no
VMEM budget (the verifier's shared-memory budget is the card's,
``hw.H100.smem_per_block_bytes``).  ``validate`` gates every executor on
the port's plan verifier (repro_torch/analysis).  The devices a compiled
model runs on are a runtime resource, not an option (``compile(...,
devices=)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

_IMPLS = ("cuda", "torch")
_MODES = ("cost", "measure", "model")
_DTYPES = ("float32", "bfloat16", "float16", "int8")
_VALIDATE = ("off", "plan", "kernel", "full")


def normalize_buckets(buckets) -> Tuple[int, ...]:
    """Serving batch sizes, sorted and deduplicated; ValueError unless a
    non-empty set of positive integers."""
    if not buckets or any(int(b) <= 0 for b in buckets):
        raise ValueError(f"buckets must be a non-empty tuple of positive "
                         f"batch sizes, got {buckets!r}")
    return tuple(sorted({int(b) for b in buckets}))


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Every execution decision for one compiled model.

      impl          'cuda' (default): the hand-written CUDA kernels;
                    'torch': their plain PyTorch versions, on any device
                    (for tests, and for holding the kernels to account).
      device        where parameters and activations live; 'cuda' by
                    default.  The CPU is used only when asked for
                    (``device='cpu', impl='torch'``).
      mode          'cost' (default): the reference planner's rule
                    (core/cost_rule.py);
                    'model': the card's co-design cost model
                    (core/codesign.py) prices each candidate's launches
                    and keeps the cheapest, and gates int8 by it;
                    'measure': time every eligible algorithm (and, under
                    impl='cuda', both Winograd realizations) per layer on
                    ``device`` and keep the fastest (paper §VII.A).
      winograd_fused
                    the Winograd realization policy: None (default) lets
                    the planner choose (the fused kernel in cost mode, the
                    faster in measure mode); True forces the fused kernel,
                    False the 3-pass pipeline (input transform, tuple
                    multiply, output transform), which cost mode then
                    weighs against im2col.
      batch         the batch size planned and prepared by ``compile``.
      pretransform  apply the offline Winograd weight transform during
                    parameter preparation (paper §VII.A excludes it from
                    timing); the flag is carried explicitly.
      cache_path    the plan cache file (core/planner.py): plans and
                    whole-network entries persist there, so a later
                    compile of the same model re-tunes nothing; None
                    (default): plans live in memory only.
      dtype         'float32' (default); 'bfloat16' or 'float16': the
                    batch is cast to it (``input_dtype``), activations
                    between layers are stored in it, every conv runs the
                    16-bit kernels (products summed in fp32, rounded once
                    at the store) on weights rounded to it once, offline
                    (the reference keeps fp32 weights; the tensor cores
                    need both operands in 16 bits), and an fc head
                    promotes to fp32, as the reference's does; or 'int8':
                    quantized inference, resolved per layer by the
                    planner's int8 gate (a layer where int8 does not pay
                    stays fp32); int8 layers run the int8 kernels on
                    inputs quantized at their entry with scales
                    calibrated in ``compile``.  Inputs stay fp32.
      buckets       the serving engine's batch sizes (``serve()``), sorted
                    and deduplicated: one planned forward, and on the card
                    one CUDA graph, each.
      max_queue     admission bound of the serving engines: ``submit``
                    raises ``Backpressure`` once this many requests wait
                    (None: unbounded).
      default_deadline_s
                    a request's deadline, in seconds from its ``submit``,
                    when it names none (None: no deadline); an expired
                    request gets a ``DeadlineExceeded`` result.
      retries       calls of a failed batch again on the same kernels
                    (>= 0) before its requests fail with ``RequestFailed``.
      shard_batch   True (default): shard a batch over the compiled
                    model's devices (``compile(..., devices=)``, default
                    every visible card) when there is more than one and
                    the batch divides their count; False: the first device
                    only.
      pipeline_stages
                    layer-pipelined execution over that many of the
                    devices (0, the default: off; else at least 2): the
                    network is cut into contiguous stages balanced on
                    each step's predicted seconds
                    (core/netplan.partition_network), cached in the plan
                    cache, and run by GPipe's schedule
                    (distributed/pipeline.py), each stage's params on its
                    device only.
      microbatch    the pipeline's microbatch count: 'auto' (default, the
                    count of least modeled latency,
                    core/netplan.choose_n_micro) or a positive int that
                    must divide the batch.  Unused while
                    ``pipeline_stages`` is 0.
      validate      static plan verification (repro_torch/analysis) that
                    gates every executor ``compile`` builds, serving
                    buckets and pipelines included: 'off' (default: no
                    verification; every forward runs as without the
                    option), 'plan' (each planned launch's shared memory
                    against the card's budget and the cost model's figure,
                    and the layout decisions; no forward), 'kernel' (one
                    forward recorded on zeros: its launches against the
                    plan's, each output element written once, read windows
                    inside their operands, split partials summed once in
                    order, int8 sums within int32), or 'full' (everything:
                    also shared memory, traffic, the channel census and
                    the precisions of the recorded launches).  A report
                    with an error raises ``PlanVerificationError`` and the
                    executor is not kept.
    """

    impl: str = "cuda"
    device: str = "cuda"
    mode: str = "cost"
    winograd_fused: Optional[bool] = None
    batch: int = 1
    pretransform: bool = True
    dtype: str = "float32"
    cache_path: Optional[str] = None
    buckets: Tuple[int, ...] = (1, 4, 8)
    max_queue: Optional[int] = None
    default_deadline_s: Optional[float] = None
    retries: int = 1
    shard_batch: bool = True
    pipeline_stages: int = 0
    microbatch: Any = "auto"            # 'auto' | positive int
    validate: str = "off"

    def __post_init__(self) -> None:
        if self.validate not in _VALIDATE:
            raise ValueError(
                f"validate must be one of {_VALIDATE}, got {self.validate!r}"
            )
        if self.impl not in _IMPLS:
            raise ValueError(f"impl must be one of {_IMPLS}, got {self.impl!r}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.winograd_fused not in (None, True, False):
            raise ValueError(f"winograd_fused must be None, True or False, "
                             f"got {self.winograd_fused!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {self.dtype!r}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        object.__setattr__(self, "buckets", normalize_buckets(self.buckets))
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be None or >= 1, got {self.max_queue}")
        if self.default_deadline_s is not None and self.default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be None or > 0, got "
                f"{self.default_deadline_s}")
        if self.pipeline_stages < 0 or self.pipeline_stages == 1:
            raise ValueError(
                f"pipeline_stages must be 0 (off) or >= 2, got "
                f"{self.pipeline_stages}")
        if self.microbatch != "auto" and (
                not isinstance(self.microbatch, int) or self.microbatch < 1):
            raise ValueError(
                f"microbatch must be 'auto' or a positive int, got "
                f"{self.microbatch!r}")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device!r} requested but no CUDA device is "
                f"available; pass device='cpu', impl='torch' to run the "
                f"plain versions on the CPU"
            )
        if self.impl == "cuda" and dev.type != "cuda":
            raise ValueError(
                f"impl='cuda' runs the CUDA kernels and needs a CUDA "
                f"device, got device={self.device!r}"
            )

    @property
    def input_dtype(self) -> str:
        """The dtype ``run()`` casts incoming batches to: ``dtype``, except
        under int8, an internal precision whose layers quantize their own
        fp32 inputs (the reference's property)."""
        return "float32" if self.dtype == "int8" else self.dtype

    # -- persistence (CompiledCNN.save and load ride this) -------------------

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["buckets"] = list(self.buckets)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ExecutionOptions":
        """The options of ``to_json``'s dict; a field it lacks (an artifact
        saved before the field existed) takes its default."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def make_planner(self):
        """A Planner with this option set's policy fields and cache file."""
        from repro_torch.core.planner import Planner

        return Planner(impl=self.impl, mode=self.mode,
                       winograd_fused=self.winograd_fused,
                       device=self.device, cache_path=self.cache_path)

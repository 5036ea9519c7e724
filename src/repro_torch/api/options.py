"""ExecutionOptions: the option surface of the ``repro_torch`` facade.

The port of ``repro/api/options.py``, cut to what the port runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

_IMPLS = ("cuda", "torch")
_MODES = ("cost", "measure", "model")
_DTYPES = ("float32", "bfloat16", "float16", "int8")


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Every execution decision for one compiled model.

      impl          'cuda' (default): the hand-written CUDA kernels;
                    'torch': their plain PyTorch versions, on any device
                    (for tests, and for holding the kernels to account).
      device        where parameters and activations live; 'cuda' by
                    default.  The CPU is used only when asked for
                    (``device='cpu', impl='torch'``).
      mode          'cost' (default): the planner's tile rule;
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
                    multiply, output transform).
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
    """

    impl: str = "cuda"
    device: str = "cuda"
    mode: str = "cost"
    winograd_fused: Optional[bool] = None
    batch: int = 1
    pretransform: bool = True
    dtype: str = "float32"
    cache_path: Optional[str] = None

    def __post_init__(self) -> None:
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
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ExecutionOptions":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def make_planner(self):
        """A Planner with this option set's policy fields and cache file."""
        from repro_torch.core.planner import Planner

        return Planner(impl=self.impl, mode=self.mode,
                       winograd_fused=self.winograd_fused,
                       device=self.device, cache_path=self.cache_path)

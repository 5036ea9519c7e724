"""ExecutionOptions: the option surface of the ``repro_torch`` facade.

The port of ``repro/api/options.py``, cut to what this slice runs.
"""
from __future__ import annotations

import dataclasses

import torch

_IMPLS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Every execution decision for one compiled model.

      impl          'cuda' (default): the hand-written CUDA kernels;
                    'torch': their plain PyTorch versions, on any device
                    (for tests, and for holding the kernels to account).
      device        where parameters and activations live; 'cuda' by
                    default.  The CPU is used only when asked for
                    (``device='cpu', impl='torch'``).
      batch         the batch size planned and prepared by ``compile``.
      pretransform  apply the offline Winograd weight transform during
                    parameter preparation (paper §VII.A excludes it from
                    timing); the flag is carried explicitly.
    """

    impl: str = "cuda"
    device: str = "cuda"
    batch: int = 1
    pretransform: bool = True

    def __post_init__(self) -> None:
        if self.impl not in _IMPLS:
            raise ValueError(f"impl must be one of {_IMPLS}, got {self.impl!r}")
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

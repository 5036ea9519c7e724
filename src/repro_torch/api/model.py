"""The facade's model descriptors: a Darknet-style layer table plus its
input geometry (the port of ``repro/api/model.py``'s ``CNNModel``), and
``is_lm_config`` for the LM configs."""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class CNNModel:
    """A CNN as the facade sees it: layer table + input geometry."""

    layers: Tuple[Any, ...]
    input_hw: Tuple[int, int]
    in_channels: int = 3
    name: str = "cnn"

    def __post_init__(self) -> None:
        object.__setattr__(self, "layers", tuple(self.layers))
        object.__setattr__(self, "input_hw", tuple(self.input_hw))
        if len(self.input_hw) != 2:
            raise ValueError(f"input_hw must be (H, W), got {self.input_hw!r}")

    @property
    def digest(self) -> str:
        """The layer table's digest: the identity the network cache keys
        on (core/netplan.network_key); ``load`` refuses a model whose
        digest is not the saved one."""
        return hashlib.sha1(repr(tuple(self.layers)).encode()).hexdigest()[:16]


def is_lm_config(model: Any) -> bool:
    """True for an LM ``ModelConfig`` (duck-typed, as the reference, so the
    facade never imports the LM stack for CNN work)."""
    return hasattr(model, "supports_decode") and hasattr(model, "layer_pattern")

"""The facade's model descriptor: a Darknet-style layer table plus its
input geometry (the port of ``repro/api/model.py``'s ``CNNModel``)."""
from __future__ import annotations

import dataclasses
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

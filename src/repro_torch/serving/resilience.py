"""The serving layer's typed errors and prompt validation: the port of the
parts of ``repro/serving/resilience.py`` the LM engine uses.

Deadlines, backpressure and the fallback ladder are not ported
(ROADMAP.md, queue 1, item 4): a failure on the card raises.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


class ServingError(Exception):
    """Base of every typed serving-layer error."""


class InvalidRequest(ServingError, ValueError):
    """``submit`` rejected the payload before it could poison a batch."""


class QueueNotDrained(ServingError, RuntimeError):
    """``run(max_steps)`` exhausted its step budget with work still queued.

    Carries the partial results and the remaining uids so no request is
    silently lost.
    """

    def __init__(self, results: Dict[int, Any], remaining: Sequence[int],
                 max_steps: int):
        self.results = dict(results)
        self.remaining = list(remaining)
        super().__init__(
            f"queue not drained after {max_steps} steps: "
            f"{len(self.remaining)} request(s) remaining "
            f"(uids {self.remaining[:8]}{'...' if len(self.remaining) > 8 else ''}); "
            f"partial results for {len(self.results)} request(s) are on "
            f".results"
        )


def validate_prompt(prompt: Any, vocab_size: int) -> np.ndarray:
    """Admission-time payload validation for LM prompt requests: a
    non-empty integer token array inside the vocabulary, as int32."""
    arr = np.asarray(prompt)
    if arr.dtype.kind == "f":
        raise InvalidRequest(
            f"prompt must be an integer token array, got {arr.dtype} "
            f"(non-finite or fractional values would corrupt the embedding "
            f"lookup)"
        )
    if arr.dtype.kind not in "iu":
        raise InvalidRequest(
            f"prompt must be an integer token array, got {arr.dtype}"
        )
    if arr.size == 0:
        raise InvalidRequest(
            "empty prompt: decode needs at least one token to condition on"
        )
    arr = arr.astype(np.int32)
    if (arr < 0).any() or (arr >= vocab_size).any():
        raise InvalidRequest(
            f"prompt tokens out of range [0, {vocab_size}): "
            f"min={int(arr.min())} max={int(arr.max())}"
        )
    return arr

"""Deterministic fault injection for the serving resilience machinery.

The port of ``repro/serving/faults.py``.  A ``FaultPlan`` is a seeded,
finite script of faults (an exception instead of the call, NaN or Inf
output rows, a latency spike, a corrupted plan-cache file) matched against
(step, bucket) at each guarded call, so a test can say "step 3,
bucket 4 raises" and then check what the engine made of it.  Engines take
``faults=None`` by default and then draw nothing.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """The exception raised by an ``exception``-kind fault."""


VALID_KINDS = ("exception", "nan", "inf", "latency", "corrupt_cache")


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault.

    ``step``/``bucket`` select where it fires (None: any);
    ``times`` bounds how many matching calls it poisons.  ``rows`` limits
    nan/inf poisoning to those batch rows (None: every row).
    """

    kind: str
    step: Optional[int] = None
    bucket: Optional[Any] = None
    times: int = 1
    rows: Optional[Tuple[int, ...]] = None
    latency_s: float = 0.0
    path: Optional[str] = None
    note: str = ""

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{VALID_KINDS}"
            )
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")
        if self.rows is not None:
            self.rows = tuple(int(r) for r in self.rows)

    def matches(self, step: int, bucket: Any) -> bool:
        return ((self.step is None or self.step == step)
                and (self.bucket is None or self.bucket == bucket))


class FaultPlan:
    """A finite, ordered script of faults drawn against (step, bucket).
    ``draw`` returns the first matching spec with budget left
    (spending one) or None; every draw is appended to ``log``."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self._arms: List[List] = [[s, s.times] for s in specs]
        self.log: List[Tuple[int, Any, Optional[FaultSpec]]] = []

    @property
    def specs(self) -> List[FaultSpec]:
        return [arm[0] for arm in self._arms]

    @property
    def exhausted(self) -> bool:
        """True once every scripted fault has fired its full budget."""
        return all(left == 0 for _, left in self._arms)

    @property
    def injected(self) -> int:
        """Number of draws that returned a fault."""
        return sum(1 for *_k, spec in self.log if spec is not None)

    def draw(self, step: int, bucket: Any) -> Optional[FaultSpec]:
        for arm in self._arms:
            spec, left = arm
            if left > 0 and spec.matches(step, bucket):
                arm[1] = left - 1
                self.log.append((step, bucket, spec))
                return spec
        self.log.append((step, bucket, None))
        return None

    @classmethod
    def seeded(
        cls,
        seed: int,
        n_faults: int,
        steps: int,
        kinds: Sequence[str] = ("exception", "nan", "inf", "latency"),
        buckets: Sequence[Any] = (None,),
    ) -> FaultPlan:
        """A reproducible random plan: the same seed, the same script."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(int(n_faults)):
            kind = str(rng.choice(list(kinds)))
            bucket = buckets[int(rng.integers(len(buckets)))]
            specs.append(
                FaultSpec(
                    kind=kind,
                    step=int(rng.integers(1, max(2, steps + 1))),
                    bucket=bucket,
                    latency_s=float(rng.uniform(0.01, 0.2))
                    if kind == "latency"
                    else 0.0,
                    note=f"seeded(seed={seed})",
                )
            )
        return cls(specs)


class FakeClock:
    """Injectable monotonic clock: tests advance time explicitly, so
    deadline expiry and latency spikes are deterministic."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> float:
        self.now += float(seconds)
        return self.now


def corrupt_cache_file(path: str, mode: str = "truncate", seed: int = 0) -> None:
    """Corrupt a plan-cache file on disk, deterministically: ``truncate``
    cuts it mid-JSON (a writer that crashed), ``garbage`` overwrites a
    span with seeded noise."""
    with open(path, "rb") as f:
        data = f.read()
    if mode == "truncate":
        corrupted = data[: max(1, int(len(data) * 0.6))]
    elif mode == "garbage":
        rng = np.random.default_rng(seed)
        buf = bytearray(data)
        n = max(1, len(buf) // 8)
        start = len(buf) // 3
        for i in range(start, min(len(buf), start + n)):
            buf[i] = int(rng.integers(0, 256))
        corrupted = bytes(buf)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    tmp = f"{path}.tmp-corrupt-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(corrupted)
    os.replace(tmp, path)


def _poison(out: Any, value: float, rows: Optional[Tuple[int, ...]]) -> Any:
    """A clone of an output tensor, on its device, with ``rows`` (None:
    all) set to ``value`` (NaN or Inf); of a tuple, its first element."""
    if isinstance(out, tuple):
        return (_poison(out[0], value, rows),) + tuple(out[1:])
    out = out.clone()
    if rows is None:
        out.fill_(value)
    else:
        for r in rows:
            if 0 <= r < out.shape[0]:
                out[r] = value
    return out


def apply_fault(
    spec: FaultSpec,
    fn: Callable,
    args: Tuple,
    clock: Optional[Callable[[], float]] = None,
) -> Any:
    """Run one guarded call under ``spec``.

    exception      raise InjectedFault instead of calling ``fn``
    nan / inf      call ``fn``, poison the selected output rows
    latency        advance the injectable clock (or sleep briefly on a real
                   one), then call ``fn``
    corrupt_cache  corrupt ``spec.path`` on disk, then call ``fn``
    """
    if spec.kind == "exception":
        raise InjectedFault(
            f"injected executor exception ({spec.note or 'scripted'})"
        )
    if spec.kind == "latency":
        if hasattr(clock, "advance"):
            clock.advance(spec.latency_s)
        elif spec.latency_s > 0:
            time.sleep(min(spec.latency_s, 0.05))
        return fn(*args)
    if spec.kind == "corrupt_cache":
        if spec.path:
            corrupt_cache_file(spec.path)
        return fn(*args)
    out = fn(*args)
    return _poison(out, float("nan") if spec.kind == "nan" else float("inf"),
                   spec.rows)

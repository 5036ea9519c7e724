"""Serving resilience: admission, deadlines, retries and typed failures.

The port of ``repro/serving/resilience.py``, the machinery both serving
engines (``serving/cnn_engine.py``, ``serving/engine.py``) thread through:

  admission     ``submit(deadline_s=, priority=)`` raises a typed
                ``Backpressure`` once the queue holds
                ``ExecutionOptions.max_queue`` requests, and validates the
                payload (shape, dtype, finiteness) before it can poison a
                co-batched padded batch.
  deadlines     a request may carry an absolute deadline (its own
                ``deadline_s`` or ``ExecutionOptions.default_deadline_s``
                after ``submit``); the engines evict expired requests with
                a ``DeadlineExceeded`` result instead of serving stale
                work.  The clock is injectable (``faults.FakeClock``).
  retries       every batch runs through ``_guarded_call``: an exception,
                or an output whose every live row is non-finite, is called
                again on the same kernels, ``retries`` times; then the
                batch's requests fail with ``RequestFailed``.  Rows that
                stay non-finite while the rest of the batch is finite fail
                alone.  The engine lives on.
  health        ``engine.health()`` counts evictions, rejections, retries,
                failed requests and batches, and injected faults.

The reference's fallback ladder below its first rung (Pallas interpret
mode, then XLA's fp32 forward for CNNs; eager decode for LMs) and its
circuit breaker are not ported: the port has one rung, its kernels
(``health()["ladder"] == ["primary"]``), and nothing falls back to a plain
version or to the CPU.  A failure that leaves the card unusable (an
illegal address kills the CUDA context) is not retried: it raises out of
the engine.

With the default options (``max_queue=None``, ``default_deadline_s=None``)
and no faults all of it is inert, and a batch's rows are the compiled
forward's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Typed errors and per-request failure results


class ServingError(Exception):
    """Base of every typed serving-layer error."""


class Backpressure(ServingError, RuntimeError):
    """``submit`` rejected: the admission queue is at ``max_queue``."""

    def __init__(self, queue_len: int, max_queue: int):
        self.queue_len = queue_len
        self.max_queue = max_queue
        super().__init__(
            f"admission queue full ({queue_len}/{max_queue}); retry later "
            f"or raise ExecutionOptions.max_queue"
        )


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


class _BatchFailed(ServingError, RuntimeError):
    """A batch failed every attempt (surfaces to the caller as per-request
    ``RequestFailed`` results, never as an engine crash)."""


class _NonFiniteOutput(Exception):
    """An attempt whose every live output row is non-finite: treated as
    one that raised."""


@dataclasses.dataclass(frozen=True)
class DeadlineExceeded:
    """Result marker: the request expired and was evicted."""

    uid: int
    deadline: float
    now: float

    @property
    def ok(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class RequestFailed:
    """Result marker: this request failed (its output row stayed
    non-finite, or its batch failed every attempt)."""

    uid: int
    reason: str

    @property
    def ok(self) -> bool:
        return False


def is_failure(result: Any) -> bool:
    """True for the typed failure results (DeadlineExceeded/RequestFailed)."""
    return isinstance(result, (DeadlineExceeded, RequestFailed))


# ---------------------------------------------------------------------------
# The mixin both engines thread through


class ResilientEngine:
    """Admission, deadline and retry machinery shared by the CNN bucket
    engine and the LM decode engine.

    The host engine calls ``_resilience_init`` once, implements
    ``_collect(out) -> (out, bad_rows)`` (the per-row non-finite mask,
    computed where ``out`` lies, and whatever copy of ``out`` the engine
    reads, both ready on return, so that a fault of the card's work shows
    inside the call) and routes every batch through ``_guarded_call``.
    """

    def _resilience_init(
        self,
        *,
        max_queue: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        retries: int = 1,
        clock: Optional[Callable[[], float]] = None,
        faults=None,
        device: Any = "cpu",
    ) -> None:
        self._max_queue = None if max_queue is None else int(max_queue)
        self._default_deadline_s = (
            None if default_deadline_s is None else float(default_deadline_s)
        )
        self._retries = max(0, int(retries))
        self._clock = clock if clock is not None else time.monotonic
        self._device = torch.device(device)
        self.faults = faults
        self._step_index = 0
        self._bucket_stats: Dict[Any, Dict[str, int]] = {}
        self._res_stats = {
            "evictions": 0,
            "rejections": 0,
            "retries": 0,
            "request_failures": 0,
            "failed_batches": 0,
            "faults_injected": 0,
        }

    # -- admission / deadlines ------------------------------------------------

    def _now(self) -> float:
        return float(self._clock())

    def _check_admission(self, queue_len: int) -> None:
        if self._max_queue is not None and queue_len >= self._max_queue:
            self._res_stats["rejections"] += 1
            raise Backpressure(queue_len, self._max_queue)

    def _absolute_deadline(
        self, deadline_s: Optional[float]
    ) -> Optional[float]:
        d = deadline_s if deadline_s is not None else self._default_deadline_s
        if d is None:
            return None
        if d <= 0:
            raise InvalidRequest(f"deadline_s must be > 0, got {d}")
        return self._now() + float(d)

    def _split_expired(self, requests, now: float):
        """(live, {uid: DeadlineExceeded}) partition of ``requests``."""
        live, evicted = [], {}
        for r in requests:
            if r.deadline is not None and now >= r.deadline:
                evicted[r.uid] = DeadlineExceeded(
                    uid=r.uid, deadline=r.deadline, now=now
                )
                self._res_stats["evictions"] += 1
            else:
                live.append(r)
        return live, evicted

    # -- the guarded call -----------------------------------------------------

    def _collect(self, out: Any) -> Tuple[Any, Optional[np.ndarray]]:
        raise NotImplementedError       # engine-specific

    def _invoke(self, key, fn: Callable, args: Tuple):
        """One call, with the fault-injection hook applied."""
        if self.faults is not None:
            from repro_torch.serving.faults import apply_fault

            fault = self.faults.draw(step=self._step_index, bucket=key)
            if fault is not None:
                self._res_stats["faults_injected"] += 1
                return apply_fault(fault, fn, args, clock=self._clock)
        return fn(*args)

    def _device_lost(self) -> bool:
        """Whether the card can no longer run work: a sticky CUDA error
        (an illegal address, say) fails every later call, so retrying it
        would only hide it."""
        if self._device.type != "cuda":
            return False
        try:
            torch.cuda.synchronize(self._device)
        except Exception:   # noqa: BLE001 - any failure here is the context's
            return True
        return False

    def _guarded_call(
        self, key, fn: Callable, args: Tuple, live: Optional[np.ndarray] = None
    ) -> Tuple[Any, Optional[np.ndarray]]:
        """Run one batch: ``(out, bad_rows)``.

        Calls ``fn`` again, ``retries`` times, after an exception or an
        output whose every live row is non-finite.  Rows that stay
        non-finite while the rest of the batch is finite are returned as
        ``bad_rows`` (None: none) for request-level failure.  Raises
        ``_BatchFailed`` when every attempt failed, and re-raises at once
        an error after which the card runs nothing.
        """
        stats = self._bucket_stats.setdefault(
            key, {"batches": 0, "retries": 0, "failed_batches": 0})
        last_err: Optional[BaseException] = None
        partial: Optional[Tuple[Any, np.ndarray]] = None
        for attempt in range(self._retries + 1):
            if attempt:
                self._res_stats["retries"] += 1
                stats["retries"] += 1
            try:
                out, bad = self._collect(self._invoke(key, fn, args))
            except Exception as e:      # noqa: BLE001 - the whole point
                if self._device_lost():
                    raise
                last_err = e
                continue
            if bad is not None and live is not None:
                # Padded or idle rows hold whatever they hold: only live
                # rows count as poisoned.
                bad = bad & np.asarray(live, bool)
            if bad is not None and bad.any():
                live_bad = bad[live] if live is not None else bad
                if live_bad.size and live_bad.all():
                    last_err = _NonFiniteOutput(
                        "every live output row is non-finite")
                    continue
                partial = (out, bad)
                continue
            stats["batches"] += 1
            return out, None
        if partial is not None:
            # Retries spent, most of the batch fine: serve the finite rows,
            # fail the others at request level.
            stats["batches"] += 1
            return partial
        stats["failed_batches"] += 1
        self._res_stats["failed_batches"] += 1
        raise _BatchFailed(
            f"batch {key!r} failed {self._retries + 1} attempt(s): "
            f"{last_err!r}") from last_err

    # -- health ---------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """Per-bucket batches, retries and failed batches, and the
        engine-wide counters."""
        return {
            # The reference's realizations, fast first: the port has one.
            "ladder": ["primary"],
            "buckets": {str(k): dict(v) for k, v in sorted(
                self._bucket_stats.items(), key=lambda kv: str(kv[0]))},
            "queue_len": len(getattr(self, "queue", ())),
            "steps": self._step_index,
            "max_queue": self._max_queue,
            "default_deadline_s": self._default_deadline_s,
            "retries_allowed": self._retries,
            **self._res_stats,
        }


def validate_image(image: Any, want_shape: Tuple[int, ...]) -> np.ndarray:
    """Admission-time payload validation for image requests: the shape,
    a real numeric dtype, and finite values, checked once at ``submit``
    against the one image rather than per dispatched batch."""
    image = np.asarray(image)
    if image.shape != tuple(want_shape):
        raise InvalidRequest(
            f"expected image shape {tuple(want_shape)}, got {image.shape}"
        )
    if image.dtype.kind not in "fiub":
        raise InvalidRequest(
            f"expected a real numeric image dtype, got {image.dtype}"
        )
    if image.dtype.kind == "f" and not np.isfinite(image).all():
        raise InvalidRequest(
            "image payload contains non-finite values (NaN/Inf): rejected "
            "at submit so it cannot poison a co-batched padded batch"
        )
    return image


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

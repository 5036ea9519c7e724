"""CNN serving engine: dynamic batching into planned batch buckets.

The port of ``repro/serving/cnn_engine.py``.  Image requests are
independent single-image forwards, and the efficient batch size is a
planner's decision (plans are keyed by batch: the im2col-against-Winograd
crossover and the kernels' splits move with it).  The engine batches
requests into a small ladder of batch sizes:

  buckets      (``ExecutionOptions.buckets``, by default 1/4/8).  Each
               bucket is the executor ``CompiledCNN.run`` takes for its
               batch: its own network plan and, on the card, its own CUDA
               graph, all graphs in the compiled model's one memory pool;
               under ``pipeline_stages`` its own pipeline (its own stage
               partition and microbatch count, bucket 1 at one
               microbatch, a graph and a pool for each stage), and under
               ``shard_batch`` over several devices its own shards.  Every
               bucket is planned, warmed up and captured when the engine
               is made, so the first request pays no capture; no other
               batch size is ever planned.
  dispatch     ``submit`` enqueues; ``step`` serves the largest bucket the
               queue fills completely, else the smallest bucket that covers
               what is pending, padded with zero images whose rows are
               dropped.  ``run`` steps until the queue is empty; ``infer``
               is the whole-batch convenience.

Every batch runs through ``ResilientEngine._guarded_call``
(serving/resilience.py): admission control, deadlines, retries on the same
kernels, request-level failure of a non-finite row.  Inside that call the
engine casts the batch to ``options.input_dtype`` (fp32 under int8, whose
layers quantize their own inputs), moves it to the card, replays the
bucket's graph, computes the per-row non-finite mask on the card and
copies the output back: the copy waits for the card, so a fault of the
card's work is charged to the batch that caused it.  Rows come back as
CPU tensors in the forward's output dtype (numpy has no bf16).

``stats`` count each bucket's batches and the padded slots, so a
deployment can check its ladder against its arrivals.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.options import normalize_buckets
from repro_torch.serving.resilience import (
    QueueNotDrained,
    RequestFailed,
    ResilientEngine,
    ServingError,
    _BatchFailed,
    is_failure,
    validate_image,
)


@dataclasses.dataclass
class ImageRequest:
    uid: int
    image: np.ndarray                   # (H, W, C)
    deadline: Optional[float] = None    # absolute, engine-clock seconds
    priority: int = 0                   # higher dispatches first


class CNNServingEngine(ResilientEngine):
    """Batched CNN inference over a fixed ladder of batch sizes, on one
    ``CompiledCNN``'s executors."""

    def __init__(self, compiled, buckets: Optional[Sequence[int]] = None, *,
                 clock=None, faults=None):
        self.compiled = compiled
        self.planner = compiled.planner
        self.input_hw = tuple(compiled.model.input_hw)
        self.in_channels = compiled.model.in_channels
        self.buckets = (compiled.options.buckets if buckets is None
                        else normalize_buckets(buckets))
        self.device = compiled.device
        self.input_dtype = getattr(torch, compiled.options.input_dtype)
        self._executors = {b: compiled._executor_for(b)
                           for b in self.buckets}
        if self.device.type == "cuda":
            for b, ex in self._executors.items():
                ex.capture(torch.zeros((b, *self.input_hw, self.in_channels),
                                       dtype=self.input_dtype,
                                       device=self.device))
        self.queue: List[ImageRequest] = []
        self._uid = 0
        self.stats = {
            "batches": {b: 0 for b in self.buckets},
            "padded_slots": 0,
            "requests": 0,
        }
        opts = compiled.options
        self._resilience_init(
            max_queue=opts.max_queue,
            default_deadline_s=opts.default_deadline_s,
            retries=opts.retries,
            clock=clock,
            faults=faults,
            device=self.device,
        )

    @classmethod
    def from_compiled(cls, compiled, buckets: Optional[Sequence[int]] = None,
                      **kw) -> CNNServingEngine:
        """The facade's path (``CompiledCNN.serve()``): the compilation's
        planner, options and executors; ``clock=`` and ``faults=`` pass
        through."""
        return cls(compiled, buckets, **kw)

    # -- public api ---------------------------------------------------------

    def submit(self, image: Any, deadline_s: Optional[float] = None,
               priority: int = 0) -> int:
        """Enqueue one (H, W, C) image; returns its uid.

        ``deadline_s`` is a budget from now (None: the options' default).
        Raises ``Backpressure`` when the queue is at ``max_queue`` and
        ``InvalidRequest`` (a ValueError) for a wrong shape, a non-numeric
        dtype or a non-finite value.
        """
        self._check_admission(len(self.queue))
        image = validate_image(image, (*self.input_hw, self.in_channels))
        deadline = self._absolute_deadline(deadline_s)
        self._uid += 1
        self.stats["requests"] += 1
        self.queue.append(ImageRequest(self._uid, image, deadline=deadline,
                                       priority=int(priority)))
        return self._uid

    def pick_bucket(self, pending: int) -> int:
        """The largest bucket ``pending`` requests fill, else the smallest
        that covers them."""
        full = [b for b in self.buckets if b <= pending]
        if full:
            return max(full)
        return min(b for b in self.buckets if b >= pending)

    def step(self) -> Dict[int, Any]:
        """Serve one batch from the queue.  Returns uid -> output row (a
        CPU tensor) or a typed ``DeadlineExceeded``/``RequestFailed``
        marker.  Expired requests are evicted first; the rest go in
        priority order, first come first within a priority."""
        if not self.queue:
            return {}
        live_reqs, results = self._split_expired(self.queue, self._now())
        live_reqs.sort(key=lambda r: (-r.priority, r.uid))
        self.queue = live_reqs
        if not self.queue:
            return results
        self._step_index += 1
        bucket = self.pick_bucket(len(self.queue))
        reqs = self.queue[:bucket]
        del self.queue[:len(reqs)]
        pad = bucket - len(reqs)
        batch = np.stack([r.image for r in reqs])
        if pad:
            batch = np.concatenate(
                [batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
            self.stats["padded_slots"] += pad
        live = np.zeros(bucket, bool)
        live[:len(reqs)] = True
        try:
            out, bad_rows = self._guarded_call(
                bucket, self._forward, (bucket, batch), live=live)
        except _BatchFailed as e:
            self._res_stats["request_failures"] += len(reqs)
            for r in reqs:
                results[r.uid] = RequestFailed(uid=r.uid, reason=str(e))
            return results
        self.stats["batches"][bucket] += 1
        for i, r in enumerate(reqs):
            if bad_rows is not None and bad_rows[i]:
                self._res_stats["request_failures"] += 1
                results[r.uid] = RequestFailed(
                    uid=r.uid,
                    reason="non-finite output row survived retries")
            else:
                results[r.uid] = out[i]
        return results

    def run(self, max_steps: int = 10_000) -> Dict[int, Any]:
        """Drain the queue; uid -> output row or failure marker.  Raises
        ``QueueNotDrained`` (partial results and remaining uids attached)
        when ``max_steps`` runs out with work still queued."""
        results: Dict[int, Any] = {}
        for _ in range(max_steps):
            if not self.queue:
                break
            results.update(self.step())
        if self.queue:
            raise QueueNotDrained(results, [r.uid for r in self.queue],
                                  max_steps)
        return results

    def infer(self, images: Any) -> torch.Tensor:
        """Submit a (N, H, W, C) stack, run, and return the outputs in
        submission order, stacked.  Raises ``ServingError`` if a request
        came back as a typed failure."""
        uids = [self.submit(img) for img in np.asarray(images)]
        results = self.run()
        failed = {u: results[u] for u in uids if is_failure(results[u])}
        if failed:
            raise ServingError(
                f"{len(failed)}/{len(uids)} request(s) failed: "
                f"{list(failed.values())[:3]}")
        return torch.stack([results[u] for u in uids])

    @property
    def warm(self) -> bool:
        """True when every bucket planned from the cache (zero tunes)."""
        return self.planner.stats["tunes"] == 0

    # -- the guarded call's parts ------------------------------------------

    def _forward(self, bucket: int, batch: np.ndarray) -> torch.Tensor:
        """The bucket's forward on a host batch: cast, moved to the
        device, the executor (on the card, its graph's replay, or its
        pipeline's or shards' replays)."""
        x = torch.from_numpy(batch).to(device=self.device,
                                       dtype=self.input_dtype)
        return self._executors[bucket](x)

    def _collect(self, out: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
        """The per-row non-finite mask, computed on the output's device,
        and the output on the host; both copies wait for the card."""
        bad = None
        if out.is_floating_point():
            bad = ~torch.isfinite(out.reshape(out.shape[0], -1)).all(dim=1)
            bad = bad.cpu().numpy()
        return out.cpu(), bad

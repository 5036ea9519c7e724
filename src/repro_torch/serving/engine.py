"""Batched LM serving: continuous batching over a fixed decode batch.  The
port of ``repro/serving/engine.py``.

The engine keeps ``batch_size`` decode slots; a finished sequence frees
its slot and a queued request is admitted into it.  Admission feeds the
prompt through slot-local decode steps (only the admitted slot is live;
every other row's cache is masked out of the update), as the reference
does, so serving runs ``transformer.decode_step`` only: its attention is
plain PyTorch against the ring caches, and the flash-attention kernel,
which runs in prefill, is not reached.  A recurrent layer's state
(rglru, mLSTM, sLSTM) passes through the same live mask, and a freed
slot's state is reset with its ring.  Greedy sampling at
``temperature=0``; otherwise a ``torch.Generator`` seeded from ``seed``.

On the card the decode step is one CUDA graph per engine
(``graphs.CapturedCall``, the counterpart of the reference's jitted step),
captured when the engine is made: the batch is fixed, the cache is updated
in place at fixed addresses, and each step copies its tokens, positions
and live mask into the graph's static inputs and replays it.  The graph
also writes, beside the logits, each row's greedy token and whether the
row is finite, so that a served step is one replay and one small copy to
the host: the guarded call's check and the greedy draw.  Admission uses
the same graph with another live mask; resetting a slot's cache rows and
sampling at a temperature (``_sample``, which reads the graph's logits
before the next replay) stay outside it.  On the CPU the step runs
eagerly.
``EagerServingEngine`` is the same engine with the step run eagerly on
either device, for comparison.

The engine threads ``ResilientEngine`` (serving/resilience.py): ``submit``
validates the prompt and applies backpressure and deadlines, admission
goes by priority, an expired request (queued or mid-decode) is evicted
with a ``DeadlineExceeded`` result and frees its slot, and every decode
step runs through ``_guarded_call``, which calls a failed step again on
the same graph and fails a request whose logits row stays non-finite
alone.  A prompt's prefill is one guarded call (one step of a fault
plan, where the reference counts one a token): its decode steps queue
on the card without a wait, the copy after the last one waits once, and
a retry starts the slot over.  Its last step's logits row is the one
checked: the earlier rows are discarded, and a non-finite value in the
cache reaches the last row.  The reference's jit -> eager ladder and
its circuit breaker are not ported: a step that fails its retries fails
its live requests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.serving.resilience import (
    DeadlineExceeded,
    QueueNotDrained,
    RequestFailed,
    ResilientEngine,
    _BatchFailed,
    validate_prompt,
)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    last_token: int = 0          # the token the next decode step feeds
    deadline: Optional[float] = None    # absolute, engine-clock seconds
    priority: int = 0                   # higher admits first


class ServingEngine(ResilientEngine):
    @classmethod
    def from_compiled(cls, compiled, batch_size: Optional[int] = None,
                      capacity: int = 256, **kw) -> ServingEngine:
        """The engine of a facade compilation (``repro_torch.compile(cfg,
        params, options).serve()`` routes here): config, parameters,
        ``impl`` and the admission, deadline and retry options come from
        it (``kw`` wins); the batch defaults to ``options.batch``."""
        opts = compiled.options
        kw.setdefault("impl", opts.impl)
        kw.setdefault("max_queue", opts.max_queue)
        kw.setdefault("default_deadline_s", opts.default_deadline_s)
        kw.setdefault("retries", opts.retries)
        return cls(compiled.model, compiled.params,
                   batch_size=batch_size or opts.batch,
                   capacity=capacity, **kw)

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 capacity: int, temperature: float = 0.0, seed: int = 0,
                 impl: str = "cuda", *,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 retries: int = 1,
                 clock=None,
                 faults=None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                             f"step to serve")
        self.device = params["final_norm"].device
        if impl == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"impl='cuda' serves on the card, got parameters on "
                f"{self.device} (ask for impl='torch' to serve on the CPU)")
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.capacity = capacity
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = tf.init_cache(cfg, batch_size, capacity, self.device)
        # Batch-1 pristine cache: admission resets a freed slot's rows from
        # its row 0.
        self._fresh_cache = tf.init_cache(cfg, 1, capacity, self.device)
        self.pos = np.zeros(batch_size, np.int64)      # per-slot next position
        self.slot_req: List[Optional[Request]] = [None] * batch_size
        self.queue: List[Request] = []
        self._uid = 0
        # The step's (B, 2) summary of its logits (``_summarize``), written
        # where they are (in the graph on the card), and those logits.
        self._summary = torch.zeros((batch_size, 2), dtype=torch.int64,
                                    device=self.device)
        self._stepped: Optional[torch.Tensor] = None
        self._graph = self._capture() if self.device.type == "cuda" else None
        self._resilience_init(max_queue=max_queue,
                              default_deadline_s=default_deadline_s,
                              retries=retries, clock=clock, faults=faults,
                              device=self.device)
        # Request-level failures of admission and decode, drained by run().
        self._failures: Dict[int, Any] = {}

    # -- public api -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               deadline_s: Optional[float] = None, priority: int = 0) -> int:
        """Enqueue one prompt; returns its uid.  ``deadline_s`` is a budget
        from now (None: the options' default).  Raises ``Backpressure``
        when the queue is at ``max_queue`` and ``InvalidRequest`` (a
        ValueError) for an empty, float or out-of-vocabulary prompt."""
        self._check_admission(len(self.queue))
        prompt = validate_prompt(prompt, self.cfg.vocab_size)
        deadline = self._absolute_deadline(deadline_s)
        self._uid += 1
        self.queue.append(Request(self._uid, prompt, max_new_tokens,
                                  deadline=deadline, priority=int(priority)))
        return self._uid

    def run(self, max_steps: int = 10_000) -> Dict[int, Any]:
        """Drive until all submitted requests finish.  Returns uid ->
        generated tokens, or a typed ``DeadlineExceeded``/``RequestFailed``
        marker.  Raises ``QueueNotDrained`` (partial results and remaining
        uids attached) when ``max_steps`` runs out first."""
        results: Dict[int, Any] = {}
        for _ in range(max_steps):
            self._evict_expired(results)
            self._admit()
            results.update(self._failures)
            self._failures.clear()
            if all(r is None for r in self.slot_req) and not self.queue:
                break
            self._decode_one_step()
            results.update(self._failures)
            self._failures.clear()
            for i, r in enumerate(self.slot_req):
                if r is not None and r.done:
                    results[r.uid] = r.out_tokens
                    self.slot_req[i] = None
        else:
            remaining = [r.uid for r in self.queue] + [
                r.uid for r in self.slot_req if r is not None]
            if remaining:
                raise QueueNotDrained(results, remaining, max_steps)
        return results

    # -- internals --------------------------------------------------------

    def _capture(self):
        """The decode step's CUDA graph, warmed up and captured with no
        live row: the cache is left as it was."""
        from repro_torch.graphs import CapturedCall

        b, dev = self.batch, self.device
        return CapturedCall(
            self._summarized_step,
            (torch.zeros((b, 1), dtype=torch.int64, device=dev),
             torch.zeros(b, dtype=torch.int64, device=dev),
             torch.zeros(b, dtype=torch.bool, device=dev)),
            f"the {self.cfg.name} decode step (batch {b})")

    def _evict_expired(self, results: Dict[int, Any]) -> None:
        """Evict expired requests, queued and mid-decode (a slot frees at
        once, so waiting work can take it)."""
        now = self._now()
        self.queue, evicted = self._split_expired(self.queue, now)
        results.update(evicted)
        for i, r in enumerate(self.slot_req):
            if r is not None and r.deadline is not None and now >= r.deadline:
                results[r.uid] = DeadlineExceeded(uid=r.uid,
                                                  deadline=r.deadline, now=now)
                self._res_stats["evictions"] += 1
                self.slot_req[i] = None

    def _admit(self) -> None:
        """Prefill queued requests into free slots, by priority (first
        come first within one), one token at a time through the decode
        path (slot-local), one guarded call a prompt.  A request whose
        prefill fails its retries fails alone."""
        self.queue.sort(key=lambda r: (-r.priority, r.uid))
        for i in range(self.batch):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[i] = req
                prompt = [int(t) for t in req.prompt[:-1]]
                if not prompt:
                    self._reset_slot(i)
                else:
                    live = np.zeros(self.batch, bool)
                    live[i] = True
                    self._step_index += 1
                    try:
                        self._guarded_call("decode", self._prefill,
                                           (i, prompt), live=live)
                    except _BatchFailed as e:
                        self._fail(i, str(e))
                        continue
                req.last_token = int(req.prompt[-1])

    def _reset_slot(self, slot: int) -> None:
        """The slot's ring starts from init at position 0: nothing of its
        previous occupant stays."""
        self.pos[slot] = 0
        tf.reset_cache_rows(self.cache, self._fresh_cache, slot)

    def _prefill(self, slot: int, prompt: List[int]) -> torch.Tensor:
        """Feed ``prompt`` into ``slot`` from a reset slot, one batched
        decode step a token with only ``slot`` live; returns the last
        step's logits.  Nothing here waits for the card."""
        self._reset_slot(slot)
        tokens = np.zeros((self.batch, 1), np.int64)
        live = np.zeros(self.batch, bool)
        live[slot] = True
        for t in prompt:
            tokens[slot, 0] = t
            logits = self._decode(tokens, live)
            self.pos[slot] += 1
        return logits

    def _fail(self, slot: int, reason: str) -> None:
        """Fail the request in ``slot`` and free the slot."""
        r = self.slot_req[slot]
        self._res_stats["request_failures"] += 1
        self._failures[r.uid] = RequestFailed(uid=r.uid, reason=reason)
        self.slot_req[slot] = None

    def _guarded_decode(self, tokens: np.ndarray, live: np.ndarray
                        ) -> Tuple[Tuple[torch.Tensor, np.ndarray],
                                   Optional[np.ndarray]]:
        """One decode step through ``_guarded_call``: ((logits, greedy
        tokens), bad rows)."""
        self._step_index += 1
        return self._guarded_call("decode", self._decode, (tokens, live),
                                  live=live)

    def _collect(self, logits: torch.Tensor
                 ) -> Tuple[Tuple[torch.Tensor, np.ndarray], np.ndarray]:
        """((the logits where they lie, each row's greedy token), each
        row's non-finite flag), the last two from one copy to the host
        (which waits for the step).  The step summarized its logits; logits
        that a fault injection replaced are summarized here."""
        summary = (self._summary if logits is self._stepped else
                   self._summarize(logits, torch.empty_like(self._summary)))
        host = summary.cpu().numpy()
        return (logits, host[:, 0]), host[:, 1] == 0

    def _decode(self, tokens: np.ndarray, live: np.ndarray) -> torch.Tensor:
        """One batched decode step; updates the cache in place, returns
        (B, V) logits (on the card the graph's static logits, valid until
        the next step) and leaves their summary in ``_summary``."""
        args = (torch.as_tensor(tokens, dtype=torch.int64),
                torch.as_tensor(self.pos, dtype=torch.int64),
                torch.as_tensor(live, dtype=torch.bool))
        if self._graph is None:         # the CPU, or EagerServingEngine
            self._stepped = self._summarized_step(*args)
        else:
            self._stepped = self._graph.replay(*args)
        return self._stepped

    def _summarized_step(self, tokens: torch.Tensor, pos: torch.Tensor,
                     live: torch.Tensor) -> torch.Tensor:
        """``step``, with its logits' summary written into ``_summary``."""
        logits = self.step(tokens, pos, live)
        self._summarize(logits, self._summary)
        return logits

    @staticmethod
    def _summarize(logits: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``out[:, 0]``: each row's greedy token (its argmax, the first
        maximum); ``out[:, 1]``: 1 where the row is finite."""
        out[:, 0] = logits.argmax(dim=-1)
        out[:, 1] = torch.isfinite(logits).all(dim=-1)
        return out

    def step(self, tokens: torch.Tensor, pos: torch.Tensor,
             live: torch.Tensor) -> torch.Tensor:
        """The batched decode step run eagerly: (B, 1) tokens, (B,)
        positions and live mask -> (B, V) logits; the cache is updated in
        place."""
        dev = self.device
        # no_grad, not inference_mode: admission resets cache rows in place.
        with torch.no_grad():
            logits, _ = tf.decode_step(
                self.cfg, self.params, self.cache, tokens.to(dev),
                pos.to(dev), live=live.to(dev))
        return logits

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) logits -> (B,) draws from softmax(logits / temperature),
        for a temperature above 0 (at 0 the step's greedy tokens serve)."""
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def _decode_one_step(self) -> None:
        live = np.array([r is not None for r in self.slot_req], bool)
        if not live.any():
            return
        tokens = np.zeros((self.batch, 1), np.int64)
        for i, r in enumerate(self.slot_req):
            if r is not None:
                tokens[i, 0] = r.last_token
        try:
            (logits, greedy), bad = self._guarded_decode(tokens, live)
        except _BatchFailed as e:
            for i, r in enumerate(self.slot_req):
                if r is not None:
                    self._fail(i, str(e))
            return
        nxt = (greedy.tolist() if self.temperature <= 0
               else self._sample(logits).tolist())
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            if bad is not None and bad[i]:
                self._fail(i, "non-finite logits row survived retries")
                continue
            r.out_tokens.append(nxt[i])
            r.last_token = nxt[i]
            self.pos[i] += 1
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True


class EagerServingEngine(ServingEngine):
    """The serving engine with its decode step run eagerly (``step``) on
    the card too, and no graph captured: the comparison for the captured
    step, as ``NetworkExecutor.eager`` and ``CompiledLM.eager`` are for
    the captured forwards."""

    def _capture(self):
        return None

"""Batched LM serving: continuous batching over a fixed decode batch.  The
port of ``repro/serving/engine.py``.

The engine keeps ``batch_size`` decode slots; a finished sequence frees
its slot and a queued request is admitted into it.  Admission feeds the
prompt through slot-local decode steps (only the admitted slot is live;
every other row's cache is masked out of the update), as the reference
does, so serving runs ``transformer.decode_step`` only: its attention is
plain PyTorch against the ring caches, and the flash-attention kernel,
which runs in prefill, is not reached.  Greedy sampling at
``temperature=0``; otherwise a ``torch.Generator`` seeded from ``seed``.

On the card the decode step is one CUDA graph per engine
(``graphs.CapturedCall``, the counterpart of the reference's jitted step),
captured when the engine is made: the batch is fixed, the cache is updated
in place at fixed addresses, and each step copies its tokens, positions
and live mask into the graph's static inputs and replays it.  Admission uses
the same graph with another live mask; resetting a slot's cache rows and
sampling (``_sample``, which reads the graph's logits before the next
replay) stay outside it.  On the CPU the step runs eagerly.
``EagerServingEngine`` is the same engine with the step run eagerly on
either device, for comparison.

The reference's jit -> eager fallback ladder, deadlines and backpressure
are not ported (ROADMAP.md, queue 1, item 4): a failure on the card
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.serving.resilience import QueueNotDrained, validate_prompt


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    last_token: int = 0          # the token the next decode step feeds


class ServingEngine:
    @classmethod
    def from_compiled(cls, compiled, batch_size: Optional[int] = None,
                      capacity: int = 256, **kw) -> ServingEngine:
        """The engine of a facade compilation (``repro_torch.compile(cfg,
        params, options).serve()`` routes here): config, parameters and
        ``impl`` come from it; the batch defaults to ``options.batch``."""
        kw.setdefault("impl", compiled.options.impl)
        return cls(compiled.model, compiled.params,
                   batch_size=batch_size or compiled.options.batch,
                   capacity=capacity, **kw)

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 capacity: int, temperature: float = 0.0, seed: int = 0,
                 impl: str = "cuda"):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                             f"step to serve")
        tf.check_supported(cfg)
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
        self._graph = self._capture() if self.device.type == "cuda" else None

    # -- public api -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        """Enqueue one prompt; returns its uid.  Raises ``InvalidRequest``
        (a ValueError) for an empty, float or out-of-vocabulary prompt."""
        prompt = validate_prompt(prompt, self.cfg.vocab_size)
        self._uid += 1
        self.queue.append(Request(self._uid, prompt, max_new_tokens))
        return self._uid

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive until all submitted requests finish.  Returns uid ->
        generated tokens.  Raises ``QueueNotDrained`` (partial results and
        remaining uids attached) when ``max_steps`` runs out first."""
        results: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            self._admit()
            if all(r is None for r in self.slot_req) and not self.queue:
                break
            self._decode_one_step()
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
            self.step,
            (torch.zeros((b, 1), dtype=torch.int64, device=dev),
             torch.zeros(b, dtype=torch.int64, device=dev),
             torch.zeros(b, dtype=torch.bool, device=dev)),
            f"the {self.cfg.name} decode step (batch {b})")

    def _admit(self) -> None:
        """Prefill queued requests into free slots, one token at a time
        through the decode path (slot-local)."""
        for i in range(self.batch):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[i] = req
                self.pos[i] = 0
                # The slot's ring starts from init: nothing of its previous
                # occupant stays.
                tf.reset_cache_rows(self.cache, self._fresh_cache, i)
                for t in req.prompt[:-1]:
                    self._step_slot(i, int(t))
                req.last_token = int(req.prompt[-1])

    def _decode(self, tokens: np.ndarray, live: np.ndarray) -> torch.Tensor:
        """One batched decode step; updates the cache in place, returns
        (B, V) logits (on the card the graph's static logits, valid until
        the next step)."""
        args = (torch.as_tensor(tokens, dtype=torch.int64),
                torch.as_tensor(self.pos, dtype=torch.int64),
                torch.as_tensor(live, dtype=torch.bool))
        if self._graph is None:         # the CPU, or EagerServingEngine
            return self.step(*args)
        return self._graph.replay(*args)

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

    def _step_slot(self, slot: int, token: int) -> None:
        """Advance one lagging slot (prompt prefill) through the batched
        decode; only ``slot`` is live."""
        tokens = np.zeros((self.batch, 1), np.int64)
        tokens[slot, 0] = token
        live = np.zeros(self.batch, bool)
        live[slot] = True
        self._decode(tokens, live)
        self.pos[slot] += 1

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) logits -> (B,) next tokens: argmax (the first maximum)
        at temperature 0, else a draw from softmax(logits / temperature)."""
        if self.temperature <= 0:
            return logits.argmax(dim=-1)
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
        nxt = self._sample(self._decode(tokens, live)).tolist()
        for i, r in enumerate(self.slot_req):
            if r is None:
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

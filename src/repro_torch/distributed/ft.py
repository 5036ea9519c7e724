"""Fault-tolerance machinery: heartbeats, failure detection, straggler
monitoring, and the elastic re-mesh planner.  The port's copy of
``repro/distributed/ft.py`` (plain Python, no JAX; copied, not imported,
so the port never loads the JAX package).

On a real cluster each host runs this against a shared filesystem (or a
KV store with the same protocol).  All logic is deterministic; the
training loop (train/loop.py) drives the single-host instance of the same
state machine.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple


class Heartbeat:
    """Rank-R liveness file: {'rank', 'step', 'time'} rewritten atomically."""

    def __init__(self, directory: str, rank: int):
        self.dir = directory
        self.rank = rank
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"rank_{rank}.json")

    def beat(self, step: int, now: Optional[float] = None) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "step": step,
                       "time": now if now is not None else time.time()}, f)
        os.replace(tmp, self.path)


class FailureDetector:
    """Declares ranks dead after ``timeout`` seconds without a heartbeat."""

    def __init__(self, directory: str, world_size: int, timeout: float = 60.0):
        self.dir = directory
        self.world_size = world_size
        self.timeout = timeout

    def read(self) -> Dict[int, dict]:
        beats = {}
        for r in range(self.world_size):
            path = os.path.join(self.dir, f"rank_{r}.json")
            with contextlib.suppress(FileNotFoundError, json.JSONDecodeError), \
                    open(path) as f:
                beats[r] = json.load(f)
        return beats

    def dead_ranks(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        beats = self.read()
        dead = []
        for r in range(self.world_size):
            b = beats.get(r)
            if b is None or now - b["time"] > self.timeout:
                dead.append(r)
        return dead


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the rolling-median step time.

    On a real deployment the flag feeds the coordinator, which can evict a
    persistently slow host into the spare pool (see ElasticPlanner).
    """

    def __init__(self, window: int = 20, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: List[float] = []
        self.slow_count = 0

    def record(self, step_time: float) -> bool:
        self.times.append(step_time)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        is_slow = len(self.times) >= 5 and step_time > self.threshold * med
        if is_slow:
            self.slow_count += 1
        return is_slow


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Outcome of a re-mesh decision after failures."""

    healthy_hosts: Tuple[int, ...]
    new_mesh_shape: Tuple[int, ...]
    restart_from_checkpoint: bool
    dropped_hosts: Tuple[int, ...]


class ElasticPlanner:
    """Re-mesh policy: shrink the DP axis to the largest feasible size that
    keeps the model (TP) axis intact.

    Mesh (data, model): TP is wired intra-host/pod (fixed), so failures
    remove whole DP rows.  Training restarts from the last checkpoint with
    the per-host batch rebalanced (global batch is preserved by raising
    grad-accum; see plan.grad_accum_factor).
    """

    def __init__(self, mesh_shape: Sequence[int], hosts_per_dp_row: int = 1,
                 min_dp: int = 1):
        self.mesh_shape = tuple(mesh_shape)  # (..., data, model)
        self.hosts_per_dp_row = hosts_per_dp_row
        self.min_dp = min_dp

    def plan(self, world_size: int, dead: Sequence[int]) -> ElasticPlan:
        healthy = tuple(r for r in range(world_size) if r not in set(dead))
        *lead, dp, tp = self.mesh_shape
        rows_lost = set()
        for r in dead:
            rows_lost.add(r // self.hosts_per_dp_row)
        new_dp = dp - len({row for row in rows_lost if row < dp})
        # Keep DP a power-of-two divisor of the original (collective-friendly).
        while new_dp >= self.min_dp and dp % new_dp != 0:
            new_dp -= 1
        new_dp = max(new_dp, self.min_dp)
        return ElasticPlan(
            healthy_hosts=healthy,
            new_mesh_shape=tuple(lead) + (new_dp, tp),
            restart_from_checkpoint=bool(dead),
            dropped_hosts=tuple(sorted(dead)),
        )

    def grad_accum_factor(self, plan: ElasticPlan) -> int:
        """Multiplier that preserves global batch after the DP shrink."""
        old_dp = self.mesh_shape[-2]
        new_dp = plan.new_mesh_shape[-2]
        return max(1, old_dp // max(new_dp, 1))

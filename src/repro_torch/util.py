"""Tiny shared helpers used across core and kernels."""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F

#: Above the H100's top boost clock (1.98 GHz), so a hold of the stream
#: lasts at least as long as asked.
_MAX_CLOCK_HZ = 2.0e9
#: The longest hold of the stream before a timed run.
MAX_HOLD_S = 1.0


def ceil_to(x: int, q: int) -> int:
    """Round ``x`` up to the next multiple of ``q``."""
    return -(-x // q) * q


def pad_bias_row(bias: Optional[torch.Tensor], n_padded: int) -> Optional[torch.Tensor]:
    """(O,) bias -> (n_padded,) bias, zero-padded on the tail.

    The CUDA kernels read the bias as a flat (O,) vector, so unlike the TPU
    reference no (1, N) row shape is needed; only the tail pad remains.
    """
    if bias is None:
        return None
    n = bias.shape[0]
    return F.pad(bias, (0, n_padded - n)) if n_padded != n else bias


def _held_ms(calls: Sequence[Callable[[], Any]], hold_s: float) -> Optional[float]:
    """Device milliseconds of ``calls`` run back to back between one pair
    of events, the stream held for ``hold_s`` while the host enqueues
    them; None if the hold ran out first (the start event had completed)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_MAX_CLOCK_HZ * hold_s))
    start.record()
    for call in calls:
        call()
    held = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) if held else None


def device_ms(calls: Sequence[Callable[[], Any]]) -> float:
    """Device milliseconds per call of ``calls``, run back to back on the
    current CUDA stream, in runs each timed between one pair of events.

    A device-side sleep holds the stream while the host enqueues a run, so
    the events time the card's work and not the host's launches (in a
    planned forward the host runs ahead of the card).  The hold is sized
    from the host's enqueue time of one call, the least over the last
    three calls, which run once before the timed runs.  A run starts as
    all of ``calls``.  If its hold ran out before it was enqueued, the
    events would time the host: the runs are halved, since the card's
    launch queue holds about a thousand kernels and the host blocks once
    it is full; once they are single calls, their holds are doubled
    instead, so that a run of short calls does not sleep longer than its
    enqueue needs.  If single calls still outlast a
    hold of ``MAX_HOLD_S``, a call synchronizes the host with the card,
    and it raises.
    """
    torch.cuda.synchronize()
    host_s = []
    for call in calls[-3:]:
        t0 = time.perf_counter()
        call()
        host_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    run, slack = len(calls), 2.0
    while True:
        total = 0.0
        for i in range(0, len(calls), run):
            part = calls[i:i + run]
            hold_s = min(MAX_HOLD_S, slack * min(host_s) * len(part) + 1e-3)
            ms = _held_ms(part, hold_s)
            if ms is None:
                break
            total += ms
        else:
            return total / len(calls)
        if run == 1 and hold_s >= MAX_HOLD_S:
            raise RuntimeError(
                f"device_ms: a hold of {hold_s:.3f} s ran out before one "
                f"call was enqueued; the call synchronizes the host with "
                f"the card, so the events would time the host")
        if run > 1:
            run = max(1, run // 2)
        else:
            slack *= 2

"""Pipeline parallelism: GPipe's microbatch schedule over CUDA streams.

The port of ``repro/distributed/pipeline.py``.  Two layers, as there:

  gpipe_schedule / pipeline_forward
      the generic schedule: a chain of stages (``graphs.DeviceCall``s,
      each on its own device and stream), a batch cut into ``n_micro``
      microbatches, and GPipe's ``n_micro + n_stages - 1`` ticks, stage s
      running microbatch t - s at tick t (the reference's active window).
      Stage s takes microbatch m only after stage s-1 made it, by a copy
      of s-1's output into s's graph input on s's stream (a peer copy
      between cards), and stage s-1 replays m + 1 only after that copy.

  PipelineExecutor
      the planned CNN: a ``NetworkPlan`` split by a ``PipelinePlan``
      (core/netplan.partition_network) into contiguous stages, each
      stage's prepared params only on its device, each stage's forward
      at microbatch size one CUDA graph running the planned kernels
      (``run_network(start=, stop=)``).

The reference is one SPMD program over a 'stage' mesh (shard_map and
ppermute) driven by a single controller: ``PipelineExecutor(x)`` returns
the batch.  The port drives its stages from one process the same way, over
``torch.cuda`` streams and events, and does not use ``torch.distributed``:
NCCL refuses two ranks on one card, so a one-card machine could not run
the schedule at all, and one process needs no collective.  The host
enqueues a whole call and does not wait: the caller's stream waits, on
the card, for the last stage, whose outputs are joined in order on the
input's device.  On the CPU the same schedule runs eagerly, stage by
stage.
"""
from __future__ import annotations

import functools
from typing import Any, List, Optional, Sequence, Tuple

import torch


def gpipe_schedule(n_stages: int, n_micro: int) -> List[Tuple[int, int, int]]:
    """(tick, stage, microbatch) in the order the host enqueues them:
    stage s runs microbatch t - s at tick t while 0 <= t - s < n_micro.
    Within a tick the later stages come first, so that stage s's copy of
    microbatch m out of stage s-1's output is queued before stage s-1's
    replay of m + 1, which must wait for it (the replay overwrites that
    output)."""
    return [(t, s, t - s)
            for t in range(n_micro + n_stages - 1)
            for s in reversed(range(n_stages))
            if 0 <= t - s < n_micro]


def pipeline_forward(stages: Sequence[Any], x: torch.Tensor,
                     n_micro: int) -> torch.Tensor:
    """Run ``x`` (batch, ...) through the chain of ``stages``
    (``graphs.DeviceCall``s, captured at microbatch size on the card) by
    ``gpipe_schedule``; the output is joined in order on ``x``'s device.

    On the card nothing waits on the host.  Every stage's stream first
    waits for the caller's (``x`` is ready); ``x`` goes to the first
    stage's device on that stage's stream; the last stage copies each
    microbatch's output into the joined output on its own stream, and the
    caller's stream waits for it.  So every reader of ``x`` and writer of
    the output has finished before the caller's stream goes on: the
    caching allocator, which hands out their memory again by the caller's
    stream, never does so early.
    """
    if x.shape[0] % n_micro:
        raise ValueError(f"n_micro={n_micro} does not divide batch "
                         f"{x.shape[0]}")
    mb = x.shape[0] // n_micro
    first, last = stages[0], stages[-1]
    caller = None
    if first.stream is not None:
        if x.device.type != "cuda":
            raise ValueError(f"stages on the card take an input on a card, "
                             f"got one on {x.device}")
        caller = torch.cuda.current_stream(x.device)
        for st in stages:
            st.stream.wait_stream(caller)
        with torch.cuda.stream(first.stream):
            x = x.to(first.device, non_blocking=True)
    out: Optional[torch.Tensor] = None
    for _, s, m in gpipe_schedule(len(stages), n_micro):
        st = stages[s]
        if s == 0:
            st.run(x[m * mb:(m + 1) * mb])
        else:
            st.run(stages[s - 1].output, stages[s - 1].stream)
        if st is last:
            if out is None:
                out = torch.empty((mb * n_micro, *st.output.shape[1:]),
                                  dtype=st.output.dtype,
                                  device=(caller.device if caller is not None
                                          else x.device))
            st.emit(out[m * mb:(m + 1) * mb])
    if caller is not None:
        caller.wait_stream(last.stream)
    return out


class PipelineExecutor:
    """Layer-pipelined inference: a NetworkPlan split across a list of
    devices, one a stage (launch/mesh.stage_devices; a device may
    repeat).

    As ``NetworkExecutor``: the parameters are prepared once for the
    whole network (batchnorm fold, padding, the Winograd weight
    transform; the int8 calibration on ``calibration``), then each stage
    holds a copy of its own slice only, on its device.  Each stage's
    forward, ``run_network(start=, stop=)`` at microbatch size
    (``batch / n_micro``, the full batch's plan: the kernels take their
    split counts from the call's shapes), is one CUDA graph in a pool of
    its own, captured at the first call (``capture``) and replayed on the
    stage's stream.  Boundary activations are logically laid out (the
    partitioner cuts nowhere else); an int8 network passes fp32
    activations between stages, a bf16 or fp16 one 16-bit ones.
    ``n_micro`` (None: the plan's) must divide the batch.
    """

    def __init__(self, netplan, pipeplan, params: Sequence[Any],
                 devices: Optional[Sequence[Any]] = None,
                 pretransform: bool = True, calibration=None,
                 n_micro: Optional[int] = None):
        from repro_torch.core.netplan import (
            params_to,
            prepare_net_params,
            pretransform_flags,
        )
        from repro_torch.graphs import DeviceCall
        from repro_torch.launch.mesh import stage_devices

        self.netplan = netplan
        self.pipeplan = pipeplan
        self.n_micro = int(pipeplan.n_micro if n_micro is None else n_micro)
        if self.n_micro < 1 or netplan.batch % self.n_micro:
            raise ValueError(f"n_micro={self.n_micro} does not divide batch "
                             f"{netplan.batch}")
        self.devices = stage_devices(pipeplan.n_stages, devices)
        prepared = prepare_net_params(netplan, params,
                                      pretransform=pretransform,
                                      calibration=calibration)
        self.pretransformed = pretransform_flags(netplan, pretransform)
        self.stage_params = [params_to(prepared[a:z], d) for (a, z), d
                             in zip(pipeplan.stage_bounds, self.devices)]
        del prepared
        mb = netplan.batch // self.n_micro
        self.stages = [
            DeviceCall(functools.partial(self._stage_forward, s), d,
                       f"pipeline stage {s} (steps {a}:{z}, {netplan.dtype}, "
                       f"microbatch {mb} at {netplan.input_hw[0]}x"
                       f"{netplan.input_hw[1]}) on {d}")
            for s, ((a, z), d) in enumerate(zip(pipeplan.stage_bounds,
                                                self.devices))]

    def _stage_forward(self, s: int, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core.netplan import run_network

        a, z = self.pipeplan.stage_bounds[s]
        with torch.inference_mode():
            return run_network(self.netplan, self.stage_params[s], x,
                               pretransformed=self.pretransformed,
                               start=a, stop=z)

    def _check(self, x: torch.Tensor) -> None:
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        if (h, w) != self.netplan.input_hw or b != self.netplan.batch:
            raise ValueError(
                f"pipeline executor planned for batch {self.netplan.batch} "
                f"at {self.netplan.input_hw}, got {tuple(x.shape)}")

    def capture(self, x: torch.Tensor) -> None:
        """Capture every stage's graph (a batch ``x`` on a card), each on
        a zero microbatch of the shape its predecessor's graph returns;
        nothing on the CPU."""
        self._check(x)
        if self.stages[0].stream is None:
            return
        shape = (self.netplan.batch // self.n_micro, *x.shape[1:])
        dtype = getattr(torch, self.netplan.input_dtype)
        for st in self.stages:
            st.capture(torch.zeros(shape, dtype=dtype, device=st.device))
            shape, dtype = st.graph.output.shape, st.graph.output.dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        x = x.to(getattr(torch, self.netplan.input_dtype))
        self.capture(x)
        return pipeline_forward(self.stages, x, self.n_micro)

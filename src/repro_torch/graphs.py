"""CUDA graphs: the port's stand-in for the reference's ``jax.jit``.

The reference compiles three programs once and calls the compiled program
per call: the planned CNN forward (``repro/core/netplan.py``,
``jax.jit(fwd)``), the LM forward (``repro/api/compiled.py``) and the
serving decode step (``repro/serving/engine.py``).  PyTorch runs eagerly,
and on the card the host's dispatch of a forward's many small launches
takes longer than the card's work on them.  A ``CapturedCall`` captures
the eager body once into one CUDA graph and replays the graph per call,
so a call costs the host one launch of the graph.  The eager body stays
the code that is captured.  Nothing falls back to it: a capture that
fails raises with the path named.

The kernel wrappers count their launches in Python, so they count while
the body is captured, not when the graph replays.  ``capture_counted``
records each wrapper's count over the capture and takes the warm-up's and
the capture's own counts back out; ``add_launches`` adds the recorded
counts at every replay.  After k calls the counts are k times the body's.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch


def launch_counters() -> Dict[str, Callable]:
    """Every CUDA kernel's wrapper by kernel name; each counts the
    launches of its kernel in its ``launches`` attribute."""
    from repro_torch.kernels.conv_ops import kernel_wrappers
    from repro_torch.kernels.flash_attention import flash_attention

    return {**kernel_wrappers(), "flash_attention": flash_attention}


def read_launches(wrappers: Dict[str, Callable]) -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers.items()}


def capture_counted(wrappers: Dict[str, Callable], warm_up: Callable[[], None],
                    capture: Callable[[], None]) -> Dict[str, int]:
    """Run ``warm_up()`` then ``capture()``; return the launches each
    wrapper counted during ``capture()`` (wrappers that counted none left
    out).  Every count is left as it was before ``warm_up()``, also when
    either raises: the warm-up ran on no caller's behalf, and a capture
    records launches without running them."""
    before = read_launches(wrappers)
    try:
        warm_up()
        start = read_launches(wrappers)
        capture()
        end = read_launches(wrappers)
    finally:
        for name, fn in wrappers.items():
            fn.launches = before[name]
    return {name: end[name] - start[name] for name in wrappers
            if end[name] != start[name]}


def add_launches(wrappers: Dict[str, Callable], counts: Dict[str, int],
                 times: int = 1) -> None:
    """Count ``times`` replays of a graph that launches ``counts``."""
    for name, n in counts.items():
        wrappers[name].launches += times * n


class CapturedCall:
    """``body(*inputs) -> tensor`` captured once into a CUDA graph on the
    card and replayed per call.

    Construction, in this order:

    1. Warm-up: ``body`` runs eagerly once on a side stream on copies of
       ``example_inputs`` (the static inputs).  It does what must
       not happen during capture: it builds the kernels, makes each
       kernel's first launch (which loads its module), raises their
       shared-memory limits and makes the host-to-device copies of the
       cached constants.
    2. Capture: ``body`` runs once more under ``torch.cuda.graph``, into
       one graph, in the memory pool ``pool`` (``torch.cuda.
       graph_pool_handle()``; None: a pool of the graph's own).  Its
       temporaries (activations, split-K workspaces) are allocated once,
       there, and keep their addresses for every replay.  Graphs that share
       a pool may reuse each other's temporaries: that is safe while they
       replay one at a time on one stream and each call clones its output
       before the next replay, as ``__call__`` does.

    A call copies its tensors into the static inputs (``copy_``), replays
    the graph and returns a ``clone()`` of the static output: one device
    copy per call, since the reference returns a fresh array per call and
    the next replay overwrites the static output.  ``replay`` returns the
    static output itself, for a caller that reads it before the next call.

    Raises RuntimeError naming ``name`` if the body cannot be captured:
    for instance if it synchronizes the host with the card (``.item()``, a
    copy from pageable host memory).  A launch that fails raises as it
    does eagerly, from the wrapper during capture or from ``replay``.
    """

    def __init__(self, body: Callable[..., torch.Tensor],
                 example_inputs: Sequence[torch.Tensor], name: str,
                 pool=None):
        devices = {t.device for t in example_inputs}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"{name}: a CUDA graph takes inputs on one card, "
                             f"got {sorted(map(str, devices))}")
        self.name = name
        self._wrappers = launch_counters()
        device = next(iter(devices))
        with torch.no_grad():
            self.inputs = tuple(t.clone() for t in example_inputs)
        self.graph = torch.cuda.CUDAGraph()
        self.output: Optional[torch.Tensor] = None
        # A stream of this call's own for the warm-up and the capture: a
        # capture that fails leaves no other capture's stream behind it.
        side = torch.cuda.Stream(device)

        def warm_up():
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), torch.no_grad():
                body(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(side)

        def capture():
            with torch.no_grad(), torch.cuda.graph(self.graph, pool=pool,
                                                   stream=side):
                self.output = body(*self.inputs)

        try:
            #: Launches per replay, by kernel name.
            self.launches = capture_counted(self._wrappers, warm_up, capture)
        except RuntimeError as err:
            raise RuntimeError(f"CUDA graph capture of {name} failed (nothing "
                               f"runs it eagerly instead): {err}") from err
        if not isinstance(self.output, torch.Tensor):
            raise TypeError(f"{name}: the captured body must return one "
                            f"tensor, got {type(self.output).__name__}")

    def replay(self, *inputs: torch.Tensor) -> torch.Tensor:
        """Copy ``inputs`` into the static inputs, replay, and return the
        static output (valid until the next replay)."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, the graph "
                             f"was captured with {len(self.inputs)}")
        for static, x in zip(self.inputs, inputs):
            if x.shape != static.shape:
                raise ValueError(f"{self.name}: input of shape "
                                 f"{tuple(x.shape)}, the graph was captured "
                                 f"at {tuple(static.shape)}")
        with torch.no_grad():
            for static, x in zip(self.inputs, inputs):
                if x is not static:
                    static.copy_(x)
        self.graph.replay()
        add_launches(self._wrappers, self.launches)
        return self.output

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        return self.replay(*inputs).clone()


class DeviceCall:
    """``body(x) -> tensor`` at one input shape on one device, on a stream
    of its own: one stage of a pipeline (distributed/pipeline.py) or one
    shard of a batch (core/netplan.NetworkExecutor).  Two of them may
    name the same device: each is still its own stage or shard.

    On the card ``capture(example)`` captures ``body`` into a CUDA graph
    (``CapturedCall``) under ``torch.cuda.device(device)``, in a memory
    pool of the graph's own: calls on different streams replay at the
    same time, which one shared pool does not allow (graphs that share a
    pool may reuse each other's temporaries).  ``run(src, src_stream)``
    copies ``src`` into the graph's static input on this call's stream
    and replays the graph there; the result stays in ``output``, which
    the next ``run`` overwrites, so a reader copies it out first
    (``emit``).  On the CPU ``run`` calls ``body`` eagerly.
    """

    def __init__(self, body: Callable[[torch.Tensor], torch.Tensor],
                 device, name: str):
        self.body = body
        self.device = torch.device(device)
        self.name = name
        self.graph: Optional[CapturedCall] = None
        self.output: Optional[torch.Tensor] = None
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def capture(self, example: torch.Tensor) -> None:
        """Capture ``body``'s graph on ``example`` (an input on this
        call's card) unless it is captured; nothing on the CPU."""
        if self.stream is not None and self.graph is None:
            with torch.cuda.device(self.device):
                self.graph = CapturedCall(self.body, (example,), self.name)

    def run(self, src: torch.Tensor,
            src_stream: Optional["torch.cuda.Stream"] = None) -> torch.Tensor:
        """``body`` on ``src``, made by the work queued on ``src_stream``
        (None: this call's own stream); returns ``output``.

        On the card the copy of ``src`` into the static input waits for
        ``src_stream``'s queued work, and ``src_stream``'s later work waits
        for the copy: the producer may overwrite ``src`` (its own static
        output) only once it is copied.  On one device the copy runs on
        this call's stream; between two cards it is a peer copy, which
        PyTorch runs on the source device's current stream (set here to
        ``src_stream``) behind a wait for this call's stream.
        """
        if self.stream is None:
            self.output = self.body(src.to(self.device))
            return self.output
        if self.graph is None:
            raise RuntimeError(f"{self.name}: run before its graph was "
                               f"captured")
        src_stream = self.stream if src_stream is None else src_stream
        static = self.graph.inputs[0]
        self.stream.wait_stream(src_stream)
        with torch.cuda.stream(src_stream), torch.cuda.stream(self.stream):
            static.copy_(src, non_blocking=True)
        src_stream.wait_stream(self.stream)
        with torch.cuda.stream(self.stream):
            self.output = self.graph.replay(static)
        return self.output

    def emit(self, dst: torch.Tensor) -> None:
        """Copy ``output`` into ``dst`` on this call's stream, before its
        next replay; the reader of ``dst`` waits for this stream."""
        if self.stream is None:
            dst.copy_(self.output)
            return
        with torch.cuda.stream(self.stream):
            dst.copy_(self.output, non_blocking=True)

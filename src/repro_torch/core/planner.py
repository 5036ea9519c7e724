"""Per-layer convolution planner (cost and measure modes, in memory).

The port of ``repro/core/planner.py``'s ``ConvPlan`` and ``Planner``: the
algorithm, Winograd realization and kernel blocks of a conv layer are
decided once per (layer, input shape, batch, mode, policy) and reused.
This slice keeps the plans in a dict; the reference's JSON cache is not
ported yet.

**Cost mode.**  The algorithm rule stands in for the reference's roofline
selection (``select_algorithm_by_cost``) until a cost model of this card is
ported:

- a 3x3 stride-1 conv goes to Winograd when it has at least
  ``WINOGRAD_MIN_TILES`` 6x6 output tiles (B * ceil(OH/6) * ceil(OW/6)),
  and to im2col otherwise;
- a 1x1 stride-1 conv goes to the direct GEMM;
- everything else goes to im2col.

An explicit ``ConvSpec.algorithm`` wins over the rule.  The rule is a
stand-in, not a cost model: its threshold was chosen so that on YOLOv3-tiny
at 416x416, batch 1, it gives the reference planner's split (Winograd on
layers 0, 2, 4, 6, im2col on 8, 10, 12, 14, 20, direct on the 1x1 convs).
A Winograd layer runs the fused kernel unless the planner's
``winograd_fused`` policy is False: the policy None (auto) resolves to
fused, the port's stand-in for the reference's modeled comparison, whose
TPU model never picks the 3-pass pipeline.

**Measure mode** (the paper's §VII.A method, the port of
``_tune_measured``): every eligible algorithm runs on seeded inputs, and
the fastest is kept with ``source='measured'``.  Under ``impl='cuda'`` a
3x3 stride-1 layer's candidates are both Winograd realizations (unless the
policy forces one) and im2col.  Each candidate runs with its own kernel
blocks, the bias + activation epilogue the executor replays, and the
executor's channel padding and weight pre-transform, so it times what the
forward will run.  On the card the time is the device's: CUDA events
around a run of calls with the host's launches hidden (at batch 1 a
call's host time exceeds its kernels' time, and in a forward the host
runs ahead of the card).  On the CPU it is ``perf_counter`` per call.  A candidate that raises
stops planning: a failed build or launch is never skipped.

**int8** (``plan(..., dtype='int8')``, the port of ``_tune_int8``): a
layer quantizes only when it passes the gates of core/quant.py.  Its fp32
cost plan is taken first; a layer that fails ``int8_worthwhile`` keeps it;
a 1x1 stride-1 conv goes to the int8 GEMM; an fp32 Winograd plan stays
fp32 Winograd when the layer has at least ``INT8_WINOGRAD_MIN_TILES`` 6x6
output tiles; every other layer goes to the int8 implicit-GEMM conv.  The
tile threshold stands in for the reference's modeled-time comparison
(fp32 Winograd against int8 im2col on the TPU model) until a cost model
of this card lands: any value in (361, 1225] reproduces the reference's
split on YOLOv3-tiny 416 (batch 1 and 4), VGG-16 224 and MODEL_20 608 at
batch 1, and nothing more is claimed for it.  As in the reference, an
int8 request in measure mode is planned by this rule too: int8
candidates are not timed.

Kernel blocks come from each CUDA kernel's own ``pick_blocks``.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec

WINOGRAD_MIN_TILES = 64
INT8_WINOGRAD_MIN_TILES = 1024
DTYPES = ("float32", "int8")
MODES = ("cost", "measure")
MEASURE_REPS = 10         # timed calls per measure-mode candidate


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One resolved decision for one conv layer at one shape.

    ``kernel_blocks`` is what the kernel wrappers consume: (bm, bn, bk) for
    the direct GEMM, (toh, bc, bo) for the implicit-GEMM conv, (bt, bc, bo)
    for the Winograd realization that runs — the fused kernel's, or the
    3-pass tuple multiply's tile.  ``winograd_fused`` picks that
    realization (False on every plan that is not Winograd).
    ``measured_ms`` holds, in measure mode, each candidate's label and its
    measured milliseconds per call.  ``dtype`` is the resolved precision:
    'int8' runs the int8 kernels on an input quantized at the layer's
    entry, 'float32' the fp32 ones.
    """

    algorithm: ConvAlgorithm
    impl: str
    kernel_blocks: Tuple[int, int, int]
    source: str = "tile_rule"
    winograd_fused: bool = True
    measured_ms: Tuple[Tuple[str, float], ...] = ()
    dtype: str = "float32"

    @property
    def label(self) -> str:
        """The algorithm, for Winograd its realization, and '_int8' on an
        int8 plan."""
        if self.algorithm is ConvAlgorithm.WINOGRAD:
            return "winograd_fused" if self.winograd_fused else "winograd_3pass"
        return self.algorithm.value + ("_int8" if self.dtype == "int8" else "")


def plan_key(spec: ConvSpec, h: int, w: int, batch: int, impl: str,
             mode: str, winograd_fused: Optional[bool],
             dtype: str = "float32") -> Tuple[Any, ...]:
    """The plan cache key: layer and shape, and every planner setting that
    changes the decision (the Winograd policy, the mode and the requested
    dtype among them)."""
    return (spec, h, w, batch, impl, mode, winograd_fused, dtype)


def winograd_tiles(spec: ConvSpec, h: int, w: int, batch: int) -> int:
    """6x6 output tiles of a conv: B * ceil(OH/6) * ceil(OW/6)."""
    oh, ow = spec.out_hw(h, w)
    return batch * -(-oh // 6) * -(-ow // 6)


def select_algorithm_by_tiles(spec: ConvSpec, h: int, w: int,
                              batch: int) -> ConvAlgorithm:
    """The tile-count rule of the module docstring."""
    if spec.algorithm is not ConvAlgorithm.AUTO:
        return spec.algorithm
    if spec.kernel_size == (1, 1) and spec.stride == (1, 1):
        return ConvAlgorithm.DIRECT
    if (
        spec.kernel_size == (3, 3)
        and spec.stride == (1, 1)
        and spec.dilation == (1, 1)
        and winograd_tiles(spec, h, w, batch) >= WINOGRAD_MIN_TILES
    ):
        return ConvAlgorithm.WINOGRAD
    return ConvAlgorithm.IM2COL_GEMM


def eligible_algorithms(spec: ConvSpec) -> List[ConvAlgorithm]:
    """Measure mode's candidates (a forced spec collapses to one)."""
    if spec.algorithm is not ConvAlgorithm.AUTO:
        return [spec.algorithm]
    if spec.kernel_size == (1, 1) and spec.stride == (1, 1):
        return [ConvAlgorithm.DIRECT, ConvAlgorithm.IM2COL_GEMM]
    if (
        spec.kernel_size == (3, 3)
        and spec.stride == (1, 1)
        and spec.dilation == (1, 1)
    ):
        return [ConvAlgorithm.WINOGRAD, ConvAlgorithm.IM2COL_GEMM]
    return [ConvAlgorithm.IM2COL_GEMM]


class Planner:
    """Resolves and caches ConvPlans in memory.

    ``mode`` is 'cost' (the tile rule) or 'measure' (time the candidates on
    ``device``).  ``winograd_fused`` is the Winograd realization policy:
    None lets the planner choose (fused in cost mode, the faster in measure
    mode under ``impl='cuda'``), True/False force one.  ``stats`` counts
    ``hits`` and ``tunes`` (misses that decided).
    """

    def __init__(self, impl: str = "cuda", mode: str = "cost",
                 winograd_fused: Optional[bool] = None,
                 device: Any = "cuda"):
        if impl not in ("cuda", "torch"):
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if winograd_fused not in (None, True, False):
            raise ValueError(f"winograd_fused must be None, True or False, "
                             f"got {winograd_fused!r}")
        self.impl = impl
        self.mode = mode
        self.winograd_fused = winograd_fused
        self.device = torch.device(device)
        self._plans: Dict[Any, ConvPlan] = {}
        self.stats = {"hits": 0, "tunes": 0}

    def plan(self, spec: ConvSpec, h: int, w: int, batch: int = 1,
             dtype: str = "float32") -> ConvPlan:
        """The plan for one layer at one input shape under the requested
        ``dtype`` ('float32', or 'int8': resolved per layer, so the plan's
        own ``dtype`` may be 'float32'); decides on the first miss."""
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
        key = plan_key(spec, h, w, batch, self.impl, self.mode,
                       self.winograd_fused, dtype)
        cached = self._plans.get(key)
        if cached is not None:
            self.stats["hits"] += 1
            return cached
        self.stats["tunes"] += 1
        if dtype == "int8":
            plan = self._tune_int8(spec, h, w, batch)
        elif self.mode == "measure":
            plan = self._tune_measured(spec, h, w, batch)
        else:
            plan = self._tune_cost(spec, h, w, batch)
        self._plans[key] = plan
        return plan

    def _candidate(self, spec: ConvSpec, algo: ConvAlgorithm, wf: bool,
                   h: int, w: int, batch: int, source: str,
                   dtype: str = "float32") -> ConvPlan:
        wf = wf and algo is ConvAlgorithm.WINOGRAD
        return ConvPlan(algorithm=algo, impl=self.impl,
                        kernel_blocks=kernel_blocks(spec, algo, h, w, batch,
                                                    wf, dtype),
                        source=source, winograd_fused=wf, dtype=dtype)

    def _tune_cost(self, spec: ConvSpec, h: int, w: int,
                   batch: int) -> ConvPlan:
        algo = select_algorithm_by_tiles(spec, h, w, batch)
        wf = self.winograd_fused if self.winograd_fused is not None else True
        return self._candidate(spec, algo, wf, h, w, batch, "tile_rule")

    def _tune_int8(self, spec: ConvSpec, h: int, w: int,
                   batch: int) -> ConvPlan:
        """The int8 gate of the module docstring.  As in the reference,
        Winograd is an int8 candidate only when
        ``quant.winograd_int8_budget_ok()`` holds; F(6,3) misses that
        transform-stage error budget, so an int8 3x3 layer runs the
        implicit-GEMM conv (the dispatcher has no int8 Winograd kernel and
        refuses such a plan)."""
        from repro_torch.core.quant import int8_worthwhile, winograd_int8_budget_ok

        fp32_plan = self._tune_cost(spec, h, w, batch)
        if not int8_worthwhile(spec, h, w, batch):
            return fp32_plan
        winograd = fp32_plan.algorithm is ConvAlgorithm.WINOGRAD
        if spec.kernel_size == (1, 1) and spec.stride == (1, 1):
            algo = ConvAlgorithm.DIRECT
        elif winograd and winograd_int8_budget_ok():
            algo = ConvAlgorithm.WINOGRAD
        else:
            algo = ConvAlgorithm.IM2COL_GEMM
        # The stand-in for the reference's time gate: a layer with many
        # tiles keeps fp32 Winograd rather than int8 im2col.
        if (winograd and algo is ConvAlgorithm.IM2COL_GEMM
                and winograd_tiles(spec, h, w, batch) >= INT8_WINOGRAD_MIN_TILES):
            return fp32_plan
        return self._candidate(spec, algo, fp32_plan.winograd_fused, h, w,
                               batch, "tile_rule", dtype="int8")

    def _tune_measured(self, spec: ConvSpec, h: int, w: int,
                       batch: int) -> ConvPlan:
        """Time every eligible candidate on seeded inputs; keep the fastest."""
        import numpy as np
        import torch.nn.functional as F

        from repro_torch.core.conv2d import conv2d
        from repro_torch.core.conv_spec import Epilogue
        from repro_torch.core.netplan import Layout
        from repro_torch.core.winograd import transform_weights
        from repro_torch.kernels.conv_ops import in_channel_multiple
        from repro_torch.util import ceil_to

        cin, cout = spec.in_channels, spec.out_channels
        rng = np.random.default_rng(0)

        def tensor(a):
            return torch.as_tensor(a.astype(np.float32), device=self.device)

        x = tensor(rng.normal(size=(batch, h, w, cin)))
        wts = tensor(rng.normal(size=(spec.kh, spec.kw, cin, cout)) * 0.05)
        # Every conv of a planned network replays the bias + activation
        # variant of its kernel.
        epi = Epilogue(bias=tensor(rng.normal(size=(cout,))), activation="relu")

        candidates = []
        for algo in eligible_algorithms(spec):
            if algo is not ConvAlgorithm.WINOGRAD:
                candidates.append((algo, False))
            elif self.winograd_fused is not None:
                candidates.append((algo, self.winograd_fused))
            elif self.impl == "cuda":
                candidates += [(algo, True), (algo, False)]
            else:
                candidates.append((algo, True))

        timed = []
        with torch.inference_mode():
            for algo, wf in candidates:
                plan = self._candidate(spec, algo, wf, h, w, batch, "measured")
                # The executor's contract: channels padded to the kernel's
                # multiple offline, Winograd weights pre-transformed.
                pad = ceil_to(cin, in_channel_multiple(algo)) - cin
                xp, wp = F.pad(x, (0, pad)), F.pad(wts, (0, 0, 0, pad))
                pre = algo is ConvAlgorithm.WINOGRAD
                if pre:
                    wp = transform_weights(wp)
                ms = self._time_ms(
                    lambda plan=plan, xp=xp, wp=wp, pre=pre, pad=pad: conv2d(
                        xp, wp, spec, plan=plan, epilogue=epi,
                        in_layout=Layout(cin, pad), pretransformed=pre))
                timed.append((plan, ms))
        best = min(timed, key=lambda pm: pm[1])[0]
        return dataclasses.replace(
            best, measured_ms=tuple((p.label, ms) for p, ms in timed))

    def _time_ms(self, fn) -> float:
        """Milliseconds per call of ``fn`` after one call that builds and
        warms it: on the card, the device time of ``MEASURE_REPS`` calls
        between CUDA events (``util.device_ms``: the card's work, not the
        host's launches); on the CPU, the median of as many
        ``perf_counter`` calls."""
        fn()
        if self.device.type == "cuda":
            from repro_torch.util import device_ms

            return device_ms([fn] * MEASURE_REPS)
        times = []
        for _ in range(MEASURE_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3


def kernel_blocks(spec: ConvSpec, algo: ConvAlgorithm, h: int, w: int,
                  batch: int, winograd_fused: bool = True,
                  dtype: str = "float32") -> Tuple[int, int, int]:
    """The kernel block tuple for one algorithm (Winograd realization, and
    dtype) choice, from the kernel."""
    oh, ow = spec.out_hw(h, w)
    if algo is ConvAlgorithm.DIRECT:
        from repro_torch.kernels.gemm.ops import default_block

        return default_block(batch * oh * ow, spec.out_channels,
                             spec.in_channels)
    if algo is ConvAlgorithm.WINOGRAD:
        from repro_torch.kernels.winograd.ops import pick_blocks

        return pick_blocks(winograd_tiles(spec, h, w, batch),
                           spec.in_channels, spec.out_channels,
                           fused=winograd_fused)
    from repro_torch.kernels.im2col_gemm.ops import pick_blocks

    return pick_blocks(oh, ow, dtype)

"""Network-level inference planning and execution.

The port of ``repro/core/netplan.py`` (no jit):

  Layout        the physical channel layout an NHWC activation carries
                relative to its logical shape (trailing zero channels the
                next kernel needs).
  NetworkPlan   the whole network resolved ahead of time: per-layer
                ConvPlans, network-adjusted kernel blocks (the im2col row
                tile snapped to a divisor of OH), and the inter-layer layout
                decisions — which crop+re-pad pairs are elided so a padded
                activation flows straight into the next kernel.
  NetworkExecutor  runs a NetworkPlan: offline parameter preparation
                (batchnorm folding, channel padding, Winograd weight
                pre-transform, and for int8 steps calibration and weight
                quantization), then ``run_network`` per call, on one
                device or batch-sharded over several.
  PipelinePlan  the network cut into contiguous stages balanced on each
                step's predicted seconds (``partition_network``, cached by
                ``plan_pipeline``); ``run_network(start=, stop=)`` runs
                one stage (distributed/pipeline.py runs them all).

Elision is legal exactly when the padded region stays zero: the producer's
weight/bias pads make its extra output channels act(0 + 0) = 0, maxpool and
upsample preserve zero channels, and the consumer's zero weight pads ignore
them.  Any consumer that needs logical channels (route, shortcut, fc,
avgpool, or a layer referenced by one) forces a crop back to logical.

The channel multiples come from the CUDA kernels (kernels/conv_ops.py), not
from the TPU's 128 lanes: the fp32 GEMM takes any C, the Winograd and fp32
im2col kernels take multiples of 8, both int8 kernels multiples of 16, and
every kernel masks its out channels, so a producer pads its out channels
only to its consumer's multiple and the network's output needs no crop.  Plans and elision choices differ from the
reference; outputs do not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import (
    ConvAlgorithm,
    ConvSpec,
    Epilogue,
    apply_activation,
)
from repro_torch.core.planner import ConvPlan, Planner, plan_is_current
from repro_torch.models.cnn import _conv_spec
from repro_torch.util import HALF_DTYPES, ceil_to, pad_bias_row

# ---------------------------------------------------------------------------
# Layout and plan records


@dataclasses.dataclass(frozen=True)
class Layout:
    """Physical channel layout of an NHWC activation: ``c`` logical
    channels plus ``pad_c`` trailing channels that are exactly zero."""

    c: int
    pad_c: int = 0

    @property
    def phys_c(self) -> int:
        return self.c + self.pad_c

    @property
    def trivial(self) -> bool:
        return self.pad_c == 0

    def to_json(self) -> List[int]:
        return [self.c, self.pad_c]

    @classmethod
    def from_json(cls, d: Sequence[int]) -> "Layout":
        c, pad_c = (int(v) for v in d)
        return cls(c, pad_c)


@dataclasses.dataclass(frozen=True)
class NetStep:
    """One planned layer: its spec/plan plus the layouts it consumes and
    produces."""

    index: int
    layer: Any                      # CNNLayer (duck-typed: .kind, ...)
    spec: Optional[ConvSpec]         # None for a layer that is not a conv
    plan: Optional[ConvPlan]         # likewise; every conv has one
    in_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    in_layout: Layout
    out_layout: Layout


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """A whole network resolved for one (input shape, batch, impl,
    requested dtype); each conv's plan carries its resolved dtype."""

    steps: Tuple[NetStep, ...]
    input_hw: Tuple[int, int]
    in_channels: int
    batch: int
    impl: str
    dtype: str = "float32"

    @property
    def input_dtype(self) -> str:
        """The type the forward takes its input in: ``dtype``, except
        under int8, whose layers quantize their own fp32 inputs."""
        return "float32" if self.dtype == "int8" else self.dtype

    @property
    def elided_boundaries(self) -> int:
        """Conv boundaries whose crop+re-pad pair was elided."""
        return sum(
            1 for s in self.steps
            if s.layer.kind == "conv" and not s.out_layout.trivial
        )

    def algorithm_counts(self) -> Dict[ConvAlgorithm, int]:
        """Planned conv steps per algorithm — one kernel launch each."""
        counts: Dict[ConvAlgorithm, int] = {}
        for s in self.steps:
            if s.layer.kind == "conv":
                counts[s.plan.algorithm] = counts.get(s.plan.algorithm, 0) + 1
        return counts

    def kernel_launches(self, start: int = 0,
                        stop: Optional[int] = None) -> Dict[str, int]:
        """Planned launches per CUDA kernel in one forward of
        ``steps[start:stop]`` (default: the whole network; a slice is one
        pipeline stage): one per conv step (of the int8 kernel on an int8
        step), and one of each of the three kernels per 3-pass Winograd
        step (kernel names as ``kernels.conv_ops.plan_kernels``)."""
        from repro_torch.kernels.conv_ops import plan_kernels

        counts: Dict[str, int] = {}
        for s in self.steps[start:stop]:
            if s.layer.kind == "conv":
                for name in plan_kernels(s.plan):
                    counts[name] = counts.get(name, 0) + 1
        return counts


# ---------------------------------------------------------------------------
# Algorithm / block helpers


def _in_channel_multiple(plan: ConvPlan) -> int:
    from repro_torch.kernels.conv_ops import in_channel_multiple

    return in_channel_multiple(plan.algorithm, plan.dtype)


def _snap_row_tile(plan: ConvPlan, algo: ConvAlgorithm, oh: int) -> ConvPlan:
    """Network-level adjustment: make the fp32 or int8 im2col row tile
    divide OH (``im2col_gemm.ops.snap_row_tile``); the 16-bit kernel's
    tiles run over consecutive pixels, with no row tile to snap."""
    from repro_torch.kernels.im2col_gemm.ops import snap_row_tile

    if algo is not ConvAlgorithm.IM2COL_GEMM or plan.dtype in HALF_DTYPES:
        return plan
    toh, bc, bo = plan.kernel_blocks
    snapped = snap_row_tile(toh, oh)
    if snapped == toh:
        return plan
    return dataclasses.replace(plan, kernel_blocks=(snapped, bc, bo))


# ---------------------------------------------------------------------------
# Building the plan


def _propagate_shapes(
    layers: Tuple[Any, ...], h: int, w: int, in_channels: int
) -> List[Dict[str, Any]]:
    """Per-layer {'spec', 'in': (h,w,c), 'out': (h,w,c)} — the single shape
    walk shared by planning and layout resolution."""
    infos: List[Dict[str, Any]] = []
    shapes: List[Tuple[int, int, int]] = []
    cur_c, cur_h, cur_w = in_channels, h, w
    for l in layers:
        in_shape = (cur_h, cur_w, cur_c)
        spec = None
        if l.kind == "conv":
            spec = _conv_spec(l, cur_c)
            cur_h, cur_w = spec.out_hw(cur_h, cur_w)
            cur_c = l.out_channels
        elif l.kind == "maxpool":
            cur_h, cur_w = -(-cur_h // l.stride), -(-cur_w // l.stride)
        elif l.kind == "upsample":
            cur_h, cur_w = cur_h * l.size, cur_w * l.size
        elif l.kind == "route":
            cur_c = sum(shapes[j][2] for j in l.from_layers)
            cur_h, cur_w = shapes[l.from_layers[0]][:2]
        elif l.kind in ("avgpool", "fc"):
            cur_h, cur_w = 1, 1
            if l.kind == "fc":
                cur_c = l.out_channels
        shapes.append((cur_h, cur_w, cur_c))
        infos.append({"spec": spec, "in": in_shape, "out": shapes[-1]})
    return infos


def build_network_plan(
    layers: Sequence[Any],
    h: int,
    w: int,
    plans: Sequence[Optional[ConvPlan]],
    in_channels: int = 3,
    batch: int = 1,
    impl: str = "cuda",
    dtype: str = "float32",
) -> NetworkPlan:
    """Pure layout resolution: layer table + per-layer plans -> NetworkPlan.

    ``plans`` has one entry per layer: a ConvPlan for every conv, None for
    every other layer."""
    layers = tuple(layers)
    n = len(layers)
    plans = tuple(plans)
    assert len(plans) == n, (len(plans), n)
    assert all((p is not None) == (l.kind == "conv")
               for l, p in zip(layers, plans)), "a ConvPlan per conv only"
    referenced = {j for l in layers for j in getattr(l, "from_layers", ())}
    infos = _propagate_shapes(layers, h, w, in_channels)

    def next_conv(i: int) -> Optional[int]:
        """Follow ``cur`` from layer i through layout-transparent layers:
        the index of the conv that consumes it, or None when a layer that
        needs logical channels comes first, the network ends, or an
        intermediate output is referenced by a route/shortcut (a padded
        tensor must not land in the saved outputs of a logical consumer)."""
        for j in range(i + 1, n):
            kind = layers[j].kind
            if kind == "conv":
                return None if any(x in referenced for x in range(i, j)) else j
            if kind not in ("maxpool", "upsample"):
                return None
        return None

    steps: List[NetStep] = []
    carry = Layout(in_channels)             # layout of `cur` entering layer i
    for i, l in enumerate(layers):
        info = infos[i]
        ih, iw, ic = info["in"]
        oh_, ow_, oc = info["out"]
        plan = plans[i]
        if l.kind == "conv":
            algo = plan.algorithm
            plan = _snap_row_tile(plan, algo, oh_)
            in_mult = _in_channel_multiple(plan)
            if carry.pad_c and carry.phys_c % in_mult == 0:
                in_layout = carry           # producer elided into us
            else:
                in_layout = Layout(ic, ceil_to(ic, in_mult) - ic)
            # Every kernel emits exactly its weights' out channels, so
            # padding them offline to the next conv's multiple makes the
            # extra channels act(0 + 0) = 0 and the next conv takes them as
            # they are: no crop here and no re-pad there.
            out_phys = oc
            j = next_conv(i)
            if j is not None:
                out_phys = ceil_to(oc, _in_channel_multiple(plans[j]))
            out_layout = Layout(oc, out_phys - oc)
            carry = out_layout
        elif l.kind in ("maxpool", "upsample"):
            in_layout = carry
            out_layout = carry
        else:
            if not carry.trivial:           # pragma: no cover - by invariant
                raise AssertionError(
                    f"padded activation reached logical consumer {l.kind!r}"
                )
            in_layout = Layout(ic)
            out_layout = Layout(oc)
            carry = out_layout
        steps.append(NetStep(
            index=i, layer=l, spec=info["spec"], plan=plan,
            in_hw=(ih, iw), out_hw=(oh_, ow_),
            in_layout=in_layout, out_layout=out_layout,
        ))
    return NetworkPlan(steps=tuple(steps), input_hw=(h, w),
                       in_channels=in_channels, batch=batch, impl=impl,
                       dtype=dtype)


def network_key(layers: Sequence[Any], h: int, w: int, in_channels: int,
                batch: int, planner: Planner, dtype: str = "float32") -> str:
    """The cache key of a whole-network entry: a digest of the layer table
    (as ``CNNModel.digest``), the input, the batch, the requested dtype and
    every planner setting that changes a layer's decision (the plan keys'
    fields, the measuring device's name and the model's fit digest among
    them)."""
    import hashlib

    digest = hashlib.sha1(repr(tuple(layers)).encode()).hexdigest()[:16]
    wf = planner.winograd_fused
    parts = ["net", digest, f"h{h}w{w}", f"ci{in_channels}", f"b{batch}",
             planner.hw.name, dtype, planner.impl, planner.mode,
             "wf" + ("a" if wf is None else str(int(wf)))]
    if planner.mode == "measure":
        parts.append(f"dev={planner.device_name()}")
    if planner.mode == "model":
        parts.append(f"fit={planner.hw.fit_digest}")
    return "|".join(parts)


def plan_network(
    layers: Sequence[Any],
    h: int,
    w: int,
    planner: Planner,
    in_channels: int = 3,
    batch: int = 1,
    dtype: str = "float32",
) -> NetworkPlan:
    """Resolve every conv's ConvPlan through ``planner`` under the
    requested ``dtype`` (int8 resolves per layer), then the layouts.

    Warm (the planner holds this network's entry, ``network_key``): the
    NetworkPlan is rebuilt from the entry, with no per-layer lookup and
    no tune, and ``planner.network_hits`` counts it.  An entry that does
    not rebuild replans.  Cold: the plan is built and its entry stored.
    """
    layers = tuple(layers)
    key = network_key(layers, h, w, in_channels, batch, planner, dtype)
    entry = planner.network_entry(key)
    if entry is not None:
        try:
            netplan = _netplan_from_entry(layers, entry)
        except (KeyError, ValueError, TypeError, IndexError, AssertionError):
            pass                            # a corrupt entry replans
        else:
            planner.network_hits += 1
            return netplan
    plans: List[Optional[ConvPlan]] = [
        (planner.plan(info["spec"], info["in"][0], info["in"][1], batch=batch,
                      dtype=dtype)
         if l.kind == "conv" else None)
        for l, info in zip(layers, _propagate_shapes(layers, h, w, in_channels))
    ]
    netplan = build_network_plan(layers, h, w, plans, in_channels=in_channels,
                                 batch=batch, impl=planner.impl, dtype=dtype)
    planner.put_network_entry(key, _entry_from_netplan(netplan))
    return netplan


def _entry_from_netplan(netplan: NetworkPlan) -> Dict[str, Any]:
    return {
        "input_hw": list(netplan.input_hw),
        "in_channels": netplan.in_channels,
        "batch": netplan.batch,
        "impl": netplan.impl,
        "dtype": netplan.dtype,
        "steps": [
            {
                "plan": s.plan.to_json() if s.plan is not None else None,
                "in_hw": list(s.in_hw),
                "out_hw": list(s.out_hw),
                "in_layout": s.in_layout.to_json(),
                "out_layout": s.out_layout.to_json(),
            }
            for s in netplan.steps
        ],
    }


def _netplan_from_entry(layers: Tuple[Any, ...],
                        entry: Dict[str, Any]) -> NetworkPlan:
    """The NetworkPlan an entry records; raises where the entry does not
    fit the layer table (a conv without a plan, a plan on another layer,
    a shape the layer table does not give)."""
    recs = entry["steps"]
    if len(recs) != len(layers):
        raise ValueError("network entry does not match the layer table")
    infos = _propagate_shapes(layers, *entry["input_hw"], entry["in_channels"])
    steps = []
    for i, (l, r, info) in enumerate(zip(layers, recs, infos)):
        plan = ConvPlan.from_json(r["plan"]) if r["plan"] is not None else None
        if (plan is not None) != (l.kind == "conv"):
            raise ValueError(f"network entry step {i}: plan {plan} for a "
                             f"{l.kind!r} layer")
        in_hw, out_hw = tuple(r["in_hw"]), tuple(r["out_hw"])
        if in_hw != info["in"][:2] or out_hw != info["out"][:2]:
            raise ValueError(f"network entry step {i}: shapes {in_hw} -> "
                             f"{out_hw}, the layer table's {info['in']} -> "
                             f"{info['out']}")
        if plan is not None and not plan_is_current(
                plan, info["spec"], *in_hw, int(entry["batch"])):
            raise ValueError(f"network entry step {i}: blocks "
                             f"{plan.kernel_blocks} are not the kernel's")
        steps.append(NetStep(
            index=i, layer=l, spec=info["spec"], plan=plan,
            in_hw=in_hw, out_hw=out_hw,
            in_layout=Layout.from_json(r["in_layout"]),
            out_layout=Layout.from_json(r["out_layout"]),
        ))
    return NetworkPlan(steps=tuple(steps),
                       input_hw=tuple(entry["input_hw"]),
                       in_channels=int(entry["in_channels"]),
                       batch=int(entry["batch"]), impl=str(entry["impl"]),
                       dtype=str(entry["dtype"]))


# ---------------------------------------------------------------------------
# Pipeline partitioning (layer-pipelined multi-device execution)
#
# The multi-device analogue of the per-layer co-design: the partition is
# planned from each step's predicted seconds (``step_seconds``), not
# guessed from layer counts.  A stage is a contiguous ``steps[start:stop]``
# slice; cuts fall only where the boundary activation is logically laid
# out (a trivial ``out_layout`` under the port's own channel steps, so no
# padded channels cross a device) and no route or shortcut reaches back
# over the cut.

#: Modeled fixed seconds of one tick of the pipeline schedule: the term
#: that keeps ``choose_n_micro`` from picking as many microbatches as it
#: can.  The reference's 2e-6 was sized for its TPU schedule.  This is the
#: H100's own: a tick of 2 stages that do no work (each a graph replay, its
#: stream waits and the boundary copy, distributed/pipeline.py), 8
#: microbatches, as chip_smoke.py's phase 8c times it: the median of 7
#: rounds, 0.2622 ms (rounds 0.1961-0.2910) on an NVIDIA H100 80GB HBM3 at
#: 700 W, where the host's enqueueing bounds it.  ``pipeline_key`` holds
#: it: a partition cached under another tick is made anew, since the
#: microbatch count depends on it.
TICK_OVERHEAD_S = 2.622e-4


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A NetworkPlan split into contiguous, cost-balanced pipeline stages.

    ``stage_bounds[s] = (start, stop)``: stage s runs ``steps[start:stop]``.
    ``stage_seconds[s]`` is the stage's predicted seconds at the plan's
    full batch (the sum of its steps' ``step_seconds``).  ``n_micro`` is
    the microbatch count the chooser resolved (the executor may override
    it).
    """

    stage_bounds: Tuple[Tuple[int, int], ...]
    stage_seconds: Tuple[float, ...]
    n_micro: int

    @property
    def n_stages(self) -> int:
        return len(self.stage_bounds)

    def bubble_fraction(self, n_micro: Optional[int] = None) -> float:
        """GPipe's fill and drain bubble: (S-1)/(m+S-1) of the schedule's
        ticks run fewer than S active stages."""
        m = self.n_micro if n_micro is None else n_micro
        s = self.n_stages
        return (s - 1) / (m + s - 1)

    def modeled_latency_s(self, n_micro: Optional[int] = None,
                          tick_overhead_s: float = TICK_OVERHEAD_S) -> float:
        """Modeled seconds for one full batch through the pipeline
        (``modeled_pipeline_latency``)."""
        m = self.n_micro if n_micro is None else n_micro
        return modeled_pipeline_latency(self.stage_seconds, m,
                                        tick_overhead_s)

    def to_json(self) -> Dict[str, Any]:
        return {
            "stage_bounds": [list(b) for b in self.stage_bounds],
            "stage_seconds": list(self.stage_seconds),
            "n_micro": self.n_micro,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "PipelinePlan":
        return cls(
            stage_bounds=tuple((int(b[0]), int(b[1]))
                               for b in d["stage_bounds"]),
            stage_seconds=tuple(float(t) for t in d["stage_seconds"]),
            n_micro=int(d["n_micro"]),
        )


def step_seconds(netplan: NetworkPlan) -> Tuple[float, ...]:
    """Per-step predicted seconds at the plan's batch.

    Unlike the reference's, which reads ``plan.predicted_s`` alone: a
    cost-mode plan carries no predicted time in the port (its rule
    compares ratios, core/cost_rule.py), so read as it is every step of
    the default mode would weigh 0 s and the partition would be
    arbitrary.  A conv step takes ``plan.predicted_s`` where the plan has
    one (model mode, measure mode, model mode's int8 gate), else the
    card's cost model, ``codesign.predict_conv_time``, for the plan's own
    algorithm, Winograd realization and operand width at the step's shape
    and the plan's batch.  Every other step weighs 0.0 s, as in the
    reference (pools, routes and the fc head are noise beside the convs).
    """
    from repro_torch.core.codesign import predict_conv_time

    out = []
    for s in netplan.steps:
        if s.plan is None:
            out.append(0.0)
        elif s.plan.predicted_s is not None:
            out.append(float(s.plan.predicted_s))
        else:
            width = (1 if s.plan.dtype == "int8"
                     else 2 if s.plan.dtype in HALF_DTYPES else 4)
            out.append(predict_conv_time(
                s.spec, *s.in_hw, s.plan.algorithm, dtype_bytes=width,
                batch=netplan.batch, winograd_fused=s.plan.winograd_fused))
    return tuple(out)


def legal_cut_points(netplan: NetworkPlan) -> List[int]:
    """Boundary indices b where the network may be cut into stages
    (between ``steps[b-1]`` and ``steps[b]``).

    A cut at b is legal iff (1) ``steps[b-1].out_layout`` is trivial: the
    boundary activation is logically laid out, so no elision chain spans
    the device edge (the port's layouts, padded to its kernels' channel
    steps, not the reference's 128 lanes); and (2) no layer j >= b
    references a layer r < b via ``from_layers``.
    """
    from repro_torch.models.cnn import layer_ref_spans

    n = len(netplan.steps)
    spans = layer_ref_spans([s.layer for s in netplan.steps])
    return [b for b in range(1, n)
            if netplan.steps[b - 1].out_layout.trivial
            and not any(r < b <= j for r, j in spans)]


def _bounds_seconds(per_step: Sequence[float],
                    bounds: Sequence[Tuple[int, int]]) -> Tuple[float, ...]:
    return tuple(float(sum(per_step[a:z])) for a, z in bounds)


#: Exact-search budget: partition candidates up to this count are scored
#: directly on the modeled latency; past it the min-max DP takes over.
_EXACT_SEARCH_LIMIT = 200_000


def partition_network(netplan: NetworkPlan, n_stages: int,
                      n_micro: Optional[int] = None,
                      tick_overhead_s: float = TICK_OVERHEAD_S
                      ) -> PipelinePlan:
    """Cost-balanced contiguous partition into ``n_stages`` stages.

    Minimizes ``modeled_pipeline_latency`` over the legal cut set, each
    candidate at its own best microbatch count (or at ``n_micro``), with
    ties broken on the largest stage; past ``_EXACT_SEARCH_LIMIT``
    candidates the min-max linear-partition DP, which optimizes the
    steady-state term only.  The reference's search, on the port's
    ``step_seconds`` and ``tick_overhead_s``.  Raises ValueError when
    fewer than ``n_stages - 1`` legal cuts exist.
    """
    import itertools
    import math

    n = len(netplan.steps)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages={n_stages} for a {n}-step network")
    per_step = step_seconds(netplan)
    cuts = legal_cut_points(netplan)
    if len(cuts) < n_stages - 1:
        raise ValueError(
            f"only {len(cuts)} legal cut points for n_stages={n_stages} "
            f"(elision chains / route spans forbid the rest)")

    def finish(bounds: Tuple[Tuple[int, int], ...]) -> PipelinePlan:
        seconds = _bounds_seconds(per_step, bounds)
        m = (choose_n_micro(seconds, netplan.batch, tick_overhead_s)
             if n_micro is None else n_micro)
        return PipelinePlan(stage_bounds=bounds, stage_seconds=seconds,
                            n_micro=m)

    if math.comb(len(cuts), n_stages - 1) <= _EXACT_SEARCH_LIMIT:
        best_plan: Optional[PipelinePlan] = None
        best_key = (float("inf"), float("inf"))
        for combo in itertools.combinations(cuts, n_stages - 1):
            edges = (0,) + combo + (n,)
            plan = finish(tuple(zip(edges[:-1], edges[1:])))
            # At n_micro=1 the tick sum does not depend on the partition
            # (one active stage a tick): the balanced profile breaks ties.
            key = (plan.modeled_latency_s(tick_overhead_s=tick_overhead_s),
                   max(plan.stage_seconds))
            if key < best_key:
                best_plan, best_key = plan, key
        return best_plan

    # DP: the smallest largest stage.  best[(k, e)] = (max seconds, prev).
    prefix = [0.0]
    for t in per_step:
        prefix.append(prefix[-1] + t)
    ends = cuts + [n]
    best: Dict[Tuple[int, int], Tuple[float, int]] = {(0, 0): (0.0, -1)}
    for k in range(1, n_stages + 1):
        for e in (ends if k < n_stages else [n]):
            cand: Optional[Tuple[float, int]] = None
            for (pk, pe), (pmax, _) in best.items():
                if pk != k - 1 or pe >= e:
                    continue
                m = max(pmax, prefix[e] - prefix[pe])
                if cand is None or m < cand[0]:
                    cand = (m, pe)
            if cand is not None:
                best[(k, e)] = cand
    if (n_stages, n) not in best:
        raise ValueError(f"no legal {n_stages}-stage partition (cut set "
                         f"{cuts})")
    bounds_rev, e = [], n
    for k in range(n_stages, 0, -1):
        _, pe = best[(k, e)]
        bounds_rev.append((pe, e))
        e = pe
    return finish(tuple(reversed(bounds_rev)))


def equal_count_partition(netplan: NetworkPlan, n_stages: int,
                          n_micro: Optional[int] = None,
                          tick_overhead_s: float = TICK_OVERHEAD_S
                          ) -> PipelinePlan:
    """The strawman the balanced partition must beat: equal layer-count
    stages, each cut at ``round(s * n / n_stages)`` snapped to the nearest
    legal cut; costs are never consulted."""
    n = len(netplan.steps)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages={n_stages} for a {n}-step network")
    legal = legal_cut_points(netplan)
    if len(legal) < n_stages - 1:
        raise ValueError(f"only {len(legal)} legal cut points for "
                         f"n_stages={n_stages}")
    cuts: List[int] = []
    for s in range(1, n_stages):
        target = round(s * n / n_stages)
        avail = [b for b in legal if b > (cuts[-1] if cuts else 0)]
        # Keep room for the remaining cuts to stay increasing.
        remaining = n_stages - 1 - s
        avail = avail[:len(avail) - remaining] if remaining else avail
        if not avail:
            raise ValueError("cannot place equal-count cuts legally")
        cuts.append(min(avail, key=lambda b: (abs(b - target), b)))
    edges = [0] + cuts + [n]
    bounds = tuple(zip(edges[:-1], edges[1:]))
    seconds = _bounds_seconds(step_seconds(netplan), bounds)
    if n_micro is None:
        n_micro = choose_n_micro(seconds, netplan.batch, tick_overhead_s)
    return PipelinePlan(stage_bounds=bounds, stage_seconds=seconds,
                        n_micro=n_micro)


def modeled_pipeline_latency(stage_seconds: Sequence[float], n_micro: int,
                             tick_overhead_s: float = TICK_OVERHEAD_S
                             ) -> float:
    """Modeled seconds for one batch through the GPipe schedule.

    Each of the ``n_micro + n_stages - 1`` ticks lasts as long as the
    slowest active stage's share of one microbatch (stage seconds are at
    the full batch and scale down linearly with the split), plus the
    fixed tick overhead:

        latency(m) = sum_t max{T_s / m : stage s active at tick t}
                     + (m + S - 1) * overhead
    """
    s = len(stage_seconds)
    per_mb = [t / n_micro for t in stage_seconds]
    total = 0.0
    for t in range(n_micro + s - 1):
        active = [per_mb[i] for i in range(s) if t >= i and t - i < n_micro]
        if active:
            total += max(active)
    return total + (n_micro + s - 1) * tick_overhead_s


def choose_n_micro(stage_seconds: Sequence[float], batch: int,
                   tick_overhead_s: float = TICK_OVERHEAD_S) -> int:
    """The microbatch count, among the divisors of ``batch``, with the
    least modeled latency; a tie goes to the smaller count."""
    if batch < 1:
        raise ValueError(f"batch={batch}")
    best_m, best_t = 1, float("inf")
    for m in range(1, batch + 1):
        if batch % m:
            continue
        t = modeled_pipeline_latency(stage_seconds, m, tick_overhead_s)
        if t < best_t:
            best_m, best_t = m, t
    return best_m


def pipeline_key(layers: Sequence[Any], h: int, w: int, in_channels: int,
                 batch: int, n_stages: int, planner: Planner,
                 dtype: str = "float32") -> str:
    """The cache key of a stage-partition entry: the network's key plus
    the stage count and the tick overhead the partition was chosen
    under."""
    return (network_key(layers, h, w, in_channels, batch, planner, dtype)
            + f"|stages{n_stages}|tick{TICK_OVERHEAD_S!r}")


def plan_pipeline(layers: Sequence[Any], h: int, w: int, planner: Planner,
                  n_stages: int, in_channels: int = 3, batch: int = 1,
                  dtype: str = "float32",
                  netplan: Optional[NetworkPlan] = None) -> PipelinePlan:
    """The PipelinePlan of a network through ``planner``'s cache.

    Cold: partitions the (possibly freshly planned) NetworkPlan and stores
    the record as a "pipelines" entry (``pipeline_key``).  Warm: rebuilds
    the PipelinePlan from the entry, re-partitioning nothing
    (``planner.pipeline_hits`` counts it).  An entry that does not
    validate (not a contiguous cover of the steps, a cut that is not
    legal) re-partitions.
    """
    layers = tuple(layers)
    if netplan is None:
        netplan = plan_network(layers, h, w, planner, in_channels=in_channels,
                               batch=batch, dtype=dtype)
    key = pipeline_key(layers, h, w, in_channels, batch, n_stages, planner,
                       dtype)
    entry = planner.pipeline_entry(key)
    if entry is not None:
        try:
            pipeplan = PipelinePlan.from_json(entry)
            _validate_pipeline_bounds(pipeplan, len(netplan.steps), n_stages)
            legal = set(legal_cut_points(netplan))
            if any(a not in legal for a, _ in pipeplan.stage_bounds[1:]):
                raise ValueError(f"illegal cut in {pipeplan.stage_bounds}")
        except (KeyError, ValueError, TypeError, IndexError):
            pass                            # a corrupt entry re-partitions
        else:
            planner.pipeline_hits += 1
            return pipeplan
    pipeplan = partition_network(netplan, n_stages)
    planner.put_pipeline_entry(key, pipeplan.to_json())
    return pipeplan


def _validate_pipeline_bounds(pipeplan: PipelinePlan, n_steps: int,
                              n_stages: int) -> None:
    """Raise unless the bounds are a contiguous cover of [0, n_steps)."""
    bounds = pipeplan.stage_bounds
    if len(bounds) != n_stages:
        raise ValueError(f"{len(bounds)} stages, wanted {n_stages}")
    if bounds[0][0] != 0 or bounds[-1][1] != n_steps:
        raise ValueError(f"bounds {bounds} do not cover [0, {n_steps})")
    for (a0, z0), (a1, _) in zip(bounds, bounds[1:]):
        if z0 != a1 or a0 >= z0:
            raise ValueError(f"non-contiguous bounds {bounds}")
    if bounds[-1][0] >= bounds[-1][1]:
        raise ValueError(f"empty final stage in {bounds}")
    if pipeplan.n_micro < 1:
        raise ValueError(f"n_micro={pipeplan.n_micro}")
    if len(pipeplan.stage_seconds) != n_stages:
        raise ValueError("stage_seconds length mismatch")


# ---------------------------------------------------------------------------
# Parameter preparation (offline: folding, padding, weight pre-transform)


def pretransform_flags(
    netplan: NetworkPlan, pretransform: bool = True
) -> Tuple[bool, ...]:
    """Per-step "weights carry the offline Winograd transform" flags: the
    conv steps whose resolved algorithm is Winograd.  The flag travels
    explicitly from preparation to execution, never sniffed from shapes."""
    if not pretransform:
        return (False,) * len(netplan.steps)
    return tuple(
        s.layer.kind == "conv" and s.plan.algorithm is ConvAlgorithm.WINOGRAD
        for s in netplan.steps
    )


def prepare_net_params(
    netplan: NetworkPlan,
    params: Sequence[Dict],
    pretransform: bool = False,
    calibration=None,
) -> List[Dict]:
    """Offline parameter preparation for a NetworkPlan.

    Folds inference batchnorm into conv weights + bias, pads every conv's
    weights/bias to the step's physical channel layouts, and — with
    ``pretransform`` — applies the offline Winograd weight transform to
    exactly the layers ``pretransform_flags(netplan, pretransform)`` names.

    A bf16 or fp16 step's prepared weights are rounded to its type, once,
    after the fold, the pad and the transform (all in fp32); transformed
    Winograd weights are split into hi and lo parts of its type
    (``winograd.split_transformed``: rounded once, U loses F(6,3) several
    percent of the output); its bias stays fp32.  The reference keeps the
    caller's fp32 weights and upcasts them in its products; the tensor
    cores take both operands in 16 bits.

    The steps whose plan resolved to int8 are quantized (core/quant.py): a
    plain fp32 walk over ``calibration`` (a sample input batch; the seeded
    ``default_calibration_batch`` when None) gives each one's
    per-input-channel activation scales, folded into the weights before
    per-output-channel int8 quantization.  Such a step's entry holds ``w``
    (int8), ``b``, ``w_scale`` (the dequant row) and ``x_scale`` (the entry
    quantization's scales, padded with ones so zero pad channels quantize
    to 0 and act(0 * scale + 0) = 0 still holds); it never carries the
    Winograd transform.
    """
    from repro_torch.core.winograd import split_transformed, transform_weights
    from repro_torch.models.cnn import fold_batchnorm

    flags = pretransform_flags(netplan, pretransform)
    params = fold_batchnorm(params, [s.layer for s in netplan.steps])
    int8_steps = {s.index for s in netplan.steps
                  if s.layer.kind == "conv" and s.plan.dtype == "int8"}
    act_scales: Dict[int, torch.Tensor] = {}
    if int8_steps:
        from repro_torch.core.quant import (
            calibrate_activation_scales,
            default_calibration_batch,
        )

        if calibration is None:
            calibration = default_calibration_batch(*netplan.input_hw,
                                                    netplan.in_channels)
        act_scales = calibrate_activation_scales(netplan, params, calibration)
    out: List[Dict] = []
    for s, p, pre in zip(netplan.steps, params, flags):
        if s.layer.kind != "conv":
            out.append(p)
            continue
        w, b = p["w"], p["b"]
        cin_pad = s.in_layout.phys_c - w.shape[2]
        o_pad = s.out_layout.phys_c - w.shape[3]
        if s.index in int8_steps:
            from repro_torch.core.quant import quantize_conv_weights

            assert not pre, "int8 steps never carry the Winograd transform"
            x_scale = act_scales[s.index]
            w, w_scale = quantize_conv_weights(w, x_scale)
            w = F.pad(w, (0, o_pad, 0, cin_pad))
            # Ones, not zeros: the entry quantization divides by these.
            x_scale = F.pad(x_scale, (0, cin_pad), value=1.0)
            out.append({"w": w.contiguous(),
                        "b": pad_bias_row(b, s.out_layout.phys_c).contiguous(),
                        "w_scale": pad_bias_row(w_scale, s.out_layout.phys_c),
                        "x_scale": x_scale})
            continue
        if cin_pad or o_pad:
            w = F.pad(w, (0, o_pad, 0, cin_pad))
            b = pad_bias_row(b, s.out_layout.phys_c)
        if pre:
            w = transform_weights(w)                    # (8, 8, Cp, Op)
        if s.plan.dtype in HALF_DTYPES:
            # Rounded once, after the fold, the pad and the transform in
            # fp32: the 16-bit kernels take both operands in their type;
            # transformed Winograd weights go split into hi and lo parts.
            # The bias stays fp32.
            if pre:
                w = split_transformed(w, HALF_DTYPES[s.plan.dtype])
            else:
                from repro_torch.kernels.gemm.ops import tma_rows16

                # Rows padded for the kernels' TMA (a head's N = 255), once.
                out.append({"w": tma_rows16(w.to(HALF_DTYPES[s.plan.dtype])),
                            "b": b.contiguous()})
                continue
        out.append({"w": w.contiguous(), "b": b.contiguous()})
    return out


# ---------------------------------------------------------------------------
# Execution


def _align_channels(x: torch.Tensor, want_phys: int) -> torch.Tensor:
    """Zero-pad a logical activation to a conv's input layout (a padded one
    already matches it: build_network_plan pads only for that consumer)."""
    have = x.shape[-1]
    return F.pad(x, (0, want_phys - have)) if have < want_phys else x


def _maxpool_same(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Max pool with XLA's "SAME" padding of -inf: the pad is split with
    the larger half after, so YOLOv3-tiny's size-2 stride-1 pool pads only
    the right and bottom, by 1 (``nn.MaxPool2d`` pads both sides)."""
    _, h, w, _ = x.shape

    def pads(n: int) -> Tuple[int, int]:
        total = max((-(-n // stride) - 1) * stride + size - n, 0)
        return total // 2, total - total // 2

    (pt, pb), (pl, pr) = pads(h), pads(w)
    y = x.permute(0, 3, 1, 2)                           # NCHW view
    if pt or pb or pl or pr:
        y = F.pad(y, (pl, pr, pt, pb), value=float("-inf"))
    y = F.max_pool2d(y, size, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def run_step(
    step: NetStep,
    p: Dict,
    cur: torch.Tensor,
    outputs: Sequence[torch.Tensor],
    pretransformed: bool = False,
) -> torch.Tensor:
    """One planned layer of ``run_network`` on its input ``cur``, with the
    earlier steps' ``outputs`` (for route and shortcut, indexed by
    absolute layer index: a list from layer 0, or a dict) and the step's
    prepared params ``p``.

    A conv pads its input to its layout; an int8 conv (its params carry
    ``w_scale``) quantizes its fp32 input with ``x_scale`` and dequantizes
    in the kernel's epilogue, so the activations between layers stay fp32.
    """
    from repro_torch.core.conv2d import conv2d
    from repro_torch.core.quant import quantize_activation

    l = step.layer
    if l.kind == "conv":
        cur = _align_channels(cur, step.in_layout.phys_c)
        if "w_scale" in p:
            cur = quantize_activation(cur, p["x_scale"])
            epi = Epilogue(bias=p["b"], activation=l.activation,
                           scale=p["w_scale"])
        else:
            epi = Epilogue(bias=p["b"], activation=l.activation)
        return conv2d(
            cur, p["w"], step.spec, plan=step.plan, epilogue=epi,
            in_layout=step.in_layout, out_layout=step.out_layout,
            pretransformed=pretransformed,
        )
    return layer_op(l, p, cur, outputs)


def layer_op(l: Any, p: Dict, cur: torch.Tensor,
             outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Layer ``l`` that is not a conv: Darknet's maxpool (SAME, -inf pad),
    avgpool, nearest upsample, shortcut, route, and fc on the spatial
    mean.  Shared by the forward and the int8 calibration walk.  Each
    runs in its input's type; the fc head promotes a 16-bit input to its
    fp32 weights' type."""
    if l.kind == "maxpool":
        return _maxpool_same(cur, l.size, l.stride)
    if l.kind == "avgpool":
        return cur.mean(dim=(1, 2))
    if l.kind == "upsample":
        # Each pixel repeated size x size times by a broadcast and one
        # copy: no output size to read back from the card, which a CUDA
        # graph capture would refuse.
        b, h, w, c = cur.shape
        return cur[:, :, None, :, None, :].expand(
            b, h, l.size, w, l.size, c).reshape(b, h * l.size, w * l.size, c)
    if l.kind == "shortcut":
        return cur + outputs[l.from_layers[0]]
    if l.kind == "route":
        return torch.cat([outputs[j] for j in l.from_layers], dim=-1)
    if l.kind == "fc":
        if cur.ndim == 4:
            cur = cur.mean(dim=(1, 2))
        # A 16-bit activation times fp32 weights promotes to fp32, as the
        # reference's product does.
        cur = cur.to(torch.promote_types(cur.dtype, p["w"].dtype))
        return apply_activation(cur @ p["w"] + p["b"], l.activation)
    raise ValueError(f"unknown layer kind {l.kind!r}")


def run_network(
    netplan: NetworkPlan,
    params: Sequence[Dict],
    x: torch.Tensor,
    pretransformed: Optional[Sequence[bool]] = None,
    start: int = 0,
    stop: Optional[int] = None,
) -> torch.Tensor:
    """The planned whole-network forward on prepared params: ``run_step``
    over every step.

    Pads at entry (the first conv's input layout) and after a logical
    consumer (route, shortcut), and flows padded activations across every
    elided boundary; the last layer's output is logical.
    ``pretransformed`` is the per-step flag tuple from
    ``pretransform_flags`` (None: no weight carries the transform).

    ``start``/``stop`` run the ``steps[start:stop]`` slice only: one
    pipeline stage.  ``params`` is then the slice's own list
    (``params[j - start]`` for layer j), while ``pretransformed`` stays
    the whole network's, looked up by absolute index; routes and
    shortcuts find their sources by absolute index too.  A slice begins at
    a cut of ``legal_cut_points``: its input is logically laid out, and
    no ``from_layers`` reference reaches back before ``start`` (ValueError
    otherwise).  The reference crops at exit only in a slice that holds
    the last step; the port's forward needs no exit crop (its last
    layer's output is logical), so no slice crops.
    """
    n_steps = len(netplan.steps)
    stop = n_steps if stop is None else stop
    if not 0 <= start <= stop <= n_steps:
        raise ValueError(f"slice [{start}, {stop}) of a {n_steps}-step "
                         f"network")
    flags = (tuple(pretransformed) if pretransformed is not None
             else (False,) * n_steps)
    if start:
        from repro_torch.models.cnn import layer_ref_spans

        spans = layer_ref_spans([s.layer for s in netplan.steps[:stop]])
        if any(r < start <= j for r, j in spans):
            raise ValueError(f"a slice starting at step {start} cuts a "
                             f"route or shortcut span ({spans})")
    outputs: Dict[int, torch.Tensor] = {}     # by absolute layer index
    cur = x
    for s in netplan.steps[start:stop]:
        cur = run_step(s, params[s.index - start], cur, outputs,
                       flags[s.index])
        outputs[s.index] = cur
    return cur


def expected_channel_ops(netplan: NetworkPlan) -> List[Dict[str, Any]]:
    """The channel-axis pads, crops and concatenations ``run_network``
    makes between kernels, predicted from the plan: what the verifier's
    channel census (``analysis/record.py``) must find.

    The port's layout rule, not the reference's: every kernel emits exactly
    its weights' out channels, padded offline to the next conv's multiple
    (``build_network_plan``), so no crop runs between kernels and none at
    the network's exit.  What remains: a conv whose input carries fewer
    channels than its layout pads them (``_align_channels``: the network's
    entry, and a conv after a logical consumer), and a route over more
    than one source (``torch.cat`` on the channel axis).  The reference's
    ``expected_channel_ops`` also predicts the kernel wrappers' crops to
    the TPU's 128-lane blocks and the exit crop; the port has neither.
    """
    ops: List[Dict[str, Any]] = []
    outputs_phys: List[int] = []
    cur = netplan.in_channels
    for s in netplan.steps:
        l = s.layer
        if l.kind == "conv":
            if cur < s.in_layout.phys_c:
                ops.append({"step": s.index, "kind": "pad"})
            cur = s.out_layout.phys_c
        elif l.kind == "route":
            sources = [outputs_phys[j] for j in l.from_layers]
            if len(sources) > 1:
                ops.append({"step": s.index, "kind": "cat"})
            cur = sum(sources)
        elif l.kind == "fc":
            cur = l.out_channels
        outputs_phys.append(cur)
    return ops


def params_to(params: Sequence[Dict], device, copy: bool = True
              ) -> List[Dict]:
    """Prepared params on ``device``; with ``copy``, a copy even where they
    already lie there: each stage or shard holds its own."""
    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return v.to(device, copy=copy)
        return v

    return [move(p) for p in params]


class NetworkExecutor:
    """Whole-network inference over a NetworkPlan.

    Prepares parameters offline (fold + pad + optional Winograd
    pre-transform; calibration and quantization of the int8 steps, from
    ``calibration``) once.  On the card, a call replays one CUDA graph of
    the forward (``graphs.CapturedCall``, the counterpart of the
    reference's ``jax.jit``), captured at the first call: the executor is
    fixed to one batch and input size, so one graph serves every call.  On
    the CPU a call runs ``run_network`` eagerly.  ``eager`` runs the
    forward eagerly on either device, for comparison.  ``pool``: the
    graph's memory pool (``torch.cuda.graph_pool_handle()``, shared by a
    ``CompiledCNN``'s executors); None, a pool of its own.

    ``devices``: the reference's rule, data parallel over the batch when
    more than one device is given and the batch divides their count.
    Each shard (``graphs.DeviceCall``) holds the prepared params on its
    device (the first shard takes them as they are where they lie there,
    every other a copy of its own; ``params`` is then None) and runs the full batch's plan at ``batch / n``
    (the kernels take their split counts from the call's shapes) as a
    CUDA graph of its own, in a pool of its own, on a stream of its own;
    a call joins the shards' outputs in order on the input's device.  A
    device may repeat.  Otherwise the forward runs on one device:
    ``devices[0]`` where given, else the params' own (``pool`` serves
    this case only).
    """

    def __init__(
        self,
        netplan: NetworkPlan,
        params: Sequence[Dict],
        pretransform: bool = True,
        calibration=None,
        pool=None,
        devices: Optional[Sequence[Any]] = None,
    ):
        from repro_torch.graphs import DeviceCall

        self.netplan = netplan
        prepared = prepare_net_params(netplan, params,
                                      pretransform=pretransform,
                                      calibration=calibration)
        self.params: Optional[List[Dict]] = None
        self.pretransformed = pretransform_flags(netplan, pretransform)
        self.graph = None
        self._pool = pool
        devices = [torch.device(d) for d in (devices or ())]
        self.shards: List[Any] = []
        self.device: Optional[torch.device] = None
        if len(devices) > 1 and netplan.batch % len(devices) == 0:
            mb = netplan.batch // len(devices)
            self.shards = [
                DeviceCall(self._shard_forward(
                    params_to(prepared, d, copy=i > 0)), d,
                    f"batch shard {i} ({netplan.dtype}, batch {mb} of "
                    f"{netplan.batch} at {netplan.input_hw[0]}x"
                    f"{netplan.input_hw[1]}) on {d}")
                for i, d in enumerate(devices)]
        elif devices:
            self.device = devices[0]
            self.params = params_to(prepared, self.device, copy=False)
        else:
            self.params = prepared

    def _shard_forward(self, params: List[Dict]):
        def forward(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return run_network(self.netplan, params, x,
                                   pretransformed=self.pretransformed)
        return forward

    def _check(self, x: torch.Tensor) -> None:
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        if (h, w) != self.netplan.input_hw or b != self.netplan.batch:
            raise ValueError(
                f"executor planned for batch {self.netplan.batch} at "
                f"{self.netplan.input_hw}, got {tuple(x.shape)}"
            )

    def eager(self, x: torch.Tensor) -> torch.Tensor:
        """The forward, run eagerly: ``run_network`` on the prepared
        params (each shard's on its own slice of the batch), the input
        cast to ``netplan.input_dtype`` as ``run()`` casts it; the output
        on the input's device."""
        self._check(x)
        x = x.to(getattr(torch, self.netplan.input_dtype))
        if self.shards:
            mb = x.shape[0] // len(self.shards)
            return torch.cat([
                sh.body(x[i * mb:(i + 1) * mb].to(sh.device)).to(x.device)
                for i, sh in enumerate(self.shards)])
        src = x.device
        if self.device is not None:
            x = x.to(self.device)
        with torch.inference_mode():
            y = run_network(self.netplan, self.params, x,
                            pretransformed=self.pretransformed)
        return y.to(src)

    def capture(self, x: torch.Tensor) -> None:
        """Capture the forward's CUDA graph (each shard's) on ``x`` (a
        batch on the card) unless it is captured: the warm-up and capture
        that the first call would make, without the call's replay."""
        self._check(x)
        if self.shards:
            mb = x.shape[0] // len(self.shards)
            for sh in self.shards:
                sh.capture(torch.zeros((mb, *x.shape[1:]), dtype=x.dtype,
                                       device=sh.device))
        elif self.graph is None:
            from repro_torch.graphs import CapturedCall

            p = self.netplan
            x = x if self.device is None else x.to(self.device)
            with torch.cuda.device(x.device):
                self.graph = CapturedCall(
                    self.eager, (x,),
                    f"the planned forward ({p.dtype}, batch {p.batch} at "
                    f"{p.input_hw[0]}x{p.input_hw[1]})", pool=self._pool)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return self.eager(x)
        self.capture(x)
        if self.shards:
            return self._sharded(x)
        if self.device is None or x.device == self.device:
            return self.graph(x)
        with torch.cuda.device(self.device):
            return self.graph(x.to(self.device)).to(x.device)

    def _sharded(self, x: torch.Tensor) -> torch.Tensor:
        """Each shard's slice of ``x`` to its device on its stream, its
        replay, its output copied on its stream into the joined output on
        ``x``'s device; the caller's stream waits for every shard (so the
        allocator hands out ``x``'s and the output's memory again only
        after their last reader and writer)."""
        caller = torch.cuda.current_stream(x.device)
        mb = x.shape[0] // len(self.shards)
        out = None
        for i, sh in enumerate(self.shards):
            sh.stream.wait_stream(caller)
            with torch.cuda.stream(sh.stream):
                xi = x[i * mb:(i + 1) * mb].to(sh.device, non_blocking=True)
            y = sh.run(xi)
            if out is None:
                out = torch.empty((x.shape[0], *y.shape[1:]), dtype=y.dtype,
                                  device=x.device)
            sh.emit(out[i * mb:(i + 1) * mb])
        for sh in self.shards:
            caller.wait_stream(sh.stream)
        return out

"""Network-level inference planning and execution.

The port of ``repro/core/netplan.py`` (single device, no jit):

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
                quantization), then ``run_network`` per call.

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

    def kernel_launches(self) -> Dict[str, int]:
        """Planned launches per CUDA kernel in one forward: one per conv
        step (of the int8 kernel on an int8 step), and one of each of the
        three kernels per 3-pass Winograd step (kernel names as
        ``kernels.conv_ops.plan_kernels``)."""
        from repro_torch.kernels.conv_ops import plan_kernels

        counts: Dict[str, int] = {}
        for s in self.steps:
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
    earlier steps' ``outputs`` (for route and shortcut) and the step's
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
) -> torch.Tensor:
    """The planned whole-network forward on prepared params: ``run_step``
    over every step.

    Pads at entry (the first conv's input layout) and after a logical
    consumer (route, shortcut), and flows padded activations across every
    elided boundary; the last layer's output is logical.
    ``pretransformed`` is the per-step flag tuple from
    ``pretransform_flags`` (None: no weight carries the transform).
    """
    flags = (tuple(pretransformed) if pretransformed is not None
             else (False,) * len(netplan.steps))
    outputs: List[torch.Tensor] = []
    cur = x
    for s in netplan.steps:
        cur = run_step(s, params[s.index], cur, outputs, flags[s.index])
        outputs.append(cur)
    return cur


class NetworkExecutor:
    """Whole-network inference over a NetworkPlan on one device.

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
    """

    def __init__(
        self,
        netplan: NetworkPlan,
        params: Sequence[Dict],
        pretransform: bool = True,
        calibration=None,
        pool=None,
    ):
        self.netplan = netplan
        self.params = prepare_net_params(netplan, params,
                                         pretransform=pretransform,
                                         calibration=calibration)
        self.pretransformed = pretransform_flags(netplan, pretransform)
        self.graph = None
        self._pool = pool

    def _check(self, x: torch.Tensor) -> None:
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        if (h, w) != self.netplan.input_hw or b != self.netplan.batch:
            raise ValueError(
                f"executor planned for batch {self.netplan.batch} at "
                f"{self.netplan.input_hw}, got {tuple(x.shape)}"
            )

    def eager(self, x: torch.Tensor) -> torch.Tensor:
        """The forward, run eagerly: ``run_network`` on the prepared
        params, the input cast to ``netplan.input_dtype`` as ``run()``
        casts it."""
        self._check(x)
        x = x.to(getattr(torch, self.netplan.input_dtype))
        with torch.inference_mode():
            return run_network(self.netplan, self.params, x,
                               pretransformed=self.pretransformed)

    def capture(self, x: torch.Tensor) -> None:
        """Capture the forward's CUDA graph on ``x`` (a batch on the card)
        unless it is captured: the warm-up and capture that the first call
        would make, without the call's replay."""
        self._check(x)
        if self.graph is None:
            from repro_torch.graphs import CapturedCall

            p = self.netplan
            self.graph = CapturedCall(
                self.eager, (x,),
                f"the planned forward ({p.dtype}, batch {p.batch} at "
                f"{p.input_hw[0]}x{p.input_hw[1]})", pool=self._pool)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return self.eager(x)
        self.capture(x)
        return self.graph(x)

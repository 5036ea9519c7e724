"""The launches a NetworkPlan says its forward makes, from the plan alone.

For every conv step this module predicts, without running anything, the
launch descriptors the executor's kernel wrappers will record: the same
builder functions the wrappers call (``gemm_launches``,
``im2col_launches``, ``winograd_launches`` beside each family's wrapper),
fed by the plan's shapes instead of tensors.  This module owns only the
dispatch that mirrors ``kernels/conv_ops._conv2d_cuda_laidout``: the same
algorithm routing, the same int8 and 16-bit choices, the same physical
channel counts (the step's layouts), so drift against the wrappers is a
one-file diff.

Beside each descriptor a ``PlannedLaunch`` carries what the passes hold it
to: its bytes under the reference layouts (``reference_netplan``, the
traffic audit's expected side), the cost model's ideal-reuse bytes for the
step (a metric), and the shared memory the cost model prices the launch
with (``smem_model`` through ``codesign.conv_estimate``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.conv_spec import ConvAlgorithm
from repro_torch.kernels._launch import LaunchDescriptor
from repro_torch.util import HALF_DTYPES


@dataclasses.dataclass(frozen=True)
class PlannedLaunch:
    """A launch the plan predicts, with the figures its passes compare."""

    desc: LaunchDescriptor
    ref_hbm_bytes: Optional[int] = None
    ideal_hbm_bytes: Optional[int] = None
    model_smem_bytes: Optional[int] = None


def planned_kernels(step) -> bool:
    """Does this step run kernels under the plan (a conv with its plan)?"""
    return step.layer.kind == "conv" and step.plan is not None


def _width(dtype: str) -> int:
    return 1 if dtype == "int8" else 2 if dtype in HALF_DTYPES else 4


def step_descriptors(netplan, step, batch: Optional[int] = None
                     ) -> List[LaunchDescriptor]:
    """The launches one conv step makes, in order, at ``batch`` (the
    plan's by default; a pipeline stage runs at its microbatch).

    Empty for the steps that are not convs (pools, routes, the fc head run
    as plain torch).  One or two launches (a split fp32 or int8 kernel and
    its reduce) for direct, im2col and fused Winograd; three for the 3-pass
    Winograd pipeline.
    """
    if not planned_kernels(step):
        return []
    from repro_torch.kernels.gemm.ops import gemm_launches
    from repro_torch.kernels.im2col_gemm.ops import im2col_launches
    from repro_torch.kernels.winograd.ops import winograd_launches

    b = netplan.batch if batch is None else batch
    plan, spec = step.plan, step.spec
    h, w = step.in_hw
    cp = step.in_layout.phys_c           # activation channels entering
    o = step.out_layout.phys_c           # the weights' out channels
    if plan.algorithm is ConvAlgorithm.DIRECT:
        # Padded, then subsampled: conv_ops' direct path.
        (ph, pw), (sh, sw) = spec.padding, spec.stride
        m = b * -(-(h + 2 * ph) // sh) * -(-(w + 2 * pw) // sw)
        descs = gemm_launches(m, o, cp, plan.dtype)
    elif plan.algorithm is ConvAlgorithm.WINOGRAD:
        oh, ow = spec.out_hw(h, w)
        t = b * -(-oh // 6) * -(-ow // 6)
        descs = winograd_launches(t, cp, o, plan.dtype,
                                  fused=bool(plan.winograd_fused))
    elif plan.dtype in HALF_DTYPES:
        descs = im2col_launches(b, h, w, cp, o, spec, dtype=plan.dtype)
    else:
        toh, _, bo = plan.kernel_blocks
        descs = im2col_launches(b, h, w, cp, o, spec, toh, plan.dtype,
                                bo=bo)
    return [dataclasses.replace(d, step=step.index) for d in descs]


def model_smem_bytes(netplan, step, batch: Optional[int] = None):
    """{kernel: shared memory a block} of the launches the cost model
    prices for this step's candidate (``codesign.conv_estimate`` at the
    step's shape, algorithm, Winograd realization and operand width)."""
    from repro_torch.core.codesign import conv_estimate

    b = netplan.batch if batch is None else batch
    plan = step.plan
    est = conv_estimate(step.spec, *step.in_hw, plan.algorithm,
                        dtype_bytes=_width(plan.dtype), batch=b,
                        winograd_fused=bool(plan.winograd_fused))
    return {p.kernel: p.smem_bytes for p in est.parts
            if not p.kernel.startswith("glue")}


def ideal_traffic_bytes(netplan, step, batch: Optional[int] = None
                        ) -> Optional[int]:
    """The cost model's ideal-reuse bytes for one conv step on logical
    shapes: a metric beside each launch's bytes, never gated (padded
    channels inflate the ratio by design)."""
    if not planned_kernels(step):
        return None
    from repro_torch.core.smem_model import (
        im2col_gemm_traffic_bytes,
        winograd_traffic_bytes,
    )

    b = netplan.batch if batch is None else batch
    plan, spec = step.plan, step.spec
    d = _width(plan.dtype)
    oh, ow = spec.out_hw(*step.in_hw)
    cin, cout = spec.in_channels, spec.out_channels
    if plan.algorithm is ConvAlgorithm.DIRECT:
        m = b * oh * ow
        return d * (m * cin + cin * cout) + (4 if d == 1 else d) * m * cout
    if plan.algorithm is ConvAlgorithm.WINOGRAD:
        return winograd_traffic_bytes(oh, ow, cin, cout, batch=b,
                                      dtype_bytes=d,
                                      fused=bool(plan.winograd_fused))
    return im2col_gemm_traffic_bytes(oh, ow, cin, cout, spec.kh, spec.kw,
                                     batch=b, dtype_bytes=d)


def reference_netplan(netplan):
    """Rebuild the layout decisions from the stored per-layer plans.

    ``build_network_plan`` is deterministic given (layers, shapes, plans),
    so this reconstructs what the layouts should be: the expected side of
    the elision-decision check and of the traffic audit.  A NetworkPlan
    whose stored ``Layout``s were corrupted (inflated physical channels, a
    forced un-elided boundary) diverges from it though its stored plans
    are untouched.
    """
    from repro_torch.core.netplan import build_network_plan

    return build_network_plan(
        [s.layer for s in netplan.steps], *netplan.input_hw,
        plans=[s.plan for s in netplan.steps],
        in_channels=netplan.in_channels, batch=netplan.batch,
        impl=netplan.impl, dtype=netplan.dtype,
    )


def network_descriptors(netplan, reference=None, batch: Optional[int] = None,
                        start: int = 0, stop: Optional[int] = None
                        ) -> List[PlannedLaunch]:
    """The launches of ``steps[start:stop]`` in program order, at ``batch``.

    The descriptors come from the stored plan (those are per-launch
    facts); each carries its bytes under the reference layouts, the
    traffic audit's expected side.
    """
    reference = reference or reference_netplan(netplan)
    out: List[PlannedLaunch] = []
    for step, ref_step in zip(netplan.steps[start:stop],
                              reference.steps[start:stop]):
        stored = step_descriptors(netplan, step, batch)
        if not stored:
            continue
        ref = step_descriptors(reference, ref_step, batch)
        model = model_smem_bytes(netplan, step, batch)
        ideal = ideal_traffic_bytes(netplan, step, batch)
        for i, desc in enumerate(stored):
            out.append(PlannedLaunch(
                desc, ref[i].hbm_bytes if i < len(ref) else None, ideal,
                model.get(desc.kernel)))
    return out

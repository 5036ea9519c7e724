"""Entry points of the port's plan verifier.

``verify_network`` proves a NetworkPlan's invariants against the forward
that will run: it runs the forward once on zeros with the launch recorder
and the channel census open (``analysis/record.py``: on the CPU the
kernels' plain versions run and the wrappers record what they would
launch; on the card the kernels run) and holds the recorded launches
against the plan's (``analysis/descriptors.py``).  ``level="plan"``
records nothing and checks only what the plan alone can prove: its
launches' shared memory and the layout decisions.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis.descriptors import (
    network_descriptors,
    reference_netplan,
)
from repro_torch.analysis.passes import (
    accum_pass,
    bounds_pass,
    dtype_consistent_pairs,
    dtype_pass,
    elision_pass,
    kernel_metrics,
    layout_consistent_pairs,
    overflow_pass,
    race_pass,
    smem_pass,
    structure_pass,
    tag_steps,
    traffic_pass,
)
from repro_torch.analysis.report import Finding, VerifyReport
from repro_torch.hw import H100

LEVELS = ("off", "plan", "kernel", "full")

#: The kernel pass suite (the ``kernel`` rung's additions).
KERNEL_PASSES = ("race", "bounds", "accum", "overflow")


def _run_kernel_passes(report: VerifyReport, launches, pairs) -> None:
    race_pass(report, launches)
    bounds_pass(report, launches)
    accum_pass(report, launches)
    overflow_pass(report, pairs)


def _params_device(params: Sequence[Dict]):
    for p in params:
        for v in p.values():
            if hasattr(v, "device"):
                return v.device
    return "cpu"


def _forward_input(netplan, batch: int, device):
    import torch

    h, w = netplan.input_hw
    return torch.zeros((batch, h, w, netplan.in_channels),
                       dtype=getattr(torch, netplan.input_dtype),
                       device=device)


def verify_network(
    netplan,
    params: Optional[Sequence[Dict[str, Any]]] = None,
    pretransformed: Optional[Sequence[bool]] = None,
    level: str = "full",
    smem_budget: Optional[int] = None,
    name: Optional[str] = None,
) -> VerifyReport:
    """Statically verify a NetworkPlan and, beyond ``level='plan'``, the
    launches of one recorded forward.

    The rungs, cheapest first: ``"plan"`` checks what the plan alone can
    prove (each planned launch's shared memory within the budget and equal
    to the cost model's figure, and the layout decisions; no forward);
    ``"kernel"`` records one forward and runs the structure pass and the
    kernel passes (race, bounds, accum, overflow) on its launches;
    ``"full"`` runs everything: structure, smem, traffic, elision and
    dtype over the recorded launches, then the kernel passes.

    ``params`` is the prepared parameter list (``prepare_net_params``:
    folded, padded, int8-quantized, Winograd-pretransformed), on the device
    the forward should run on; ``pretransformed`` the per-step flags (None:
    ``pretransform_flags(netplan, True)``).  ``smem_budget`` defaults to
    the opt-in shared memory a block of ``hw.H100``.
    """
    if level not in ("plan", "kernel", "full"):
        raise ValueError(f"level must be 'plan', 'kernel' or 'full', got "
                         f"{level!r}")
    budget = smem_budget if smem_budget is not None \
        else H100.smem_per_block_bytes
    reference = reference_netplan(netplan)
    planned = network_descriptors(netplan, reference)
    report = VerifyReport(
        level=level,
        network={
            "name": name or f"{len(netplan.steps)}-layer network",
            "batch": netplan.batch,
            "input_hw": list(netplan.input_hw),
            "dtype": netplan.dtype,
            "impl": netplan.impl,
            "expected_launches": len(planned),
            "smem_budget": budget,
        },
    )
    if level == "plan":
        report.passes_run = ("smem", "elision")
        elision_pass(report, netplan, reference, None)
        smem_pass(report, [p.desc for p in planned],
                  [p.model_smem_bytes for p in planned], budget)
        report.kernels = kernel_metrics([(p.desc, p) for p in planned],
                                        budget)
        return report
    if params is None:
        raise ValueError(f"level={level!r} needs the prepared parameter list")

    from repro_torch.analysis.record import record_forward
    from repro_torch.core.netplan import pretransform_flags

    if pretransformed is None:
        pretransformed = pretransform_flags(netplan, True)
    x = _forward_input(netplan, netplan.batch, _params_device(params))
    try:
        launches, census, _ = record_forward(netplan, params, x,
                                             pretransformed)
    except (ValueError, AssertionError) as err:
        # A wrapper refused what the plan asks of it (a block its kernel
        # is not compiled for, a layout its operands do not have).
        report.passes_run = ("structure",)
        report.add(Finding(pass_name="structure", severity="error",
                           message=f"the forward refused the plan: {err}"))
        return report
    launches = tag_steps(launches, planned)
    pairs = structure_pass(report, launches, planned)
    # Byte and kernel passes only where the launched precision is the
    # plan's: a dtype defect surfaces as a dtype finding, not as noise.
    byte_pairs = dtype_consistent_pairs(pairs)
    if level == "kernel":
        report.passes_run = ("structure",) + KERNEL_PASSES
        _run_kernel_passes(report, launches, byte_pairs)
        report.kernels = kernel_metrics(byte_pairs, budget)
        return report
    report.passes_run = (("structure", "smem", "traffic", "elision", "dtype")
                         + KERNEL_PASSES)
    smem_pass(report, [r for r, _ in byte_pairs],
              [p.model_smem_bytes for _, p in byte_pairs], budget)
    traffic_pass(report, layout_consistent_pairs(byte_pairs, netplan,
                                                 reference))
    elision_pass(report, netplan, reference, census)
    dtype_pass(report, pairs, netplan)
    _run_kernel_passes(report, launches, byte_pairs)
    report.kernels = kernel_metrics(byte_pairs, budget)
    return report


def verify_pipeline(
    netplan,
    pipeplan,
    name: Optional[str] = None,
    params: Optional[Sequence[Dict[str, Any]]] = None,
    pretransformed: Optional[Sequence[bool]] = None,
    level: str = "plan",
) -> VerifyReport:
    """Statically verify a stage partition against its NetworkPlan.

    At ``level="plan"`` (no forward): the stage bounds are a contiguous
    cover, every cut lands on a legal boundary (a logical producer layout,
    so no elision chain crosses a device edge, and no ``from_layers`` span
    reaching back into an earlier stage), the recorded per-stage seconds
    equal the sums of ``step_seconds``, and the microbatch count tiles the
    batch.

    At ``level="kernel"`` (``params`` the prepared list): each stage's
    ``run_network(start=, stop=)`` slice is recorded at microbatch size on
    the previous stage's output (the forwards the pipeline executor
    captures), matched to the plan's launches of its steps at that batch,
    and the kernel passes run over every stage's launches.
    """
    from repro_torch.core.netplan import legal_cut_points, step_seconds

    report = VerifyReport(
        level="plan",
        network={
            "name": name or f"{len(netplan.steps)}-layer network",
            "batch": netplan.batch,
            "input_hw": list(netplan.input_hw),
            "dtype": netplan.dtype,
            "impl": netplan.impl,
            "n_stages": pipeplan.n_stages,
            "n_micro": pipeplan.n_micro,
        },
    )
    report.passes_run = ("pipeline",)

    def err(message, **kw):
        report.add(Finding(pass_name="pipeline", severity="error",
                           message=message, **kw))

    n = len(netplan.steps)
    bounds = pipeplan.stage_bounds
    if not bounds or bounds[0][0] != 0 or bounds[-1][1] != n:
        err(f"stage bounds {bounds} do not cover the {n}-step network")
        return report
    prev_end = 0
    for a, z in bounds:
        if a != prev_end or a >= z:
            err(f"stage bounds {bounds} are not a contiguous cover")
            return report
        prev_end = z
    legal = set(legal_cut_points(netplan))
    for a, _ in bounds[1:]:
        if a not in legal:
            step = netplan.steps[a - 1]
            why = ("inside a layout-elision chain"
                   if not step.out_layout.trivial
                   else "crossing a route/shortcut dependency span")
            err(f"cut at step {a} is illegal ({why})", step=a)
    per_step = step_seconds(netplan)
    for si, ((a, z), rec) in enumerate(zip(bounds, pipeplan.stage_seconds)):
        want = float(sum(per_step[a:z]))
        if abs(rec - want) > 1e-9 + 1e-6 * max(abs(want), 1.0):
            report.add(Finding(
                pass_name="pipeline", severity="error",
                message=("stage {} recorded seconds disagree with the "
                         "plan's per-step predicted seconds".format(si)),
                step=a, expected=want, actual=float(rec)))
    if pipeplan.n_micro < 1 or netplan.batch % pipeplan.n_micro:
        err(f"n_micro={pipeplan.n_micro} does not tile batch "
            f"{netplan.batch}")

    if level not in ("plan", "kernel"):
        raise ValueError(f"level must be 'plan' or 'kernel', got {level!r}")
    if level == "kernel":
        if params is None:
            raise ValueError("level='kernel' needs the prepared parameter "
                             "list")
        if report.ok:
            _verify_pipeline_kernels(report, netplan, pipeplan, params,
                                     pretransformed)
    return report


def _verify_pipeline_kernels(report: VerifyReport, netplan, pipeplan, params,
                             pretransformed) -> None:
    """Record every stage slice at microbatch size and run the structure
    pass and the kernel passes over each stage's launches."""
    from repro_torch.analysis.record import record_forward
    from repro_torch.core.netplan import pretransform_flags

    if pretransformed is None:
        pretransformed = pretransform_flags(netplan, True)
    mb = netplan.batch // pipeplan.n_micro
    reference = reference_netplan(netplan)
    cur = _forward_input(netplan, mb, _params_device(params))
    all_launches: List[Any] = []
    all_pairs: List[Any] = []
    for a, z in pipeplan.stage_bounds:
        launches, _, cur = record_forward(netplan, list(params[a:z]), cur,
                                          pretransformed, start=a, stop=z)
        planned = network_descriptors(netplan, reference, batch=mb, start=a,
                                      stop=z)
        launches = tag_steps(launches, planned)
        pairs = structure_pass(report, launches, planned)
        all_launches.extend(launches)
        all_pairs.extend(dtype_consistent_pairs(pairs))
    _run_kernel_passes(report, all_launches, all_pairs)
    report.kernels = kernel_metrics(all_pairs, H100.smem_per_block_bytes)
    report.level = "kernel"
    report.passes_run = ("pipeline", "structure") + KERNEL_PASSES

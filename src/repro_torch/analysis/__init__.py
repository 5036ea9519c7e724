"""The port's plan verifier: static analysis over launch descriptors.

The port of ``repro.analysis``.  Proves, before an executor is built,
that a compiled NetworkPlan keeps its promises: every launch's shared
memory fits the card's budget and is the figure the cost model prices it
with, every launch moves the bytes the plan's layouts account for, the
layout-elision contract holds (no unplanned channel pads, crops or
concatenations between kernels), each launch runs its step's precision,
and, inside each launch, every output element is written once (race),
every read window stays inside its operand or is a TMA box the copy
engine fills (bounds), every split's partial is summed once in split
order (accum) and int8 sums stay within int32 (overflow).

It reads no trace.  Each kernel wrapper builds a launch descriptor
(kernels/_launch.py) of every launch it makes, from its operands, and
takes its split count and its allocations from it; the verifier records
them over one forward and holds them against the descriptors the plan
predicts with the same functions, and on the card ``chip_smoke.py`` holds
them against what each CUDA library's launcher computes
(``kernels._launch.describe``).

    from repro_torch.analysis import verify_network
    report = verify_network(netplan, prepared_params)
    assert report.clean, report.summary()

Or through the facade: ``ExecutionOptions(validate="full")`` /
``CompiledCNN.verify_report()``.  CLI: ``python -m repro_torch.analysis
vgg16``.
"""
from repro_torch.analysis.report import (
    PASSES,
    Finding,
    PlanVerificationError,
    VerifyReport,
    dump_json,
)
from repro_torch.analysis.record import (
    ChannelCensus,
    ChannelOp,
    record_forward,
    record_launches,
)
from repro_torch.analysis.descriptors import (
    PlannedLaunch,
    network_descriptors,
    reference_netplan,
    step_descriptors,
)
from repro_torch.analysis.verifier import (
    KERNEL_PASSES,
    LEVELS,
    verify_network,
    verify_pipeline,
)

__all__ = [
    "ChannelCensus",
    "ChannelOp",
    "Finding",
    "KERNEL_PASSES",
    "LEVELS",
    "PASSES",
    "PlanVerificationError",
    "PlannedLaunch",
    "VerifyReport",
    "dump_json",
    "network_descriptors",
    "record_forward",
    "record_launches",
    "reference_netplan",
    "step_descriptors",
    "verify_network",
    "verify_pipeline",
]

"""Structured findings for the port's plan verifier.

The port's own copy of ``repro/analysis/report.py``: the same fields, the
same ``to_json`` and ``summary``.  A verification run produces a
``VerifyReport``: a list of ``Finding``s (one per violated invariant — a
clean network yields an empty list) plus per-launch metric rows (shared
memory, traffic, splits) that are always recorded, findings or not.  The
port checks shared memory where the reference checks VMEM: the ``smem``
pass takes the place of the reference's, and ``network["smem_budget"]``
that of its budget.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

#: The plan-level passes (smem/traffic/elision/dtype) plus the structural
#: pre-pass that matches recorded launches to the plan's (a mismatch there
#: invalidates the others), the pipeline pass (stage-partition legality,
#: ``verify_pipeline``), and the kernel passes of the ``kernel`` rung:
#: race (each output element written once), bounds (every read window
#: inside its operand, or a TMA box the copy engine fills), accum (each
#: split's partial summed once, in split order) and overflow (int8 sums
#: within int32).
PASSES = (
    "structure", "smem", "traffic", "elision", "dtype", "pipeline",
    "race", "bounds", "accum", "overflow",
)
SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``expected`` / ``actual`` carry the two sides of a byte (or count)
    comparison when the pass is quantitative; ``step`` is the NetworkPlan
    step index the finding anchors to (None for network-level findings) and
    ``kernel`` the launch's kernel name when one is implicated.
    """

    pass_name: str
    severity: str
    message: str
    step: Optional[int] = None
    kernel: Optional[str] = None
    expected: Optional[float] = None
    actual: Optional[float] = None

    def __post_init__(self):
        assert self.pass_name in PASSES, self.pass_name
        assert self.severity in SEVERITIES, self.severity

    def to_json(self) -> Dict[str, Any]:
        d = {
            "pass": self.pass_name,
            "severity": self.severity,
            "message": self.message,
        }
        if self.step is not None:
            d["step"] = self.step
        if self.kernel is not None:
            d["kernel"] = self.kernel
        if self.expected is not None:
            d["expected"] = self.expected
        if self.actual is not None:
            d["actual"] = self.actual
        return d

    def __str__(self) -> str:
        loc = []
        if self.step is not None:
            loc.append(f"step {self.step}")
        if self.kernel:
            loc.append(self.kernel)
        where = f" [{', '.join(loc)}]" if loc else ""
        qty = ""
        if self.expected is not None or self.actual is not None:
            qty = f" (expected {self.expected}, actual {self.actual})"
        return f"{self.severity}:{self.pass_name}{where}: {self.message}{qty}"


@dataclasses.dataclass
class VerifyReport:
    """The verifier's output: findings + always-on per-launch metrics.

    ``ok`` is True iff no *error* findings (warnings don't fail a build);
    ``clean`` is True iff there are no findings at all — the acceptance bar
    for the reference networks.
    """

    findings: List[Finding] = dataclasses.field(default_factory=list)
    kernels: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    passes_run: Tuple[str, ...] = ()
    level: str = "full"
    network: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    @property
    def clean(self) -> bool:
        return not self.findings

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def by_pass(self, pass_name: str) -> List[Finding]:
        return [f for f in self.findings if f.pass_name == pass_name]

    def to_json(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "clean": self.clean,
            "level": self.level,
            "passes": list(self.passes_run),
            "network": dict(self.network),
            "findings": [f.to_json() for f in self.findings],
            "kernels": [dict(r) for r in self.kernels],
        }

    def summary(self) -> str:
        head = (
            f"verify[{self.level}] {self.network.get('name', '?')}: "
            f"{len(self.kernels)} kernels, "
            f"{len(self.findings)} finding(s) "
            f"({'ok' if self.ok else 'FAIL'})"
        )
        lines = [head] + ["  " + str(f) for f in self.findings]
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.summary()


class PlanVerificationError(RuntimeError):
    """Raised by the facade when ``ExecutionOptions.validate`` is on and the
    verifier reports error findings: the compiled model violates a plan
    invariant, so its executor is not built."""

    def __init__(self, report: VerifyReport):
        self.report = report
        super().__init__(report.summary())


def dump_json(report: VerifyReport) -> str:
    return json.dumps(report.to_json(), indent=2, sort_keys=True)

"""The verifier's passes: arithmetic over launch descriptors and records.

Each pass appends ``Finding``s to a shared ``VerifyReport``.  The
quantities come from two derivations of the same forward: the planned
side from the NetworkPlan (``analysis/descriptors.py``), the recorded side
from the descriptors the kernel wrappers built from their own tensors as
the forward ran (``analysis/record.py``), so a disagreement is a real
contract violation, never a tautology.  The kernel passes (race, bounds,
accum, overflow) read the recorded descriptors' own tile maps, windows,
splits and depths.

Both sides compute bytes and shared memory with the same integer
arithmetic, so every comparison here is exact: one byte over a budget, or
one byte apart from the cost model's figure, is a finding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.descriptors import PlannedLaunch
from repro_torch.analysis.report import Finding, VerifyReport
from repro_torch.kernels._launch import LaunchDescriptor
from repro_torch.util import HALF_DTYPES

#: Symmetric int8 quantization magnitude (core/quant.py clips both the
#: activations and the weights to [-127, 127]).
Q8_MAX = 127
INT32_MAX = 2**31 - 1

Pair = Tuple[LaunchDescriptor, PlannedLaunch]
_SUFFIXES = ("_q8", "_16")


def _base(kernel: str) -> str:
    for sfx in _SUFFIXES:
        kernel = kernel.replace(sfx, "")
    return kernel


def _error(report: VerifyReport, pass_name: str, message: str,
           desc: Optional[LaunchDescriptor] = None, **kw) -> None:
    report.add(Finding(
        pass_name=pass_name, severity="error", message=message,
        step=kw.pop("step", desc.step if desc is not None else None),
        kernel=kw.pop("kernel", desc.kernel if desc is not None else None),
        **kw))


def tag_steps(recorded: Sequence[LaunchDescriptor],
              planned: Sequence[PlannedLaunch]) -> List[LaunchDescriptor]:
    """The recorded launches, each tagged with the step of the planned
    launch in its place (a launch past the plan's keeps none)."""
    return [dataclasses.replace(r, step=p.desc.step)
            for r, p in zip(recorded, planned)] + list(recorded[len(planned):])


def structure_pass(report: VerifyReport,
                   recorded: Sequence[LaunchDescriptor],
                   planned: Sequence[PlannedLaunch]) -> List[Pair]:
    """Match the recorded launches to the plan's, in order.

    Returns the (recorded, planned) pairs the per-launch passes run over.
    A count or kernel mismatch is itself a finding (the plan and the
    forward disagree about which kernels run, so comparing bytes past it
    would be noise); a mismatch in the precision suffix alone is a dtype
    defect, kept for the dtype pass.
    """
    if len(recorded) != len(planned):
        _error(report, "structure",
               "the forward makes a different number of launches than the "
               "plan expects", expected=len(planned), actual=len(recorded))
    pairs: List[Pair] = []
    for rec, plan in zip(recorded, planned):
        if _base(rec.kernel) != _base(plan.desc.kernel):
            _error(report, "structure",
                   f"kernel mismatch: the plan expects "
                   f"{plan.desc.kernel!r}, the forward launched "
                   f"{rec.kernel!r}", rec)
            continue
        pairs.append((rec, plan))
    return pairs


def dtype_consistent_pairs(pairs: Sequence[Pair]) -> List[Pair]:
    """The pairs whose launched kernel is the plan's, precision included.

    The byte passes run over these only: where a step's declared type is
    wrong, every expected quantity derived from it is wrong too, and the
    dtype pass names the one real defect."""
    return [(r, p) for r, p in pairs if r.kernel == p.desc.kernel]


def layout_consistent_pairs(pairs: Sequence[Pair], netplan,
                            reference) -> List[Pair]:
    """The pairs whose step keeps the layout decision the rules derive.

    The traffic audit runs over these only: a boundary planned against the
    layout rules (a forced un-elided boundary) moves other bytes by
    construction, and the elision pass names that defect."""
    agree = {s.index for s, r in zip(netplan.steps, reference.steps)
             if s.out_layout.trivial == r.out_layout.trivial}
    return [(r, p) for r, p in pairs if p.desc.step in agree]


# ---------------------------------------------------------------------------
# Plan-level and byte passes


def smem_pass(report: VerifyReport, descs: Sequence[LaunchDescriptor],
              models: Sequence[Optional[int]], budget: int) -> None:
    """Each launch's shared memory (dynamic and static, a block) fits the
    budget and is the figure the cost model prices the same candidate with
    (``core/smem_model.py``)."""
    for desc, model in zip(descs, models):
        if desc.smem_bytes > budget:
            _error(report, "smem",
                   "a block's shared memory exceeds the budget", desc,
                   expected=budget, actual=desc.smem_bytes)
        if model is not None and desc.smem_bytes != model:
            _error(report, "smem",
                   "shared memory differs from the cost model's figure for "
                   "this launch", desc, expected=model,
                   actual=desc.smem_bytes)


def traffic_pass(report: VerifyReport, pairs: Sequence[Pair]) -> None:
    """Each launch's bytes through device memory (every operand read or
    written once) equal those of the same launch under the reference
    layouts (``descriptors.reference_netplan``): corrupt stored layouts
    that inflate physical channels move bytes the plan never asked for."""
    for rec, plan in pairs:
        if plan.ref_hbm_bytes is not None and \
                rec.hbm_bytes != plan.ref_hbm_bytes:
            _error(report, "traffic",
                   "the launch moves other bytes than the plan's layouts "
                   "account for", rec, expected=plan.ref_hbm_bytes,
                   actual=rec.hbm_bytes)


def elision_pass(report: VerifyReport, netplan, reference,
                 census: Optional[Sequence[Any]]) -> None:
    """The layout-elision contract, in two halves: (a) every stored
    boundary decision (channels kept padded, or logical) is the one
    ``build_network_plan`` derives from the same per-layer plans; (b) the
    forward's census of channel pads, crops and concatenations between
    kernels equals ``netplan.expected_channel_ops`` (``census`` None: the
    plan rung, no forward)."""
    from repro_torch.core.netplan import expected_channel_ops

    for s, r in zip(netplan.steps, reference.steps):
        if s.layer.kind != "conv":
            continue
        stored, ref = not s.out_layout.trivial, not r.out_layout.trivial
        if stored != ref:
            _error(report, "elision",
                   "boundary planned un-elided but the layout rules elide it"
                   if ref else
                   "boundary planned elided but the layout rules forbid it",
                   step=s.index, kernel=None, expected=int(ref),
                   actual=int(stored))
    if census is None:
        return
    expected = expected_channel_ops(netplan)
    for kind in ("pad", "crop", "cat"):
        na = sum(1 for o in census if o.kind == kind)
        ne = sum(1 for o in expected if o["kind"] == kind)
        if na != ne:
            _error(report, "elision",
                   f"channel-axis {kind} count in the forward disagrees "
                   "with the plan's boundary accounting", expected=ne,
                   actual=na)


def _operand_dtype(role: str, step_dtype: str, name: str) -> str:
    """The type a data operand of an ``step_dtype`` step must have."""
    if name == "ws":
        return "int32" if step_dtype == "int8" else "float32"
    if step_dtype == "int8":
        return "int8" if role == "in" else "float32"
    return step_dtype


def dtype_pass(report: VerifyReport, pairs: Sequence[Pair], netplan) -> None:
    """Each launch's kernel is its step's precision (the int8 kernels on an
    int8 step, the 16-bit ones on a bf16 or fp16 step, the fp32 ones
    otherwise) and its operands are of the step's type: int8 operands in,
    int32 partial sums and an fp32 epilogue out of an int8 kernel; the
    step's type in and out of a 16-bit one, its partial sums fp32; fp32
    everywhere else; the epilogue's rows (bias, scales) always fp32."""
    steps = {s.index: s for s in netplan.steps}
    for rec, plan in pairs:
        step = steps.get(plan.desc.step)
        want = step.plan.dtype if step is not None else plan.desc.dtype
        q8, half = want == "int8", want in HALF_DTYPES
        if ("_q8" in rec.kernel) != q8 or ("_16" in rec.kernel) != half:
            _error(report, "dtype",
                   f"a {want} step launched {rec.kernel}", rec,
                   step=plan.desc.step)
            continue
        for op in rec.operands:
            need = (_operand_dtype(op.role, want, op.name) if op.data
                    else "float32")
            if op.dtype != need:
                _error(report, "dtype",
                       f"operand {op.name} is {op.dtype}, not {need}", rec)


# ---------------------------------------------------------------------------
# Kernel passes: race, bounds, accum, overflow


def _paint(shape: Tuple[int, ...], boxes) -> np.ndarray:
    counts = np.zeros(shape, dtype=np.uint8)
    for box in boxes:
        counts[tuple(slice(lo, hi) for lo, hi in box)] += 1
    return counts


def race_pass(report: VerifyReport,
              descs: Sequence[LaunchDescriptor]) -> None:
    """Every element of each operand a launch writes is written exactly
    once, by its tile map: no two blocks write one element (a split group
    whose partials go to their own slices of the workspace, summed by the
    reduce after them, or whose ranks store disjoint rows of their
    cluster's sum, writes each element once), and no element is left
    unwritten.  A persistent launch walks its work items in the
    scheduler's order (block b: items b, b + G, ...)."""
    for desc in descs:
        writes: Dict[str, list] = {}
        for w in desc.writes():
            writes.setdefault(w.operand, []).append(w)
        outs = [op.name for op in desc.operands if op.role == "out"]
        for name in outs:
            ws = writes.get(name, [])
            shape = desc.operand(name).shape
            inside = [w for w in ws if all(
                0 <= lo <= hi <= s for (lo, hi), s in zip(w.box, shape))]
            if len(inside) != len(ws):
                continue                # bounds names the escaping box
            counts = _paint(shape, (w.box for w in ws))
            twice = np.argwhere(counts > 1)
            if len(twice):
                at = tuple(int(i) for i in twice[0])
                who = [w.block for w in ws if all(
                    lo <= i < hi for (lo, hi), i in zip(w.box, at))][:2]
                _error(report, "race",
                       f"blocks {who[0]} and {who[1]} write element {at} of "
                       f"{name} ({len(twice)} element(s) written more than "
                       "once)", desc)
            never = int((counts == 0).sum())
            if never:
                _error(report, "race",
                       f"{never} element(s) of {name} are never written",
                       desc, expected=0, actual=never)


def bounds_pass(report: VerifyReport,
                descs: Sequence[LaunchDescriptor]) -> None:
    """Every read window lies inside its operand, except on the dimensions
    where the kernel masks its loads element by element (the conv's
    padding, the ragged edges of a GEMM), or where the operand moves by TMA
    boxes whose reads past it the copy engine fills with zeros, as its
    descriptor says; every written box lies inside its operand."""
    for desc in descs:
        bad = []
        for r in desc.reads():
            op = desc.operand(r.operand)
            if op.tma:
                continue
            for d, ((lo, hi), size) in enumerate(zip(r.box, op.shape)):
                if d not in r.masked and (lo < 0 or hi > size):
                    bad.append((r, d, lo, hi, size))
        for w in desc.writes():
            shape = desc.operand(w.operand).shape
            for d, ((lo, hi), size) in enumerate(zip(w.box, shape)):
                if lo < 0 or hi > size:
                    bad.append((w, d, lo, hi, size))
        if bad:
            acc, d, lo, hi, size = bad[0]
            _error(report, "bounds",
                   f"block {acc.block}'s window of {acc.operand} escapes "
                   f"it: dim {d} covers [{lo}, {hi}) of extent {size} "
                   f"({len(bad)} window(s))", desc, expected=size,
                   actual=hi if hi > size else lo)


def accum_pass(report: VerifyReport,
               descs: Sequence[LaunchDescriptor]) -> None:
    """Every split's partial is summed exactly once, in split order.

    The splits' chunk ranges cover the reduction's chunks once, in order;
    a split launch's partials are summed either by its thread block
    cluster (one cluster of ``splits`` blocks a tile) or by the reduce
    launch that follows it, which reads each of the ``splits`` partials
    once, in split order; a reduce sums a split launch's partials and
    follows one.
    """
    for i, desc in enumerate(descs):
        if desc.kernel.endswith("_reduce"):
            prev = descs[i - 1] if i else None
            if prev is None or prev.kernel + "_reduce" != desc.kernel \
                    or prev.splits != desc.splits:
                _error(report, "accum",
                       "a reduce launch follows no split launch of its "
                       "kernel", desc)
            if desc.sum_order != tuple(range(desc.splits)):
                _error(report, "accum",
                       f"the reduce sums the partials in order "
                       f"{list(desc.sum_order)}, not in split order", desc)
            continue
        n, s = desc.k_chunks, desc.splits
        ranges = list(desc.k_ranges)
        if n == 0 and not ranges and s == 1 and desc.sum_site == "none":
            continue                    # no reduction (a transform)
        if (len(ranges) != s or ranges[0][0] != 0 or ranges[-1][1] != n
                or any(a[1] != b[0] for a, b in zip(ranges, ranges[1:]))
                or any(lo >= hi for lo, hi in ranges)):
            _error(report, "accum",
                   f"split chunk ranges {ranges} do not cover the {n} "
                   "chunks once, in order", desc)
        if s == 1:
            if desc.sum_site != "none":
                _error(report, "accum",
                       "an unsplit launch declares a sum of partials", desc)
            continue
        if desc.sum_order != tuple(range(s)):
            _error(report, "accum",
                   f"partials summed in order {list(desc.sum_order)}, not "
                   "in split order", desc)
        if desc.sum_site == "cluster":
            if desc.cluster != (s, 1, 1):
                _error(report, "accum",
                       f"{s} splits summed in clusters of {desc.cluster}",
                       desc)
        elif desc.sum_site == "reduce":
            nxt = descs[i + 1] if i + 1 < len(descs) else None
            if nxt is None or nxt.kernel != desc.kernel + "_reduce" \
                    or nxt.splits != s:
                _error(report, "accum",
                       "split partials are never summed: no reduce follows",
                       desc)
        else:
            _error(report, "accum",
                   f"split partials summed at {desc.sum_site!r}", desc)


def overflow_pass(report: VerifyReport, pairs: Sequence[Pair]) -> None:
    """int8 sums stay within int32.

    An int8 kernel sums ``k_elems`` products of values in [-127, 127]
    into int32 (its split partials too, summed in int32 by its reduce), so
    |sum| <= k_elems 127^2 over the depth of the whole sum; the pass proves
    that bound under 2^31 - 1.  The plan's declared depth must equal the
    recorded one."""
    for rec, plan in pairs:
        if rec.k_elems is None or rec.kernel.endswith("_reduce"):
            continue
        declared = plan.desc.k_elems
        if declared is not None and declared != rec.k_elems:
            _error(report, "overflow",
                   "the plan's declared reduction depth differs from the "
                   "launch's", rec, expected=declared, actual=rec.k_elems)
        bound = rec.k_elems * Q8_MAX * Q8_MAX
        if bound > INT32_MAX:
            _error(report, "overflow",
                   f"int32 sum can overflow: K*127^2 = {bound} exceeds "
                   f"{INT32_MAX} at depth K={rec.k_elems}", rec,
                   expected=INT32_MAX, actual=bound)


def describe_pass(report: VerifyReport,
                  launches: Sequence[LaunchDescriptor]) -> List[Dict[str, Any]]:
    """Hold each distinct recorded launch against what its CUDA library's
    launcher computes for the same shapes on the current card
    (``kernels._launch.describe``; needs the card).

    Grid, cluster, threads and ring stages must be the descriptor's
    (structure findings); its dynamic and static shared memory must be the
    descriptor's, the dynamic part within the function's limit and both
    within the device's opt-in shared memory a block (smem findings).  A
    persistent launch takes the card's resident blocks a SM
    (``with_resident``), and its tile map is walked again at that grid
    (race).  Returns a row a distinct launch, the card's figures beside the
    descriptor's."""
    from repro_torch.kernels._launch import describe

    rows, seen = [], set()
    for desc in launches:
        key = (desc.library, desc.which, desc.args)
        if key in seen:
            continue
        seen.add(key)
        got = describe(desc)
        if desc.persistent:
            desc = desc.with_resident(got["resident"], got["sm_count"])
            race_pass(report, [desc])
        card = {"grid": (got["grid_x"], got["grid_y"], got["grid_z"]),
                "cluster": (got["cluster_x"], got["cluster_y"],
                            got["cluster_z"]),
                "threads": got["threads"], "stages": got["stages"]}
        for field, value in card.items():
            if getattr(desc, field) != value:
                _error(report, "structure",
                       f"{field} {getattr(desc, field)} differs from the "
                       f"launcher's {value}", desc)
        for field in ("dynamic_smem_bytes", "static_smem_bytes"):
            if getattr(desc, field) != got[field]:
                _error(report, "smem",
                       f"{field} differs from the launcher's", desc,
                       expected=got[field], actual=getattr(desc, field))
        if got["dynamic_smem_bytes"] > got["max_dynamic_smem_bytes"]:
            _error(report, "smem",
                   "dynamic shared memory passes the function's limit", desc,
                   expected=got["max_dynamic_smem_bytes"],
                   actual=got["dynamic_smem_bytes"])
        total = got["dynamic_smem_bytes"] + got["static_smem_bytes"]
        if total > got["smem_optin_bytes"]:
            _error(report, "smem",
                   "shared memory passes the device's opt-in limit", desc,
                   expected=got["smem_optin_bytes"], actual=total)
        rows.append({"kernel": desc.kernel, "function": desc.function,
                     "step": desc.step, "args": list(desc.args),
                     "descriptor": desc.to_json(), "card": got})
    return rows


def kernel_metrics(pairs: Sequence[Pair], budget: int
                   ) -> List[Dict[str, Any]]:
    """Always-recorded rows, one a launch (findings or not)."""
    rows = []
    for rec, plan in pairs:
        row: Dict[str, Any] = {
            "step": rec.step,
            "kernel": rec.kernel,
            "function": rec.function,
            "grid": list(rec.grid),
            "cluster": list(rec.cluster),
            "threads": rec.threads,
            "persistent": rec.persistent,
            "smem_bytes": rec.smem_bytes,
            "smem_model_bytes": plan.model_smem_bytes,
            "smem_budget": budget,
            "splits": rec.splits,
            "sum_site": rec.sum_site,
            "traffic_bytes": rec.hbm_bytes,
            "traffic_expected_bytes": plan.ref_hbm_bytes,
            "traffic_ideal_bytes": plan.ideal_hbm_bytes,
            "reuse_ratio": (round(rec.hbm_bytes / plan.ideal_hbm_bytes, 3)
                            if plan.ideal_hbm_bytes else None),
        }
        if rec.k_elems is not None:
            bound = rec.k_elems * Q8_MAX * Q8_MAX
            row["acc_bound"] = bound
            row["acc_headroom"] = round(INT32_MAX / bound, 3)
        rows.append(row)
    return rows

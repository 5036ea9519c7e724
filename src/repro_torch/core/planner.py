"""Per-layer convolution planner (cost, measure and model modes) with a
persistent plan cache.

The port of ``repro/core/planner.py``'s ``ConvPlan`` and ``Planner``: the
algorithm, Winograd realization, precision and kernel blocks of a conv
layer are decided once per (layer, input shape, batch, mode, policy,
chip) and reused, in memory and, with a ``cache_path``, across processes.

**Cost mode** (the default): the reference planner's own rule
(core/cost_rule.py, the port of its roofline selection).  A 1x1 stride-1
conv goes to the direct GEMM, a 3x3 stride-1 conv to Winograd where the
realization the policy would run (the fused kernel under None and True,
the 3-pass pipeline under False) is cheaper than im2col under the rule,
and everything else to im2col; an explicit ``ConvSpec.algorithm`` wins.
The policy None resolves to the fused kernel, as the reference's
comparison of the two realizations always does.  bf16 and fp16 layers
are priced at their operand width.  The plan's ``source`` is
'cost_rule' and it carries no predicted time: the rule decides as the
reference does, and prices nothing on this card.

**Model mode** (``mode='model'``, the port of the reference's cost mode,
``_tune_cost_model``): the co-design cost model of this card
(``codesign.cheapest_conv`` on core/smem_model.py, with ``hw``'s
constants) prices every launch each candidate makes -- the kernel, its
split-K reduce, the 3-pass pipeline's three kernels, the copies around a
Winograd conv -- and the cheapest is kept with ``source='cost_model'``
and its modeled seconds in ``predicted_s``.  A 3x3 stride-1 layer's
candidates are im2col and the Winograd realizations the policy allows
(both under None), whatever the ``impl``: the plan is the card's.  A
layer the model cannot price raises.

**Measure mode** (the paper's §VII.A method, the port of
``_tune_measured``): every eligible algorithm runs on seeded inputs, and
the fastest is kept with ``source='measured'`` and its seconds in
``predicted_s``.  Under ``impl='cuda'`` a 3x3 stride-1 layer's candidates
are both Winograd realizations (unless the policy forces one) and im2col.
Each candidate runs as ``candidate_call`` sets it up: its own kernel
blocks, the bias + activation epilogue the executor replays, and the
executor's channel padding and weight pre-transform, so it times what the
forward will run.  On the card the time is the device's: CUDA events
around a run of calls with the host's launches hidden (at batch 1 a
call's host time exceeds its kernels' time, and in a forward the host
runs ahead of the card).  On the CPU it is ``perf_counter`` per call.  A
candidate that raises stops planning: a failed build or launch is never
skipped.  A measured plan is keyed by the name of the device it was timed
on too.

**int8** (``plan(..., dtype='int8')``, the port of ``_tune_int8``): a
layer quantizes only when it passes the gates of core/quant.py.  Its fp32
plan is taken first; a layer that fails ``int8_worthwhile`` keeps it; a
1x1 stride-1 conv goes to the int8 GEMM and every other layer to the int8
implicit-GEMM conv, but only where that costs less than the fp32 plan:
under the card's model in model mode, and under the reference's rule in
cost and measure mode (int8 candidates are not timed).

**bf16 and fp16** (``plan(..., dtype='bfloat16' | 'float16')``): every
layer runs in the requested type, through the 16-bit kernel of the
algorithm the mode picks: cost mode's rule at 2-byte operands, measure
mode's timings of the 16-bit candidates, model mode's prices of the
16-bit kernels with their own fitted constants (``hw.H100.kernel_fit``:
``gemm_16`` ... ``glue_16``).

**Persistence** (``cache_path``; None, the default, keeps plans in
memory only).  The cache is one versioned JSON file: "plans" (per layer),
"networks" (whole-network entries, core/netplan.py) and "pipelines"
(stage partitions, core/netplan.plan_pipeline).  ``save`` merges with the file on disk
under a lock and replaces it atomically, so planners that save different
keys converge to the union; a corrupt file is moved aside and what still
parses is salvaged.  A modeled plan's key holds the digest of the
model's fitted constants, so a refit replans.  ``DEFAULT_CACHE_PATH`` is
there for callers who want a file.

Kernel blocks come from each CUDA kernel's own ``pick_blocks``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.hw import H100, ChipSpec
from repro_torch.util import HALF_DTYPES

DTYPES = ("float32", "bfloat16", "float16", "int8")
MODES = ("cost", "measure", "model")
MEASURE_REPS = 10         # timed calls per measure-mode candidate

#: The version of the cache file's layout; a file of another version is a
#: cold start.  2: cost mode decides by the reference's rule.
PLAN_CACHE_VERSION = 2
#: The ``source`` of plans made by a rule cost mode no longer runs (the
#: tile count before version 2): such a plan, in a save artifact, replans.
RETIRED_SOURCES = ("tile_rule",)
#: A cache file for callers who want one (``Planner``'s ``cache_path``
#: defaults to None).
DEFAULT_CACHE_PATH = os.environ.get(
    "REPRO_TORCH_PLAN_CACHE", os.path.join(".cache", "conv_plans_torch.json"))
#: The cache file's sections of whole entries, keyed by their own keys.
SECTIONS = ("plans", "networks", "pipelines")

# ---------------------------------------------------------------------------
# Cache corruption recovery (the reference's, copied): a file that fails to
# parse is moved to ``<path>.corrupt-<pid>``, never overwritten, with one
# warning per path in a process, and every top-level entry that still
# parses is salvaged.

_QUARANTINE_WARNED: set = set()


def _salvage_section(text: str, name: str) -> Dict[str, Any]:
    """Every ``"key": value`` pair of the top-level ``"name": {...}``
    section that parses, up to the first that does not.

    The cache is written with ``indent=1, sort_keys=True``, so a top-level
    section opens as ``\\n "name": {``, which cannot collide with a key of
    the same name nested in an entry.
    """
    anchor = f'\n "{name}": {{'
    start = text.find(anchor)
    if start >= 0:
        pos = start + len(anchor)
    else:
        # A file not written by a planner (compact or re-indented).
        import re

        m = re.search(r'"%s"\s*:\s*\{' % re.escape(name), text)
        if m is None:
            return {}
        pos = m.end()
    decoder = json.JSONDecoder()
    out: Dict[str, Any] = {}
    n = len(text)
    while pos < n:
        while pos < n and text[pos] in " \t\r\n,":
            pos += 1
        if pos >= n or text[pos] == "}" or text[pos] != '"':
            break
        try:
            key, end = decoder.raw_decode(text, pos)
            pos = end
            while pos < n and text[pos] in " \t\r\n":
                pos += 1
            if pos >= n or text[pos] != ":":
                break
            pos += 1
            while pos < n and text[pos] in " \t\r\n":
                pos += 1
            value, end = decoder.raw_decode(text, pos)
            pos = end
        except (json.JSONDecodeError, ValueError):
            break
        out[str(key)] = value
    return out


def _salvage_scalar(text: str, name: str) -> Optional[Any]:
    import re

    m = re.search(r'"%s"\s*:\s*' % re.escape(name), text)
    if m is None:
        return None
    try:
        value, _ = json.JSONDecoder().raw_decode(text, m.end())
    except (json.JSONDecodeError, ValueError):
        return None
    return value


def salvage_cache_text(text: str) -> Dict[str, Any]:
    """What still parses of a corrupt cache file: the version and chip
    scalars and every intact entry of each section before the corruption
    point."""
    data: Dict[str, Any] = {}
    for scalar in ("version", "chip"):
        value = _salvage_scalar(text, scalar)
        if value is not None:
            data[scalar] = value
    for name in SECTIONS:
        data[name] = _salvage_section(text, name)
    return data


def _quarantine_cache(path: str, text: Optional[str]) -> Dict[str, Any]:
    """Move a corrupt cache aside (to a name never used before) and return
    what of it salvages, for the caller to merge."""
    dest: Optional[str] = f"{path}.corrupt-{os.getpid()}"
    n = 1
    while os.path.exists(dest):
        dest = f"{path}.corrupt-{os.getpid()}-{n}"
        n += 1
    try:
        os.replace(path, dest)
    except OSError:
        dest = None     # the file vanished or cannot move; still salvage
    salvaged = salvage_cache_text(text) if text else {}
    n_entries = sum(len(salvaged.get(s, {})) for s in SECTIONS)
    if n_entries:
        # sort_keys writes "version" last, so truncation usually eats it;
        # each entry is still validated where it is read.
        salvaged.setdefault("version", PLAN_CACHE_VERSION)
    if path not in _QUARANTINE_WARNED:
        _QUARANTINE_WARNED.add(path)
        warnings.warn(
            f"plan cache {path!r} is corrupt"
            + (f"; quarantined to {dest!r}" if dest else "")
            + f"; salvaged {n_entries} entr{'y' if n_entries == 1 else 'ies'}"
            f" (a cold plan covers the rest)",
            RuntimeWarning, stacklevel=3)
    return salvaged


def _read_cache(path: str) -> Dict[str, Any]:
    """The cache file's data ({} when unreadable); a corrupt file is
    quarantined and salvaged."""
    try:
        # errors="replace": corrupt bytes may not even be UTF-8.
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError:
        return {}
    try:
        data = json.loads(text)
        if not isinstance(data, dict):
            raise json.JSONDecodeError("top level is not an object", text, 0)
    except json.JSONDecodeError:
        data = _quarantine_cache(path, text)
    return data


# ---------------------------------------------------------------------------
# Plans


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
    entry, 'bfloat16' and 'float16' the 16-bit kernels, 'float32' the fp32
    ones.  ``predicted_s`` is the modeled
    seconds in model mode, the measured seconds in measure mode, and None
    in cost mode (``source`` says which).
    """

    algorithm: ConvAlgorithm
    impl: str
    kernel_blocks: Tuple[int, int, int]
    source: str = "cost_rule"
    winograd_fused: bool = True
    measured_ms: Tuple[Tuple[str, float], ...] = ()
    dtype: str = "float32"
    predicted_s: Optional[float] = None

    @property
    def label(self) -> str:
        """The algorithm, for Winograd its realization, and '_int8' on an
        int8 plan, '_16' on a bf16 or fp16 one."""
        if self.algorithm is ConvAlgorithm.WINOGRAD:
            base = "winograd_fused" if self.winograd_fused else "winograd_3pass"
        else:
            base = self.algorithm.value
        if self.dtype == "int8":
            return base + "_int8"
        return base + ("_16" if self.dtype in HALF_DTYPES else "")

    def to_json(self) -> Dict[str, Any]:
        return {
            "algorithm": self.algorithm.value,
            "impl": self.impl,
            "kernel_blocks": list(self.kernel_blocks),
            "source": self.source,
            "winograd_fused": self.winograd_fused,
            "measured_ms": [[label, ms] for label, ms in self.measured_ms],
            "dtype": self.dtype,
            "predicted_s": self.predicted_s,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ConvPlan":
        blocks = tuple(int(b) for b in d["kernel_blocks"])
        if len(blocks) != 3 or d["dtype"] not in DTYPES:
            raise ValueError(f"not a plan record: {d!r}")
        pred = d.get("predicted_s")
        return cls(
            algorithm=ConvAlgorithm(d["algorithm"]),
            impl=str(d["impl"]),
            kernel_blocks=blocks,
            source=str(d["source"]),
            winograd_fused=bool(d["winograd_fused"]),
            measured_ms=tuple((str(label), float(ms))
                              for label, ms in d.get("measured_ms", ())),
            dtype=d["dtype"],
            predicted_s=None if pred is None else float(pred),
        )


def _itemsize(dtype: str) -> int:
    """Bytes of one operand of a ``dtype`` plan."""
    return {"float32": 4, "int8": 1}.get(dtype, 2)


def plan_key(spec: ConvSpec, h: int, w: int, batch: int, impl: str,
             mode: str, winograd_fused: Optional[bool],
             dtype: str = "float32", chip: str = H100.name,
             device_name: Optional[str] = None,
             fit: Optional[str] = None) -> str:
    """The plan cache key: layer and shape, and every planner setting that
    changes the decision (the Winograd policy, the mode, the requested
    dtype and the chip model the plan is for among them); a measured
    plan's key also names the device it was timed on, so a time taken on
    one card is never reused on another, and a modeled plan's the digest
    of the constants that priced it (``ChipSpec.fit_digest``)."""
    parts = [
        chip, dtype, impl, mode,
        f"wf{'a' if winograd_fused is None else int(winograd_fused)}",
        f"b{batch}", f"h{h}w{w}",
        f"ci{spec.in_channels}co{spec.out_channels}",
        f"k{spec.kh}x{spec.kw}",
        f"s{spec.stride[0]}x{spec.stride[1]}",
        f"p{spec.padding[0]}x{spec.padding[1]}",
        f"d{spec.dilation[0]}x{spec.dilation[1]}",
        spec.algorithm.value,
    ]
    if device_name is not None:
        parts.append(f"dev={device_name}")
    if fit is not None:
        parts.append(f"fit={fit}")
    return "|".join(parts)


def winograd_tiles(spec: ConvSpec, h: int, w: int, batch: int) -> int:
    """6x6 output tiles of a conv: B * ceil(OH/6) * ceil(OW/6)."""
    oh, ow = spec.out_hw(h, w)
    return batch * -(-oh // 6) * -(-ow // 6)


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
    """Resolves and caches ConvPlans.

    ``mode`` is 'cost' (the reference's rule), 'model' (the card's cost model,
    priced with ``hw``) or 'measure' (time the candidates on ``device``).
    ``winograd_fused`` is the Winograd realization policy: None lets the
    planner choose (fused in cost mode, the cheaper in model mode, the
    faster in measure mode under ``impl='cuda'``), True/False force one.

    Lookup order: in memory, then the cache file at ``cache_path`` (read
    once, when the planner is made), then decide.  New decisions and
    network entries reach the file at the next ``save()``: one locked
    read-merge-write per planning burst, not one per miss.
    ``stats`` counts ``hits`` and ``tunes`` (misses that decided);
    ``network_hits`` counts whole-network entries reused and
    ``pipeline_hits`` stage partitions reused (core/netplan.py).
    """

    def __init__(self, impl: str = "cuda", mode: str = "cost",
                 winograd_fused: Optional[bool] = None,
                 device: Any = "cuda", hw: ChipSpec = H100,
                 cache_path: Optional[str] = None):
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
        self.hw = hw
        self.cache_path = cache_path
        self._dirty = False         # entries the file does not hold yet
        self._plans: Dict[str, ConvPlan] = {}
        self._sections: Dict[str, Dict[str, Any]] = {"networks": {},
                                                     "pipelines": {}}
        self.network_hits = 0
        self.pipeline_hits = 0
        self.stats = {"hits": 0, "tunes": 0}
        if cache_path and os.path.exists(cache_path):
            self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        data = _read_cache(self.cache_path)
        if data.get("version") != PLAN_CACHE_VERSION:
            return
        plans = data.get("plans", {})
        for key, d in (plans.items() if isinstance(plans, dict) else ()):
            try:
                self._plans[key] = ConvPlan.from_json(d)
            except (KeyError, ValueError, TypeError):
                continue
        for name, entries in self._sections.items():
            if isinstance(data.get(name), dict):
                entries.update(data[name])

    def save(self) -> None:
        """Write the cache file when entries came since the last save:
        merged with what is on disk (this planner's entries win on a
        shared key), under a lock on a sidecar file, then put in place by
        an atomic rename."""
        if not self.cache_path or not self._dirty:
            return
        d = os.path.dirname(self.cache_path) or "."
        os.makedirs(d, exist_ok=True)
        with open(self.cache_path + ".lock", "w") as lock:
            with contextlib.suppress(ImportError):
                import fcntl     # POSIX; elsewhere the merge still helps

                fcntl.flock(lock, fcntl.LOCK_EX)
            merged: Dict[str, Dict[str, Any]] = {s: {} for s in SECTIONS}
            if os.path.exists(self.cache_path):
                disk = _read_cache(self.cache_path)
                if disk.get("version") == PLAN_CACHE_VERSION:
                    for name in SECTIONS:
                        if isinstance(disk.get(name), dict):
                            merged[name].update(disk[name])
            merged["plans"].update(
                {k: p.to_json() for k, p in self._plans.items()})
            for name, entries in self._sections.items():
                merged[name].update(entries)
            payload = {"version": PLAN_CACHE_VERSION, "chip": self.hw.name,
                       **merged}
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.cache_path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        self._dirty = False

    def __len__(self) -> int:
        return len(self._plans)

    # -- network-level entries (consumed by core/netplan) --------------------

    def network_entry(self, key: str) -> Optional[Dict[str, Any]]:
        """The stored whole-network record for ``key``, or None.
        ``network_hits`` is counted by the consumer, once the entry has
        rebuilt a plan: a corrupt entry that replans is no hit."""
        return self._sections["networks"].get(key)

    def put_network_entry(self, key: str, entry: Dict[str, Any]) -> None:
        """Store a whole-network record (plain JSON data)."""
        self._sections["networks"][key] = entry
        self._dirty = True

    def pipeline_entry(self, key: str) -> Optional[Dict[str, Any]]:
        """The stored stage-partition record for ``key``, or None.
        ``pipeline_hits`` is counted by the consumer
        (core/netplan.plan_pipeline), once the entry has validated."""
        return self._sections["pipelines"].get(key)

    def put_pipeline_entry(self, key: str, entry: Dict[str, Any]) -> None:
        """Store a stage-partition record (plain JSON data)."""
        self._sections["pipelines"][key] = entry
        self._dirty = True

    def device_name(self) -> str:
        """The name the device reports, which keys measured plans."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    # -- planning ------------------------------------------------------------

    def key(self, spec: ConvSpec, h: int, w: int, batch: int,
            dtype: str) -> str:
        return plan_key(spec, h, w, batch, self.impl, self.mode,
                        self.winograd_fused, dtype, self.hw.name,
                        self.device_name() if self.mode == "measure" else None,
                        self.hw.fit_digest if self.mode == "model" else None)

    def plan(self, spec: ConvSpec, h: int, w: int, batch: int = 1,
             dtype: str = "float32") -> ConvPlan:
        """The plan for one layer at one input shape under the requested
        ``dtype`` ('float32', 'bfloat16', 'float16', or 'int8': resolved
        per layer, so the plan's own ``dtype`` may be 'float32'); decides
        on the first miss."""
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
        key = self.key(spec, h, w, batch, dtype)
        cached = self._plans.get(key)
        if cached is not None and plan_is_current(cached, spec, h, w, batch):
            self.stats["hits"] += 1
            return cached
        self.stats["tunes"] += 1
        if dtype == "int8":
            plan = (self._tune_int8_model(spec, h, w, batch)
                    if self.mode == "model"
                    else self._tune_int8(spec, h, w, batch))
        elif self.mode == "measure":
            plan = self._tune_measured(spec, h, w, batch, dtype)
        elif self.mode == "model":
            plan = self._tune_cost_model(spec, h, w, batch, dtype)
        else:
            plan = self._tune_cost(spec, h, w, batch, dtype)
        self._plans[key] = plan
        self._dirty = True
        return plan

    def _candidate(self, spec: ConvSpec, algo: ConvAlgorithm, wf: bool,
                   h: int, w: int, batch: int, source: str,
                   dtype: str = "float32",
                   predicted_s: Optional[float] = None) -> ConvPlan:
        wf = wf and algo is ConvAlgorithm.WINOGRAD
        return ConvPlan(algorithm=algo, impl=self.impl,
                        kernel_blocks=kernel_blocks(spec, algo, h, w, batch,
                                                    wf, dtype),
                        source=source, winograd_fused=wf, dtype=dtype,
                        predicted_s=predicted_s)

    def _tune_cost(self, spec: ConvSpec, h: int, w: int, batch: int,
                   dtype: str = "float32") -> ConvPlan:
        """The reference's rule (core/cost_rule.py) at ``dtype``'s operand
        width, under the realization the policy runs."""
        from repro_torch.core import cost_rule

        wf = self.winograd_fused if self.winograd_fused is not None else True
        algo = cost_rule.select(spec, h, w, _itemsize(dtype), batch, wf)
        return self._candidate(spec, algo, wf, h, w, batch, "cost_rule",
                               dtype=dtype)

    def _tune_cost_model(self, spec: ConvSpec, h: int, w: int, batch: int,
                         dtype: str = "float32") -> ConvPlan:
        """The cheapest candidate under the card's cost model
        (``codesign.cheapest_conv``), in ``dtype`` (the fp32 or the 16-bit
        kernels)."""
        from repro_torch.core.codesign import cheapest_conv

        t, algo, wf = cheapest_conv(spec, h, w, self.hw,
                                    2 if dtype in HALF_DTYPES else 4, batch,
                                    self.winograd_fused)
        return self._candidate(spec, algo, wf, h, w, batch, "cost_model",
                               dtype=dtype, predicted_s=t)

    def _tune_int8(self, spec: ConvSpec, h: int, w: int,
                   batch: int) -> ConvPlan:
        """The int8 gates of cost and measure mode, the reference's: past
        the traffic gate, the int8 candidate is kept only where the rule
        (core/cost_rule.py) prices it below the fp32 plan.  As in the
        reference, Winograd is an int8 candidate only when
        ``quant.winograd_int8_budget_ok()`` holds; F(6,3) misses that
        transform-stage error budget, so an int8 3x3 layer runs the
        implicit-GEMM conv (the dispatcher has no int8 Winograd kernel and
        refuses such a plan)."""
        from repro_torch.core.cost_rule import rule_time
        from repro_torch.core.quant import int8_worthwhile

        fp32_plan = self._tune_cost(spec, h, w, batch)
        if not int8_worthwhile(spec, h, w, batch):
            return fp32_plan
        algo = self._int8_algorithm(spec, fp32_plan)
        wf = fp32_plan.winograd_fused and algo is ConvAlgorithm.WINOGRAD
        if (rule_time(spec, h, w, algo, 1, batch, wf)
                >= rule_time(spec, h, w, fp32_plan.algorithm, 4, batch,
                             fp32_plan.winograd_fused)):
            return fp32_plan
        return self._candidate(spec, algo, wf, h, w, batch, "cost_rule",
                               dtype="int8")

    def _tune_int8_model(self, spec: ConvSpec, h: int, w: int,
                         batch: int) -> ConvPlan:
        """The reference's int8 gate in model mode: past the traffic gate,
        the int8 candidate is kept only where its modeled time, entry
        quantization included, is below the fp32 plan's."""
        from repro_torch.core.codesign import predict_conv_time
        from repro_torch.core.quant import int8_worthwhile

        fp32_plan = self._tune_cost_model(spec, h, w, batch)
        if not int8_worthwhile(spec, h, w, batch):
            return fp32_plan
        algo = self._int8_algorithm(spec, fp32_plan)
        t = predict_conv_time(spec, h, w, algo, self.hw, 1, batch)
        if t >= fp32_plan.predicted_s:
            return fp32_plan
        return self._candidate(spec, algo, False, h, w, batch, "cost_model",
                               dtype="int8", predicted_s=t)

    @staticmethod
    def _int8_algorithm(spec: ConvSpec, fp32_plan: ConvPlan) -> ConvAlgorithm:
        from repro_torch.core.quant import winograd_int8_budget_ok

        if spec.kernel_size == (1, 1) and spec.stride == (1, 1):
            return ConvAlgorithm.DIRECT
        if (fp32_plan.algorithm is ConvAlgorithm.WINOGRAD
                and winograd_int8_budget_ok()):
            return ConvAlgorithm.WINOGRAD
        return ConvAlgorithm.IM2COL_GEMM

    def _tune_measured(self, spec: ConvSpec, h: int, w: int, batch: int,
                       dtype: str = "float32") -> ConvPlan:
        """Time every eligible candidate in ``dtype`` on seeded inputs; keep
        the fastest."""
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

        operands = candidate_operands(spec, h, w, batch, self.device)
        timed = []
        for algo, wf in candidates:
            plan = self._candidate(spec, algo, wf, h, w, batch, "measured",
                                   dtype=dtype)
            ms = self._time_ms(candidate_call(spec, plan, operands))
            timed.append((plan, ms))
        best, best_ms = min(timed, key=lambda pm: pm[1])
        return dataclasses.replace(
            best, measured_ms=tuple((p.label, ms) for p, ms in timed),
            predicted_s=best_ms * 1e-3)

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
                             spec.in_channels, dtype)
    if algo is ConvAlgorithm.WINOGRAD:
        from repro_torch.kernels.winograd.ops import pick_blocks

        return pick_blocks(winograd_tiles(spec, h, w, batch),
                           spec.in_channels, spec.out_channels,
                           fused=winograd_fused, dtype=dtype)
    from repro_torch.kernels.im2col_gemm.ops import pick_blocks

    return pick_blocks(oh, ow, dtype)


def plan_is_current(plan: ConvPlan, spec: ConvSpec, h: int, w: int,
                    batch: int) -> bool:
    """Whether ``plan`` comes from a rule the planner still runs (not one
    of ``RETIRED_SOURCES``) and still names the tile its kernel is
    compiled with (``kernel_blocks``): a plan cached or saved before its
    rule or its kernel's tile changed is stale, and replans.  The fp32 and int8 implicit-GEMM convs
    take any row tile (a network plan snaps it to the map), so only their
    channel step and out-channel block must be the kernel's; the 16-bit
    one's whole tile must."""
    if plan.source in RETIRED_SOURCES:
        return False
    want = kernel_blocks(spec, plan.algorithm, h, w, batch,
                         plan.winograd_fused, plan.dtype)
    if (plan.algorithm is ConvAlgorithm.IM2COL_GEMM
            and plan.dtype not in HALF_DTYPES):
        return tuple(plan.kernel_blocks[1:]) == want[1:]
    return tuple(plan.kernel_blocks) == want


def candidate_operands(spec: ConvSpec, h: int, w: int, batch: int,
                       device: Any) -> Tuple[torch.Tensor, ...]:
    """Seeded fp32 operands (input, weights, bias) of one conv's measured
    candidates, drawn once for all of them (numpy's ``default_rng(0)``)."""
    import numpy as np

    cin, cout = spec.in_channels, spec.out_channels
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    x = tensor(rng.normal(size=(batch, h, w, cin)))
    wts = tensor(rng.normal(size=(spec.kh, spec.kw, cin, cout)) * 0.05)
    return x, wts, tensor(rng.normal(size=(cout,)))


def candidate_call(spec: ConvSpec, plan: ConvPlan,
                   operands: Tuple[torch.Tensor, ...]):
    """A closure that runs ``plan`` for one conv as the forward runs it,
    on ``candidate_operands``: the input channels padded to the kernel's
    multiple offline, Winograd weights pre-transformed, the bias +
    activation epilogue every planned conv replays; an int8 plan
    quantizes its fp32 input at entry (the four launches of
    ``quant.quantize_activation``) and dequantizes in the kernel; a 16-bit
    plan runs on its type's input and weights (Winograd's split after the
    transform, ``winograd.split_transformed``) with the fp32 bias.  Measure mode times these calls."""
    import torch.nn.functional as F

    from repro_torch.core.conv2d import conv2d
    from repro_torch.core.conv_spec import Epilogue
    from repro_torch.core.netplan import Layout
    from repro_torch.core.quant import quantize_activation
    from repro_torch.core.winograd import transform_weights
    from repro_torch.kernels.conv_ops import in_channel_multiple
    from repro_torch.util import ceil_to

    x, wts, bias = operands
    cin, cout = spec.in_channels, spec.out_channels
    pad = ceil_to(cin, in_channel_multiple(plan.algorithm, plan.dtype)) - cin
    x, wts = F.pad(x, (0, pad)), F.pad(wts, (0, 0, 0, pad))
    layout = Layout(cin, pad)
    if plan.dtype == "int8":
        wq = torch.round(wts * (127 / float(wts.abs().max()))).to(torch.int8)
        x_scale = torch.full((cin + pad,), 0.05, device=x.device)
        epi = Epilogue(bias=bias, activation="relu",
                       scale=torch.full((cout,), 1e-4, device=x.device))

        def call():
            with torch.inference_mode():
                return conv2d(quantize_activation(x, x_scale), wq, spec,
                              plan=plan, epilogue=epi, in_layout=layout)
        return call

    pre = plan.algorithm is ConvAlgorithm.WINOGRAD
    if pre:
        wts = transform_weights(wts)
    if plan.dtype in HALF_DTYPES:
        from repro_torch.core.winograd import split_transformed

        from repro_torch.kernels.gemm.ops import tma_rows16

        dt = getattr(torch, plan.dtype)
        x = x.to(dt)
        wts = split_transformed(wts, dt) if pre else tma_rows16(wts.to(dt))
    epi = Epilogue(bias=bias, activation="relu")

    def call():
        with torch.inference_mode():
            return conv2d(x, wts, spec, plan=plan, epilogue=epi,
                          in_layout=layout, pretransformed=pre)
    return call

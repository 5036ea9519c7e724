"""Per-candidate conv times on the card, and the cost model's constants
fit to them.

On one NVIDIA GPU, from the repository root::

    PYTHONPATH=src python scripts/cost_model_fit.py

takes every distinct conv (spec, input size, batch) of YOLOv3-tiny 416
(batch 1 and 4), MODEL_20 608 and VGG-16 224 (batch 1), and every
candidate the dispatcher can run for it -- fp32: the direct GEMM, im2col,
the fused Winograd kernel and the 3-pass pipeline, as measure mode's
candidates; int8, on the layers that pass the traffic gate: the int8 GEMM
or the int8 im2col conv, with the entry quantization; bf16: the 16-bit
kernels of the fp32 candidates (fp16 runs the same kernels) -- and, for
each,

- times the call as measure mode does (``planner.candidate_call``: the
  forward's layouts and epilogue, ``util.device_ms`` over
  ``planner.MEASURE_REPS`` calls, the median of three such runs);
- profiles it (``torch.profiler``): the device time per call of each CUDA
  kernel it launches, the port's kernels by name and PyTorch's (padding,
  tiling, quantization) as ``glue`` (``glue_16`` around a 16-bit call, fit
  apart).

The records go to ``--out`` (JSON, ``build/cost_model_fit.json`` by
default).  ``--dtypes`` measures only the candidates of those dtypes, and
``--append FILE`` adds the new records to a saved records file of the
same card, each in place of a saved record of the same cell, layer and
candidate (the 16-bit ones were so added to
``scripts/cost_model_records_h100.json``, and replaced when their kernels
were redesigned), and fits them all.  Then ``fit`` sets the cost model's
constants (``core/smem_model.py``) from them and prints each with the
median and the worst predicted / measured ratio of its kernel; ``hw.py``
holds the constants of such a run.  ``--records FILE`` refits saved
records on any machine, without a card.

Last, ``holdout`` refits with each cell's records left out in turn and
holds the refit against the cell it did not see: per kernel, the median
and the worst predicted / measured ratio on the held-out calls (beside
the full fit's on the same calls), and per layer, the fp32 and the int8
pick of ``mode="model"`` under the refit beside the full fit's and the
measured fastest candidate, with the measured ms each set of picks adds
up to.  A conv that two cells share belongs to the first
(``distinct_convs``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: The cells whose convs are measured: (model, batch).
CELLS = (("yolov3-tiny", 416, 1), ("yolov3-tiny", 416, 4),
         ("yolov3-20", 608, 1), ("vgg16", 224, 1))
PROFILE_REPS = 10


def cell_model(name: str):
    from repro_torch.configs import vgg16, yolov3

    return {"yolov3-tiny": yolov3.TINY_MODEL, "yolov3-20": yolov3.MODEL_20,
            "vgg16": vgg16.MODEL}[name]


def distinct_convs():
    """[(cell, layer index, spec, h, w, batch)], each conv shape once (the
    first cell and layer that has it)."""
    from repro_torch.core.netplan import _propagate_shapes

    seen, out = set(), []
    for name, _, batch in CELLS:
        model = cell_model(name)
        infos = _propagate_shapes(tuple(model.layers), *model.input_hw,
                                  model.in_channels)
        for i, (layer, info) in enumerate(zip(model.layers, infos)):
            if layer.kind != "conv":
                continue
            key = (info["spec"], info["in"][0], info["in"][1], batch)
            if key in seen:
                continue
            seen.add(key)
            out.append((f"{name} {model.input_hw[0]} b{batch}", i, *key))
    return out


DTYPES = ("float32", "int8", "bfloat16")


def candidates(spec, h, w, batch, dtypes=DTYPES):
    """[(algorithm, winograd_fused, dtype)]: measure mode's fp32
    candidates, the int8 kernel the int8 gate would run where the layer
    passes the traffic gate, and the bf16 kernels of the fp32 candidates;
    those of ``dtypes``."""
    from repro_torch.core.conv_spec import ConvAlgorithm
    from repro_torch.core.planner import eligible_algorithms
    from repro_torch.core.quant import int8_worthwhile

    out = []
    for dtype in ("float32", "bfloat16"):
        if dtype not in dtypes:
            continue
        for algo in eligible_algorithms(spec):
            if algo is ConvAlgorithm.WINOGRAD:
                out += [(algo, True, dtype), (algo, False, dtype)]
            else:
                out.append((algo, False, dtype))
    if "int8" in dtypes and int8_worthwhile(spec, h, w, batch):
        direct = spec.kernel_size == (1, 1) and spec.stride == (1, 1)
        out.append((ConvAlgorithm.DIRECT if direct
                    else ConvAlgorithm.IM2COL_GEMM, False, "int8"))
    return out


def kernel_name(cuda_name: str) -> str:
    """The port kernel a CUDA function is (``*_splitk_reduce`` for the
    reduce kernels), or ``glue`` for PyTorch's own."""
    from repro_torch.core.smem_model import CUDA_FUNCTIONS

    for name, fn in sorted(CUDA_FUNCTIONS.items(), key=lambda kv: -len(kv[1])):
        if fn in cuda_name:
            return name
    return "glue"


def profile_call(fn):
    """{kernel: [device us per call, launches per call]} over
    ``PROFILE_REPS`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = kernel_name(ev.name)
        us, n = out.get(name, (0.0, 0.0))
        out[name] = (us + ev.time_range.elapsed_us() / PROFILE_REPS,
                     n + 1 / PROFILE_REPS)
    return {k: [round(us, 4), round(n, 2)] for k, (us, n) in out.items()}


def measure(dtypes=DTYPES):
    import torch

    from repro_torch.core.planner import (
        MEASURE_REPS,
        ConvPlan,
        candidate_call,
        candidate_operands,
        kernel_blocks,
    )
    from repro_torch.util import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    records = []
    for cell, index, spec, h, w, batch in distinct_convs():
        operands = candidate_operands(spec, h, w, batch, "cuda")
        for algo, wf, dtype in candidates(spec, h, w, batch, dtypes):
            plan = ConvPlan(algorithm=algo, impl="cuda",
                            kernel_blocks=kernel_blocks(spec, algo, h, w,
                                                        batch, wf, dtype),
                            source="measured", winograd_fused=wf, dtype=dtype)
            fn = candidate_call(spec, plan, operands)
            fn()
            ms = statistics.median(device_ms([fn] * MEASURE_REPS)
                                   for _ in range(3))
            kernels = profile_call(fn)
            if dtype == "bfloat16" and "glue" in kernels:
                kernels["glue_16"] = kernels.pop("glue")
            rec = {"cell": cell, "layer": index, "h": h, "w": w,
                   "batch": batch, "in_channels": spec.in_channels,
                   "out_channels": spec.out_channels,
                   "kernel_size": list(spec.kernel_size),
                   "stride": list(spec.stride), "padding": list(spec.padding),
                   "candidate": plan.label, "ms": ms,
                   "kernels": kernels}
            records.append(rec)
            print(f"{cell} L{index} {h}x{w} {spec.in_channels}->"
                  f"{spec.out_channels} k{spec.kh} s{spec.stride[0]} "
                  f"{plan.label}: {ms:.4f} ms "
                  + " ".join(f"{k} {us:.2f}us x{n}"
                             for k, (us, n) in rec["kernels"].items()),
                  flush=True)
    return records


def _ratios(rows, hw, kernel):
    fixed, share = hw.kernel_cost(kernel)
    return [(n * fixed + r / share) / t for r, n, t, _ in rows]


def _spread(ratios):
    worst = max(ratios, key=lambda q: abs(math.log(q)))
    return f"median {statistics.median(ratios):.3f} worst {worst:.3f}"


def holdout(records, log=print):
    """Leave each cell out of the fit in turn (module docstring); returns
    {cell: {"kernels": {kernel: (median, worst) held-out ratio},
    "picks": {dtype: {layer: (held-out fit's, full fit's, fastest)}},
    "ms": {dtype: (measured ms of those three sets of picks)}}}."""
    import dataclasses

    from repro_torch.core.codesign import spec_of
    from repro_torch.core.planner import Planner
    from repro_torch.core.smem_model import fit, kernel_samples
    from repro_torch.hw import H100

    quiet = lambda _: None  # noqa: E731
    out = {}
    for cell in dict.fromkeys(r["cell"] for r in records):
        seen = [r for r in records if r["cell"] == cell]
        got = fit([r for r in records if r["cell"] != cell], log=quiet)
        hw = dataclasses.replace(H100, kernel_fit=tuple(
            (k, *got.get(k, (f, s))) for k, f, s in H100.kernel_fit))
        kept = [k for k, _, _ in H100.kernel_fit if k not in got]
        log(f"holdout {cell}: refit without its {len(seen)} calls"
            + (f"; {', '.join(kept)} keep the full fit (no other cell "
               f"launches them)" if kept else ""))
        res = {"kernels": {}, "picks": {}, "ms": {}}
        for k, rows in kernel_samples(seen, log=quiet).items():
            if not rows or k in kept:
                continue
            held = _ratios(rows, hw, k)
            res["kernels"][k] = (statistics.median(held),
                                 max(held, key=lambda q: abs(math.log(q))))
            log(f"holdout {cell}: {k} over {len(rows)} calls: predicted / "
                f"measured {_spread(held)} (full fit "
                f"{_spread(_ratios(rows, H100, k))})")
        layers = {}
        for r in seen:
            layers.setdefault(r["layer"], {})[r["candidate"]] = r
        planners = [Planner(impl="torch", device="cpu", mode="model", hw=chip)
                    for chip in (hw, H100)]
        for dtype in ("float32", "int8", "bfloat16"):
            picks, totals = {}, [0.0, 0.0, 0.0]
            for i, cands in sorted(layers.items()):
                r = next(iter(cands.values()))
                # A layer's candidates in this dtype: the 16-bit ones in
                # bf16; fp32 ones in fp32; fp32 and int8 ones in int8.
                ms = {c: rec["ms"] for c, rec in cands.items()
                      if c.endswith("_16") == (dtype == "bfloat16")
                      and (dtype == "int8" or not c.endswith("_int8"))}
                if not ms:
                    continue
                picks[i] = tuple(
                    p.plan(spec_of(r), r["h"], r["w"], r["batch"],
                           dtype).label for p in planners
                ) + (min(ms, key=ms.get),)
                for j, pick in enumerate(picks[i]):
                    totals[j] += ms[pick]
            res["picks"][dtype], res["ms"][dtype] = picks, tuple(totals)
            changed = [f"L{i} {a} -> {b}" for i, (a, b, _) in picks.items()
                       if a != b]
            log(f"holdout {cell}: {dtype}: {len(changed)} of {len(picks)} "
                f"picks change" + (f" ({'; '.join(changed)})" if changed
                                   else "")
                + f"; measured ms of the picks: held-out fit {totals[0]:.4f},"
                f" full fit {totals[1]:.4f}, fastest {totals[2]:.4f}")
        out[cell] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "cost_model_fit.json"))
    ap.add_argument("--records", help="refit these saved records")
    ap.add_argument("--dtypes", default=",".join(DTYPES),
                    help="measure the candidates of these dtypes only")
    ap.add_argument("--append", help="add the measured records to this "
                    "saved records file (of the same card), in place of its "
                    "records of the same candidates, and fit them all")
    args = ap.parse_args()
    if args.records:
        with open(args.records) as f:
            records = json.load(f)["records"]
    else:
        import subprocess

        import torch

        if not torch.cuda.is_available():
            print("cost_model_fit: no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi, flush=True)
        t0 = time.perf_counter()
        records = measure(tuple(args.dtypes.split(",")))
        print(f"measured {len(records)} candidates in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if args.append:
            with open(args.append) as f:
                saved = json.load(f)
            if saved["device"] != smi:
                print(f"cost_model_fit: {args.append} is of "
                      f"{saved['device']!r}, this card is {smi!r}",
                      file=sys.stderr)
                return 1
            # A measured candidate replaces its saved record (a kernel
            # redesigned since), the rest are kept.
            fresh = {(r["cell"], r["layer"], r["candidate"]) for r in records}
            records = [r for r in saved["records"]
                       if (r["cell"], r["layer"], r["candidate"])
                       not in fresh] + records
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "records": records}, f, indent=1)
    from repro_torch.core.smem_model import fit

    fit(records, log=print)
    holdout(records, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())

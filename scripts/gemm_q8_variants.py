#!/usr/bin/env python3
"""Time the int8 GEMM (csrc/gemm_q8.cu, s8 mma.sync with split-K) against
variants of its own source, and against an earlier commit's kernel, on
one NVIDIA GPU.

Each variant is the kernel source with a few lines replaced (or the same
library called another way), built by nvcc with the port's flags into its
own directory under ``build/gemm_q8_variants/``:

    as built        the wrapper's tile (64 x 64, 128 x 32 for N <= 32) and
                    split rule;
    no split        the same library called with one split;
    64-wide tile    the 64 x 64 tile at every N (differs at N <= 32 only);
    2 stages, 4 stages
                    a cp.async ring of 2 or 4 stages instead of 3;
    stages of 2 chunks
                    64 bytes of K a stage instead of 128;
    3 blocks a SM   __launch_bounds__ asking for 3 (at most 85 registers a
                    thread), split over 3 resident blocks;
    unrolled loops  the prologue's stage loop and A's copy loop unrolled
                    (more registers a thread: 2 blocks a SM, not 3);
    no turn, no products, no stores, no reduce
                    diagnostics: one piece of the work left out (B's turn
                    into K rows; the mma.sync; the epilogue's stores; the
                    split-K reduce launch), wrong results (timed, not
                    gated): what each piece costs;
    parent          with ``--parent DIR`` (the root of a checkout of an
                    earlier commit, e.g. ``git archive`` of the parent
                    unpacked into a git-ignored directory; may be given
                    more than once, each then named by its directory):
                    that tree's gemm_q8.cu (and s8_mma.cuh) through its
                    own C entry, the dp4a one (no workspace, tile or
                    split arguments) or this one, told apart by its
                    signature.

Every int8 GEMM call of the int8 plans of YOLOv3-tiny 416 b1 and MODEL_20
608 b1 (the shapes ``chip_smoke.py`` times), on seeded operands with bias
and the leaky activation: each variant but the diagnostics held against
the plain version bit for bit and timed in turns (A B C ... C B A), each call on its own cold
copy of its operands.  Prints the card's name and power limit first,
ptxas' registers and spills of each build, then per call and per cell the
ms of each variant in both turns.

    PYTHONPATH=src python scripts/gemm_q8_variants.py [--parent DIR]
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import yolov3
from repro_torch.core.conv_spec import ACTIVATION_CODES, ConvAlgorithm
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_k
from repro_torch.kernels.gemm.ops import (
    _ARGTYPES_Q8,
    CHUNK_Q8,
    TILES_Q8,
    call_splits_q8,
    tile_q8,
)
from repro_torch.kernels.gemm.ref import matmul_q8_ref
from repro_torch.util import device_ms

KERNELS = Path(_build.__file__).parent
REL = Path("gemm/csrc/gemm_q8.cu")
HEADER = Path(_build.SHARED_INCLUDE) / "s8_mma.cuh"
OUT = _build.BUILD_DIR.parent / "gemm_q8_variants"
# The earlier dp4a kernel's C entry: no workspace, tile or split count.
PARENT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: variant -> source edits; variants sharing a library name it instead.
BLOCKS_3 = [("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 3;")]
TWO_STAGES = [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]
UNROLLED = [("#pragma unroll 1\n  for (int s = 0; s < STAGES - 1; ++s) {",
             "#pragma unroll\n  for (int s = 0; s < STAGES - 1; ++s) {"),
            ("#pragma unroll 1\n"
             "    for (int idx = tid; idx < BM * (KS / 16); idx += THREADS) {",
             "    for (int idx = tid; idx < BM * (KS / 16); idx += THREADS) {")]
VARIANTS = {
    "as built": [],
    "2 stages": TWO_STAGES,
    "4 stages": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "stages of 2 chunks": [("constexpr int SK = 4;", "constexpr int SK = 2;")],
    "3 blocks a SM": BLOCKS_3,
    "unrolled loops": UNROLLED,
    "no turn": [("    turn(st, kb);\n", "")],
    "no products": [("        mma_s8(acc[ni], a, bw[ni / 2][2 * (ni % 2)],\n"
                     "               bw[ni / 2][2 * (ni % 2) + 1]);\n",
                     "        acc[ni][0] += bw[ni / 2][0];\n")],
    "no stores": [("  const bool has_bias = bias != nullptr;\n",
                   "  if (act != 99) return;\n"
                   "  const bool has_bias = bias != nullptr;\n")],
    "no reduce": [("  if (err != cudaSuccess || splits == 1) return",
                   "  if (err != cudaSuccess || splits >= 1) return")],
}
#: Variants that drop work: timed, not gated (their results are wrong).
DIAGNOSTIC = {"no turn", "no products", "no stores", "no reduce"}
SAME_LIBRARY = {"no split": "as built", "64-wide tile": "as built"}
RESIDENT = {"no split": None, "3 blocks a SM": 3}


def build(parents: list):
    """(variant -> C entry, the variants on the dp4a kernel's C entry), all
    nvcc processes at once."""
    jobs = {}
    for name, edits in VARIANTS.items():
        text = (KERNELS / REL).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name!r}: {old!r} not found once")
            text = text.replace(old, new)
        jobs[name] = (text, KERNELS)
    for parent in parents:
        base = parent / "src" / "repro_torch" / "kernels"
        jobs[parent_name(parent, parents)] = ((base / REL).read_text(), base)
    dp4a = {name for name, (text, _) in jobs.items()
            if "int* ws" not in text[text.index('extern "C"'):]}
    procs = {}
    for i, (name, (text, base)) in enumerate(jobs.items()):
        d = OUT / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        if (base / HEADER).exists():
            shutil.copy(base / HEADER, d)
        src = d / REL.name
        src.write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(src)], cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
        fn = getattr(ctypes.CDLL(str(path)), "repro_gemm_q8_bias_act")
        fn.argtypes = PARENT_ARGTYPES if name in dp4a else _ARGTYPES_Q8
        fn.restype = ctypes.c_int
        fns[name] = fn
    for name, lib in SAME_LIBRARY.items():
        fns[name] = fns[lib]
    return fns, dp4a


def parent_name(parent: Path, parents: list) -> str:
    return "parent" if len(parents) == 1 else f"parent {parent.name}"


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def runner(fn, name, dp4a, m, n, k):
    """A closure calling int8 GEMM entry ``fn`` as variant ``name`` on
    (a, b, scale, bias), with the leaky activation; ``dp4a``: through the
    dp4a kernel's C entry."""
    act = ACTIVATION_CODES["leaky"]
    if dp4a:
        def run(a, b, scale, bias):
            out = torch.empty((m, n), device="cuda")
            _build.check(fn(a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), m, n, k, act,
                            stream()), name)
            return out
        return run
    bm, bn = TILES_Q8[0] if name == "64-wide tile" else tile_q8(n)
    # A parent tree on this kernel's C entry takes the same tile and split.
    resident = RESIDENT.get(name, 2)
    splits = (1 if resident is None else
              split_k(-(-m // bm) * -(-n // bn), -(-k // CHUNK_Q8), resident))

    def run(a, b, scale, bias):
        out = torch.empty((m, n), device="cuda")
        ws = (torch.empty((splits, m, n), device="cuda", dtype=torch.int32)
              if splits > 1 else None)
        _build.check(fn(a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), out.data_ptr(),
                        ws.data_ptr() if ws is not None else None, m, n, k,
                        act, bn, splits, stream()), name)
        return out
    run.splits = splits
    return run


def cold_ms(fn, args) -> float:
    """Device ms per call, each call on its own copy of ``args`` (the
    copies together exceed twice the L2), median of 3 rounds."""
    size = sum(a.numel() * a.element_size() for a in args)
    copies = [tuple(a.clone() for a in args)
              for _ in range(max(4, 2 * H100.l2_bytes // size + 1))]
    fn(*copies[0])
    calls = [lambda c=c: fn(*c) for c in copies]
    return statistics.median(device_ms(calls) for _ in range(3))


def cases(rng):
    """(cell, label, (m, n, k), operands) of every int8 GEMM call."""
    out = []
    for cell, model in (("yolov3-tiny 416 b1 int8", yolov3.TINY_MODEL),
                        ("yolov3-20 608 b1 int8", yolov3.MODEL_20)):
        netplan = plan_network(model.layers, *model.input_hw, Planner(),
                               in_channels=model.in_channels, batch=1,
                               dtype="int8")
        for s in netplan.steps:
            if not (s.layer.kind == "conv" and s.plan.dtype == "int8"
                    and s.plan.algorithm is ConvAlgorithm.DIRECT):
                continue
            m = s.out_hw[0] * s.out_hw[1]
            k, n = s.in_layout.phys_c, s.out_layout.phys_c
            operands = (
                torch.tensor(rng.integers(-127, 128, (m, k)).astype(np.int8),
                             device="cuda"),
                torch.tensor(rng.integers(-127, 128, (k, n)).astype(np.int8),
                             device="cuda"),
                torch.tensor(rng.uniform(0.5, 2.0, n).astype(np.float32)
                             * 1e-3, device="cuda"),
                torch.tensor(rng.standard_normal(n).astype(np.float32),
                             device="cuda"))
            label = (f"L{s.index} M={m} K={k} N={n} tile={tile_q8(n)}"
                     f" splits={call_splits_q8(m, n, k)}")
            out.append((cell, label, (m, n, k), operands))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of a checkout of an earlier commit "
                         "(repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns, dp4a = build(args.parent)
    names = (["as built", "no split", "64-wide tile"]
             + [v for v in VARIANTS if v != "as built"]
             + [parent_name(p, args.parent) for p in args.parent])
    totals = collections.defaultdict(lambda: [0.0, 0.0])
    for cell, label, (m, n, k), operands in cases(np.random.default_rng(0)):
        ref = matmul_q8_ref(*operands, "leaky")
        runs = {v: runner(fns[v], v, v in dp4a, m, n, k) for v in names}
        times = {v: [] for v in names}
        for v in [*names, *reversed(names)]:
            got = runs[v](*operands)
            torch.cuda.synchronize()
            if v not in DIAGNOSTIC and not torch.equal(got, ref):
                raise AssertionError(f"{cell} {label} {v}: differs from the "
                                     f"plain version by "
                                     f"{float((got - ref).abs().max())}")
            times[v].append(cold_ms(runs[v], operands))
        for v, ms in times.items():
            totals[cell, v][0] += ms[0]
            totals[cell, v][1] += ms[1]
            split = getattr(runs[v], "splits", 1)
            print(f"{cell} {label} {v} (splits {split}): ms {ms[0]:.4f} "
                  f"{ms[1]:.4f} (in turns)")
    for (cell, v), (t0, t1) in totals.items():
        print(f"total {cell} {v}: ms {t0:.4f} {t1:.4f} (in turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

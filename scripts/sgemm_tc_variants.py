#!/usr/bin/env python3
"""Time the fp32 tensor-core GEMM core against variants of its own source,
on one NVIDIA GPU, through both kernels that use it: the 1x1-conv GEMM
(gemm.cu, with its split-K) and the 3-pass tuple multiply
(winograd_3pass.cu).

Each variant is the shared header ``kernels/csrc/sgemm_3xtf32.cuh`` with a
few lines replaced, built by nvcc with the port's flags, beside copies of
the two sources, into its own directory under ``build/sgemm_tc_variants/``:

  as built       hi and lo rounded as cvt.rna.tf32.f32 rounds, in integer
                 instructions (add half a TF32 ulp to the bits, clear the
                 13 low bits); 4 blocks a SM; a 3-stage ring;
  cvt.rna        the cvt.rna.tf32.f32 instruction itself;
  5 blocks a SM  __launch_bounds__ asking for 5 resident blocks (at most
                 102 registers a thread); the splits stay the wrapper's;
  4 stages       a 4-stage ring (38,912 bytes of shared memory);
  hi.hi only     the two correction products left out: plain TF32, which
                 fails the gate (its error is printed, not gated); what
                 is left of the time without two thirds of the mma.sync;
  no split       the GEMM as built with one split, whatever the wrapper's
                 rule gives (the tuple multiply never splits).

At the shapes of YOLOv3-tiny 416 b1's and MODEL_20 608 b1's GEMM calls
and VGG-16 224 b1's 3-pass tuple multiplies, every variant is held
against the plain product (1e-4 of max(1, max|ref|), TF32 off in
PyTorch) and timed in turns (A B C C B A), each call on its own cold
copy of its operands.  Prints the card's name and power limit first, and
the SASS instruction mix of each variant's inner loop (``cuobjdump``).

    PYTHONPATH=src python scripts/sgemm_tc_variants.py
"""
from __future__ import annotations

import collections
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels.gemm.ops import _ARGTYPES as GEMM_ARGTYPES
from repro_torch.kernels.gemm.ops import call_splits
from repro_torch.kernels.winograd.ops import _TUPLE_ARGTYPES
from repro_torch.util import device_ms

KERNELS = Path(_build.__file__).parent
HEADER = KERNELS / "csrc" / "sgemm_3xtf32.cuh"
SOURCES = {"gemm": KERNELS / "gemm" / "csrc" / "gemm.cu",
           "winograd_3pass": KERNELS / "winograd" / "csrc" / "winograd_3pass.cu"}
OUT = _build.BUILD_DIR.parent / "sgemm_tc_variants"
INT_RNA = """  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));"""
CVT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));"""
VARIANTS = {
    "as built": [],
    "cvt.rna": [(INT_RNA, CVT)],
    "5 blocks a SM": [("constexpr int MIN_BLOCKS = 4;",
                       "constexpr int MIN_BLOCKS = 5;")],
    "4 stages": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "hi.hi only": [
        ("for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);",
         "for (int ni = 0; ni < 4; ++ni) {}"),
        ("for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);",
         "for (int ni = 0; ni < 4; ++ni) {}")],
}
#: Variants that drop arithmetic to show what it costs: timed, and their
#: error printed, not gated.
DIAGNOSTIC = {"hi.hi only"}
#: The as-built library, the GEMM called with one split.
NO_SPLIT = "no split"
# (M, K, N) of the GEMM calls; (T, C, O) of the tuple multiplies.
GEMM_CASES = {
    "yolov3-tiny 416 b1 L13": (169, 1024, 256),
    "yolov3-tiny 416 b1 L15": (169, 512, 255),
    "yolov3-tiny 416 b1 L17": (169, 256, 128),
    "yolov3-tiny 416 b1 L21": (676, 256, 255),
    "yolov3-20 608 b1 L2": (92416, 64, 32),
    "yolov3-20 608 b1 L6": (23104, 128, 64),
    "yolov3-20 608 b1 L13": (5776, 256, 128),
}
TUPLE_CASES = {
    "vgg16 224 b1 L0": (1444, 8, 64),
    "vgg16 224 b1 L1": (1444, 64, 64),
    "vgg16 224 b1 L4": (361, 128, 128),
    "vgg16 224 b1 L7": (100, 256, 256),
}


def build() -> dict:
    """name -> (gemm entry, tuple multiply entry, SASS mix), all nvcc
    processes at once."""
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        header = HEADER.read_text()
        for old, new in edits:
            if header.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once")
            header = header.replace(old, new)
        d = OUT / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        (d / HEADER.name).write_text(header)
        shutil.copy(KERNELS / "winograd" / "csrc" / "winograd_transforms.cuh", d)
        for lib, src in SOURCES.items():
            shutil.copy(src, d)
            procs[name, lib] = (d / f"{lib}.so", subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
                 str(d / src.name)], cwd=d,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = collections.defaultdict(dict)
    for (name, lib), (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r} {lib}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {lib}: {line.strip()}")
        libs[name][lib] = path
    out = {}
    for name, paths in libs.items():
        gemm = ctypes.CDLL(str(paths["gemm"])).repro_gemm_bias_act
        gemm.argtypes, gemm.restype = GEMM_ARGTYPES, ctypes.c_int
        tm = ctypes.CDLL(str(paths["winograd_3pass"])).repro_winograd_tuple_multiply
        tm.argtypes, tm.restype = _TUPLE_ARGTYPES, ctypes.c_int
        out[name] = (gemm, tm, sass_mix(paths["gemm"]))
    return out


def sass_mix(lib: Path) -> str:
    """Counts of the main instruction kinds of the GEMM kernel's SASS."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    try:
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"(cuobjdump failed: {e})"
    sass = next((part for part in sass.split("Function : ")
                 if part.split("\n", 1)[0].find("gemm_bias_act_kernel") >= 0), "")
    ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass))
    keep = ("HMMA", "LDS", "LDGSTS", "F2F", "FRND", "FADD", "LOP3", "IADD3",
            "BAR", "I2F", "F2I")
    return " ".join(f"{k}={ops[k]}" for k in keep if ops[k])


def gemm_call(fn, a, b, bias, split=True):
    m, k = a.shape
    n = b.shape[1]
    splits = call_splits(m, n, k) if split else 1
    out = torch.empty((m, n), device="cuda")
    ws = torch.empty((splits, m, n), device="cuda") if splits > 1 else None
    err = fn(a.data_ptr(), b.data_ptr(), bias.data_ptr(), out.data_ptr(),
             ws.data_ptr() if ws is not None else None, m, n, k, 2, splits,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gemm variant")
    return out


def tuple_call(fn, v, u):
    _, t, c = v.shape
    o = u.shape[-1]
    out = torch.empty((64, t, o), device="cuda")
    err = fn(v.data_ptr(), u.data_ptr(), out.data_ptr(), t, c, o,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tuple multiply variant")
    return out


def cold_ms(fn, args) -> float:
    """Device ms per call, each call on its own copy of ``args`` (the
    copies together exceed twice the L2), median of 3 rounds."""
    size = sum(a.numel() * a.element_size() for a in args)
    copies = [tuple(a.clone() for a in args)
              for _ in range(max(4, 2 * H100.l2_bytes // size + 1))]
    fn(*copies[0])
    calls = [lambda c=c: fn(*c) for c in copies]
    return statistics.median(device_ms(calls) for _ in range(3))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build()
    for name, (_, _, mix) in fns.items():
        print(f"sass {name}: gemm_bias_act_kernel {mix}")
    fns[NO_SPLIT] = fns["as built"]
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for case, (m, k, n) in GEMM_CASES.items():
        a, b = (torch.randn(s, generator=g, device="cuda") for s in ((m, k), (k, n)))
        bias = torch.randn(n, generator=g, device="cuda")
        ref = torch.nn.functional.leaky_relu(a @ b + bias, 0.1)
        cases.append((f"gemm {case} M={m} K={k} N={n} splits={call_splits(m, n, k)}",
                      0, (a, b, bias), ref))
    for case, (t, c, o) in TUPLE_CASES.items():
        v, u = (torch.randn(s, generator=g, device="cuda")
                for s in ((64, t, c), (64, c, o)))
        cases.append((f"tuple_multiply {case} T={t} C={c} O={o}", 1, (v, u),
                      torch.bmm(v, u)))
    totals = collections.defaultdict(lambda: [0.0, 0.0])
    for label, which, args, ref in cases:
        times, rel = {name: [] for name in fns}, {}
        for name in [*fns, *reversed(fns)]:
            fn = fns[name][which]
            run = ((lambda a, b, bias, fn=fn, split=name != NO_SPLIT:
                    gemm_call(fn, a, b, bias, split))
                   if which == 0 else (lambda v, u, fn=fn: tuple_call(fn, v, u)))
            got = run(*args)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel[name] = err / max(1.0, float(ref.abs().max()))
            if name not in DIAGNOSTIC and not rel[name] <= 1e-4:
                raise AssertionError(f"{label} {name}: max_abs_err {err}")
            times[name].append(cold_ms(run, args))
        for name, ms in times.items():
            kind = label.split()[0]
            totals[kind, name][0] += ms[0]
            totals[kind, name][1] += ms[1]
            print(f"{label} {name}: ms {ms[0]:.4f} {ms[1]:.4f} (in turns), "
                  f"error / max(1, max|ref|) {rel[name]:.2e}")
    for (kind, name), (t0, t1) in totals.items():
        print(f"total {kind} {name}: ms {t0:.4f} {t1:.4f} (in turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

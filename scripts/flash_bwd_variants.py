#!/usr/bin/env python3
"""Time the flash-attention backward kernel (kernels/flash_attention/csrc/
flash_attention_bwd.cu) as built against variants of its bf16 or fp32
body and, with ``--parent DIR``, an earlier commit's, on one NVIDIA GPU.

Each variant is a copy of ``kernels/flash_attention/csrc`` with a few
lines of ``flash_attention_bwd_bf16.cuh`` (``--variants``) or of
``flash_attention_bwd_fp32.cuh`` (``--variants --dtype fp32``) replaced.
bf16:

  as built          4 warps a block in both kernels; dk/dv blocks of 64
                    keys (32 at hd 256) looping over query tiles of 64
                    rows (32 above hd 80), K and V fragments in registers
                    up to hd 64, two blocks an SM; dq blocks of 64 rows
                    looping over key tiles of 64 (32 above hd 64), three
                    blocks an SM up to hd 64, two above;
  dk/dv 32 rows     dk/dv query tiles of 32 rows at every head dim (half
                    the s and dp registers);
  dk/dv 3 an SM     __launch_bounds__ asking for three dk/dv blocks an SM;
  dk/dv 32 rows, 3 an SM  both;
  dq 2 an SM        two dq blocks an SM at every head dim;
  dq 3 an SM        three dq blocks an SM at every head dim;
  dq 32 keys        dq key tiles of 32 at every head dim;
fp32:
  as built          the same blocks and warps as bf16's; dk/dv query
                    tiles of 64 rows up to hd 64, 32 at hd 80 and 256, 16
                    at hd 128; dq key tiles of 32 up to hd 80, 16 above;
                    dv, dk and dq summed a tile at a time into a zeroed
                    fragment, s and dp 4 k8 steps (2 at hd 16 and 80) at a
                    time, each partial then added in fp32;
  one accumulator   every product summed by the tensor cores straight into
                    its accumulator (mma.sync truncates each sum, so the
                    error grows with the length of the sum; gated the
                    same);
  16-row partials   dv, dk and dq partials of 2 k8 steps (16 rows or keys);
  dk/dv 32 rows     dk/dv query tiles of 32 rows up to hd 64;
  dq 64 keys, 2 an SM  dq key tiles of 64 up to hd 64, two blocks an SM;
both:
  parent            with ``--parent DIR`` (the root of a checkout of an
                    earlier commit, e.g. ``git archive`` of the parent
                    unpacked into a git-ignored directory): that tree's
                    flash_attention_bwd.cu and its headers as they are;
                    its entry is called with this tree's arguments, and
                    an entry without the head split ignores the two last
                    (in fp32 it is given split 1, the parent's only one);
  as built split N  with ``--splits N ...``: the as-built body called
                    with head split N where N divides the query heads of
                    a KV head (else with the rule's split).

Each is built by nvcc with the port's flags into its own library under
``build/flash_bwd_variants/`` (from the kernels directory, so ``-I csrc``
finds the shared headers), all at once, and ptxas' registers and spills of
each backward kernel are printed.

At each shape that ``chip_smoke.py``'s phase 8f times (the trained
configs' attention: Llama-3.2-1B's microbatch, Gemma2-27B's local and
global layers with the softcap, recurrentgemma-9b's MQA at hd 256,
hubert-xlarge, internvl2-2b), in ``--dtype`` (bf16 by default): the
forward kernel's output and lse, then each
build's dq, dk and dv held against the plain version (``attention_bwd_ref``
on the same out and lse; in fp32 its steps in float64, as chip_smoke.py's
phase 8f) at chip_smoke.py's gates (``FLASH_BWD_TOL``,
``FLASH_BWD_ROW_RTOL``), two calls of the as-built one compared bit for
bit, and the builds timed in turns (A B C ... C B A), each call on its
own cold copy of its operands (the copies together exceed twice the L2).
Prints the card's name and power limit first, the head split of each
shape, ms per call of each build and, with ``--profile``, the as-built
call's device time by kernel (``torch.profiler``: the row dot, dk/dv,
the split's reduce, dq).

    PYTHONPATH=src python scripts/flash_bwd_variants.py [--parent DIR] \
        [--variants] [--profile] [--dtype fp32] [--splits N ...]
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
from repro_torch.util import device_ms

REPO = Path(__file__).resolve().parents[1]
SOURCE = _build._KERNELS_DIR / _build.SOURCES["flash_attention_bwd"]
OUT = _build.BUILD_DIR.parent / "flash_bwd_variants"
BF16 = "flash_attention_bwd_bf16.cuh"
FP32 = "flash_attention_bwd_fp32.cuh"
DKDV_BOUNDS = ("__launch_bounds__(Cfg<HD>::THREADS, 2)\n"
               "flash_bwd_dkdv_kernel(")
DQ_BLOCKS = "int DQ_BLOCKS = HD <= 64 ? 3 : 2;"
ROWS = ("int BQ_T = HD <= 80 ? 64 : 32;", "int BQ_T = HD <= 80 ? 32 : 32;")
VARIANTS = {
    "as built": [],
    "dk/dv 32 rows": [(BF16, *ROWS)],
    "dk/dv 3 an SM": [(BF16, DKDV_BOUNDS, DKDV_BOUNDS.replace(", 2)", ", 3)"))],
    "dk/dv 32 rows, 3 an SM": [
        (BF16, *ROWS),
        (BF16, DKDV_BOUNDS, DKDV_BOUNDS.replace(", 2)", ", 3)"))],
    "dq 2 an SM": [(BF16, DQ_BLOCKS, DQ_BLOCKS.replace("? 3 : 2", "? 2 : 2"))],
    "dq 3 an SM": [(BF16, DQ_BLOCKS, DQ_BLOCKS.replace("? 3 : 2", "? 3 : 3"))],
    "dq 32 keys": [(BF16, "int BK_T = HD <= 64 ? 64 : 32;",
                    "int BK_T = HD <= 64 ? 32 : 32;")],
}
FP32_VARIANTS = {
    "as built": [],
    "one accumulator": [
        (FP32, "mma_3xtf32(part, ah[j], al[j], bh, bl);",
         "mma_3xtf32(acc[d], ah[j], al[j], bh, bl);"),
        (FP32, "for (int e = 0; e < 4; ++e) acc[d][e] += part[e];",
         "for (int e = 0; e < 4; ++e) (void)part[e];"),
        (FP32, "int JD_DKDV = HD % 32 == 0 ? 4 : 2;", "int JD_DKDV = KS;"),
        (FP32, "int JD_DQ = 1;", "int JD_DQ = KS;"),
    ],
    "dq s/dp 4 k8 steps": [
        (FP32, "int JD_DQ = 1;", "int JD_DQ = HD % 32 == 0 ? 4 : 2;"),
    ],
    "dk/dv s/dp one accumulator": [
        (FP32, "int JD_DKDV = HD % 32 == 0 ? 4 : 2;", "int JD_DKDV = KS;"),
    ],
    "16-row partials": [
        (FP32, "int JQ = BQ_T / 8;", "int JQ = 2;"),
        (FP32, "int JK = BK_T / 8;", "int JK = 2;"),
    ],
    "dk/dv 32 rows": [
        (FP32, "int BQ_T = HD <= 64 ? 64 :", "int BQ_T = HD <= 64 ? 32 :"),
    ],
    "dq 64 keys, 2 an SM": [
        (FP32, "int BK_T = HD <= 80 ? 32 : 16;",
         "int BK_T = HD <= 64 ? 64 : HD <= 80 ? 32 : 16;"),
        (FP32, "int DQ_BLOCKS = HD <= 64 ? 3 :", "int DQ_BLOCKS = HD <= 64 ? 2 :"),
    ],
}
# chip_smoke.py's FLASH_BWD_TOL and FLASH_BWD_ROW_RTOL, row floor 1e-2.
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-4, 1e-4)}
CASES = {
    # (B, S, Sk, H, KV, hd, causal, window, cap)
    "llama3.2-1b microbatch": (2, 4096, 4096, 32, 8, 64, True, 0, 0.0),
    "gemma2-27b local S8192": (1, 8192, 8192, 32, 16, 128, True, 4096, 50.0),
    "gemma2-27b attn S4096": (1, 4096, 4096, 32, 16, 128, True, 0, 50.0),
    "recurrentgemma-9b local S4096": (1, 4096, 4096, 16, 1, 256, True, 2048,
                                      0.0),
    "hubert-xlarge S1000": (1, 1000, 1000, 16, 16, 80, False, 0, 0.0),
    "internvl2-2b S1024": (1, 1024, 1024, 16, 8, 128, True, 0, 0.0),
}


def build(variants: dict, parent: Path | None, body: str) -> dict:
    """name -> the C entry of each build: ``variants`` maps a name to its
    edits, (file in csrc, old text, new text), each old text found once;
    ``parent`` adds "parent", that tree's sources as they are.  Prints
    ptxas' registers and spills of the ``body`` ("bf16" or "fp32")
    kernels of each build but the parent."""
    jobs = {name: (SOURCE, edits) for name, edits in variants.items()}
    if parent is not None:
        jobs["parent"] = (parent / SOURCE.relative_to(REPO), [])
    procs = {}
    for i, (name, (src, edits)) in enumerate(jobs.items()):
        d = OUT / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src.parent, d)
        for file, old, new in edits:
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once "
                                   f"in {file}")
            (d / file).write_text(text.replace(old, new))
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / src.name)], cwd=_build._KERNELS_DIR,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif (name != "parent" and f"flash_bwd_{body}" in entry
                  and ("registers" in line or "spill" in line)):
                print(f"  ptxas {name} {entry}: {line.strip()}")
        fn = ctypes.CDLL(str(lib)).repro_flash_attention_bwd
        fn.argtypes, fn.restype = ops._BWD_ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def head_split(q, k, name: str = "as built") -> int:
    """ops.flash_attention_bwd's head split for the build ``name``: 1 for
    the parent in fp32, N for "as built split N" where N divides the
    query heads of a KV head (else the rule's)."""
    b, _, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if name == "parent" and q.dtype == torch.float32:
        return 1
    if name.startswith("as built split "):
        split = int(name.split()[-1])
        if (h // kv) % split == 0:
            return split
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return ops.bwd_head_split(b, kv, sk, h // kv, hd, sms)


def call(fn, q, k, v, o, do, lse, causal, window, cap, name="as built"):
    """One call of a build's entry, as ops.flash_attention_bwd makes it,
    with ``head_split``'s split for the build ``name``."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    split = head_split(q, k, name)
    ws = (torch.empty(ops.bwd_workspace_shape(split, b, sk, kv, hd),
                      dtype=torch.float32, device=q.device)
          if split > 1 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowdot = torch.empty_like(lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), rowdot.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, s, sk, h, kv, hd,
             ops.DTYPES[q.dtype], int(causal), window, cap,
             torch.cuda.current_stream().cuda_stream, split,
             None if ws is None else ws.data_ptr())
    _build.check(err, "flash_attention_bwd variant")
    return dq, dk, dv


def errors(got, ref):
    """(max |got - ref| over max(1, max|ref|), the largest per-row error
    over the row's norm floored at 1e-2 of the largest row's)."""
    got, ref = got.float(), ref.float()
    elem = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    norm = ref.norm(dim=-1)
    row = float(((got - ref).norm(dim=-1)
                 / norm.clamp_min(1e-2 * float(norm.max()))).max())
    return elem, row


def cold_ms(fn, args) -> float:
    size = sum(a.numel() * a.element_size() for a in args)
    copies = [tuple(a.clone() for a in args)
              for _ in range(max(4, 2 * H100.l2_bytes // size + 1))]
    calls = [lambda c=c: fn(*c) for c in copies]
    return statistics.median(device_ms(calls) for _ in range(3))


def profile(fn, args, causal, window, cap) -> str:
    """The device time of one call by kernel, from torch.profiler."""
    call(fn, *args, causal, window, cap)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call(fn, *args, causal, window, cap)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if "flash_bwd" in e.key and us > 0:
            kind = e.key.split("flash_bwd_")[-1].split("_kernel")[0]
            parts.append(f"{kind} {us / 1e3:.4f} ms")
    return ", ".join(parts) or "no device time"


def run_case(fns, name, dtype, shape, prof: bool) -> bool:
    b, s, sk, h, kv, hd, causal, window, cap = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, n, heads, hd, generator=g, device="cuda")
                   .to(dtype) for n, heads in ((s, h), (sk, kv), (sk, kv),
                                               (s, h)))
    lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    o = ops._forward_cuda(q, k, v, causal, window, cap, lse)
    args = (q, k, v, o, do, lse)
    # fp32 against the plain steps in float64, as chip_smoke.py's phase 8f.
    refs = attention_bwd_ref(*(a.double() if dtype == torch.float32 else a
                               for a in args), causal, window, cap)
    tol, row_tol = TOL[dtype]
    ok = True
    text = []
    for bname, fn in fns.items():
        grads = call(fn, *args, causal, window, cap, bname)
        errs = [errors(x, r) for x, r in zip(grads, refs)]
        good = all(e <= tol and r <= row_tol for e, r in errs)
        if bname == "as built":
            again = call(fn, *args, causal, window, cap)
            equal = all(torch.equal(x, y) for x, y in zip(grads, again))
            good = good and equal
            text.append(f"bit-equal {equal}")
        ok = ok and good
        text.append(f"{bname}: " + " ".join(
            f"{n} {e:.3g}/{r:.3g}" for n, (e, r) in zip(("dq", "dk", "dv"), errs))
            + ("" if good else " FAILS"))
    del refs
    order = list(fns) + list(reversed(fns))
    times = {n: [] for n in fns}
    for bname in order:
        times[bname].append(cold_ms(
            lambda *a, fn=fns[bname], n=bname: call(
                fn, *a, causal, window, cap, n), args))
    split = head_split(q, k)
    dname = str(dtype).split(".")[-1]
    print(f"{name} {dname} split {split}: " + "; ".join(text), flush=True)
    print(f"  ms " + "; ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)}"
                               for n, ts in times.items()), flush=True)
    if prof:
        print(f"  by kernel (as built): "
              f"{profile(fns['as built'], args, causal, window, cap)}",
              flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an earlier checkout whose kernel to time")
    ap.add_argument("--variants", action="store_true",
                    help="also the variants of the --dtype body")
    ap.add_argument("--profile", action="store_true",
                    help="the as-built call's device time by kernel")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="the inputs' type, and so the body timed")
    ap.add_argument("--splits", type=int, nargs="*", default=(),
                    help="also time the as-built body at these head splits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fp32 = args.dtype == "fp32"
    variants = FP32_VARIANTS if fp32 else VARIANTS
    fns = build(variants if args.variants else {"as built": []}, args.parent,
                args.dtype)
    for n in args.splits:
        fns[f"as built split {n}"] = fns["as built"]
    dtype = torch.float32 if fp32 else torch.bfloat16
    ok = True
    for name, shape in CASES.items():
        ok = run_case(fns, name, dtype, shape, args.profile) and ok
    print("all builds within the gates" if ok else "SOME BUILD FAILS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

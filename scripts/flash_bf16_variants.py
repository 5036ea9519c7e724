#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel against variants of its own source,
on one NVIDIA GPU: the two choices its source note names (the block's
warps at hd 64, and the SFU's exp2 with tanh built on it).

Each variant is a copy of the kernel's sources
(``kernels/flash_attention/csrc``) with a few lines replaced, built by
nvcc with the port's flags into its own library under
``build/flash_variants/`` (``build``, which
``scripts/flash_fp32_variants.py`` shares):

  as built          8 warps and 128 rows a block at hd <= 64; exp2 by the
                    SFU's ex2.approx.ftz and tanh from it;
  4 warps at hd 64  4 warps and 64 rows a block at every hd;
  exp2f and tanhf   the libm exp2f and tanhf in their place (in the
                    shared flash_common.cuh; only bf16 calls are timed).

At Llama-3.2-1B's attention (S 4096, H 32, KV 8, hd 64, causal) and
Gemma2-27B's (S 8192, H 32, KV 16, hd 128, softcap 50, with and without
the 4096 window), every variant is held against the plain version
(``attention_ref``: each element within 3e-2 of max(1, max|ref|), each
query row within 1e-2 of its norm) and timed in turns (A B C C B A), each
call on its own cold copy of q, k and v.  Prints the card's name and
power limit first, and ptxas' registers and spills of each bf16 kernel.

    PYTHONPATH=src python scripts/flash_bf16_variants.py
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import _ARGTYPES, DTYPES
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.util import device_ms

REPO = Path(__file__).resolve().parents[1]
CSRC = _build._KERNELS_DIR / "flash_attention" / "csrc"
OUT = _build.BUILD_DIR.parent / "flash_variants"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
TANH = "return 1.f - __fdividef(2.f, fast_exp2(2.f * LOG2E * x) + 1.f);"
BF16, COMMON = "flash_attention_bf16.cuh", "flash_common.cuh"
VARIANTS = {
    "as built": [],
    "4 warps at hd 64": [(BF16, "HD <= 64 ? 8 : 4", "HD <= 64 ? 4 : 4")],
    "exp2f and tanhf": [(COMMON, EX2, "y = exp2f(x);"),
                        (COMMON, TANH, "return tanhf(x);")],
}
CASES = {
    "llama3.2-1b": (1, 4096, 4096, 32, 8, 64, True, 0, 0.0),
    "gemma2-27b local": (1, 8192, 8192, 32, 16, 128, True, 4096, 50.0),
    "gemma2-27b attn": (1, 8192, 8192, 32, 16, 128, True, 0, 50.0),
}


def build(variants: dict, out: Path = OUT, parent: Path | None = None,
          skip: str = "fp32") -> dict:
    """Each variant's C entry, all nvcc processes at once.  ``variants``
    maps a name to its edits, (file in csrc, old text, new text), each
    old text found once; ``parent`` (the root of an earlier checkout) adds
    a variant "parent" built from that tree's sources as they are.
    Prints ptxas' registers and spills of each kernel whose name does not
    hold ``skip``."""
    jobs = {name: (CSRC, edits) for name, edits in variants.items()}
    if parent is not None:
        jobs["parent"] = (parent / CSRC.relative_to(REPO), [])
    procs = {}
    for i, (name, (src, edits)) in enumerate(jobs.items()):
        d = out / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src, d)
        for file, old, new in edits:
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once "
                                   f"in {file}")
            (d / file).write_text(text.replace(old, new))
        # From the kernels directory, so -I csrc finds the shared headers.
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention.cu")], cwd=_build._KERNELS_DIR,
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
            elif skip not in entry and ("registers" in line or "spill" in line):
                print(f"  ptxas {name} {entry}: {line.strip()}")
        fn = ctypes.CDLL(str(lib)).repro_flash_attention
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, q, k, v, causal, window, cap):
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
             k.shape[1], h, k.shape[2], hd, DTYPES[q.dtype], int(causal),
             window, cap, torch.cuda.current_stream().cuda_stream, None)
    _build.check(err, "flash_attention variant")
    return out


def cold_ms(fn, args) -> float:
    """Device ms per call, each call on its own copy of ``args`` (the
    copies together exceed twice the L2), median of 3 rounds."""
    size = sum(a.numel() * a.element_size() for a in args)
    copies = [tuple(a.clone() for a in args)
              for _ in range(max(4, 2 * H100.l2_bytes // size + 1))]
    calls = [lambda c=c: fn(*c) for c in copies]
    return statistics.median(device_ms(calls) for _ in range(3))


def time_variants(fns: dict, dtype: torch.dtype, tol: float,
                  row_tol: float) -> None:
    """At each of CASES, every variant held against the plain version (each
    element within ``tol`` of max(1, max|ref|), each query row within
    ``row_tol`` of its norm) and timed in turns (A B C C B A); prints the
    two times and the errors of each."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for case, (b, s, sk, h, kv, hd, causal, window, cap) in CASES.items():
        q, k, v = (torch.randn(b, n, heads, hd, generator=g, device="cuda")
                   .to(dtype) for n, heads in ((s, h), (sk, kv), (sk, kv)))
        ref = attention_ref(q, k, v, causal, window, cap).float()
        times, errors = {name: [] for name in fns}, {}
        for name in [*fns, *reversed(fns)]:
            got = call(fns[name], q, k, v, causal, window, cap).float()
            err = float((got - ref).abs().max())
            row = float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
            if err > tol * max(1.0, float(ref.abs().max())) or row > row_tol:
                raise AssertionError(f"{case} {name}: max_abs_err {err}, "
                                     f"row error {row}")
            errors[name] = f"max_abs_err {err:.3g} row_err {row:.3g}"
            times[name].append(cold_ms(
                lambda q, k, v, fn=fns[name]: call(fn, q, k, v, causal,
                                                   window, cap), (q, k, v)))
        for name, ms in times.items():
            print(f"{case} {name}: ms {ms[0]:.4f} {ms[1]:.4f} (in turns), "
                  f"{errors[name]}")


def card_header() -> bool:
    """Prints the card's name and power limit; False without a card."""
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return True


def main() -> int:
    if not card_header():
        return 1
    time_variants(build(VARIANTS), torch.bfloat16, 3e-2, 1e-2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the int8 implicit-GEMM conv and the fused Winograd kernel against
variants of their own sources, and against an earlier commit's kernels,
on one NVIDIA GPU.

Each variant is a kernel source with a few lines replaced, built by nvcc
with the port's flags into its own directory under
``build/conv_tc_variants/``:

  int8 conv (csrc/im2col_conv_q8.cu, mma.sync s8 with split-K):
    as built        2 blocks a SM, the wrapper's split rule;
    no split        the same library called with one split;
    3 blocks a SM   __launch_bounds__ asking for 3 (at most 85 registers
                    a thread), split over 3 resident blocks;
  fused Winograd (csrc/winograd_fused.cu, 3xTF32 tensor cores):
    as built        lo.hi, hi.lo and hi.hi per product;
    truncated split hi = x with its 13 low bits cleared and lo = x - hi,
                    unrounded (2 instructions a value, not 5), gated;
    hi.hi only      the two correction products left out: plain TF32,
                    which fails the gate (its error is printed, not
                    gated): what the corrections cost;
    no products, no U copies, no tile copies, no transforms
                    diagnostics: one piece of a chunk's work left out (no
                    mma.sync; U and the tiles copied for the first chunk
                    only; B^T applied as the identity), wrong results
                    (printed, not gated): what each piece costs;
  both, with ``--parent DIR`` (the root of a checkout of an earlier
  commit, e.g. ``git archive`` of the parent unpacked into a git-ignored
  directory):
    parent          that commit's im2col_conv_q8.cu and winograd_fused.cu,
                    called through their own C entries (the int8 conv
                    unsplit where its entry takes no workspace or split
                    count, else split as built; the fused kernel with the
                    earlier (bt, bo) rule: bo a power of two in [16, 64],
                    bt = 256 / bo).

Every call of the int8 plans of YOLOv3-tiny 416 b1 and VGG-16 224 b1 and
every fused Winograd call of the fp32 plans of YOLOv3-tiny 416 b1,
MODEL_20 608 b1 and VGG-16 224 b1 (the shapes ``chip_smoke.py`` times),
on seeded operands: each variant held against the plain version (int8
bit for bit, fused within 5e-4 of max(1, max|ref|)) and timed in turns
(A B C C B A), each call on its own cold copy of its operands.  Prints
the card's name and power limit first, ptxas' registers and spills of
each build, and the sums per cell and variant.

    PYTHONPATH=src python scripts/conv_tc_variants.py [--parent DIR] [--kernels q8,fused]
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

from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ACTIVATION_CODES, ConvAlgorithm
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.core.winograd import _tile_input, transform_weights
from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_k
from repro_torch.kernels.im2col_gemm.ops import (
    _ARGTYPES_Q8,
    CHUNK_Q8,
    call_splits_q8,
    grid_blocks,
    tile_width,
)
from repro_torch.kernels.im2col_gemm.ref import im2col_conv_q8_ref
from repro_torch.kernels.winograd.ops import _ARGTYPES as FUSED_ARGTYPES
from repro_torch.kernels.winograd.ops import FUSED_BLOCKS
from repro_torch.kernels.winograd.ref import fused_winograd_ref
from repro_torch.util import device_ms

KERNELS = Path(_build.__file__).parent
REL = {"q8": Path("im2col_gemm/csrc/im2col_conv_q8.cu"),
       "fused": Path("winograd/csrc/winograd_fused.cu")}
HEADERS = (Path("csrc/sgemm_3xtf32.cuh"), Path("csrc/s8_mma.cuh"),
           Path("winograd/csrc/winograd_transforms.cuh"))
SYMBOL = {"q8": "repro_im2col_conv_q8", "fused": "repro_winograd_fused"}
OUT = _build.BUILD_DIR.parent / "conv_tc_variants"
# PR 16's int8 entry: no workspace and no split count.
PARENT_Q8_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
HIHI = [("        tc::mma_tf32(acc[pp][ni], al, bh);\n", ""),
        ("        tc::mma_tf32(acc[pp][ni], ah, bl);\n", "")]
NO_PRODUCTS = HIHI + [("        tc::mma_tf32(acc[pp][ni], ah, bh);\n", "")]
NO_U_COPIES = [("    if (chunk + 1 < chunks) stage_u(chunk + 1, (chunk + 1) & 1);\n", "")]
NO_TILE_COPIES = [("    if (chunk + 1 < chunks) stage_tile(chunk + 1);\n", "")]
NO_TRANSFORMS = [("      bt8(d, r);\n", "      for (int k = 0; k < 8; ++k) r[k] = d[k];\n"),
                 ("      bt8(col, r);\n", "      for (int k = 0; k < 8; ++k) r[k] = col[k];\n")]
# hi = x with its 13 low bits cleared, lo = x - hi passed whole (the
# tensor core reads a TF32 operand's top 19 bits): 2 instructions a value
# instead of rounding both halves (5).
TRUNCATED_SPLIT = [("namespace tc = sgemm_tc;", """namespace tcv {
using namespace sgemm_tc;
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
}  // namespace tcv
namespace tc = tcv;""")]
VARIANTS = {
    "q8": {"as built": [], "3 blocks a SM": [
        ("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 3;")]},
    "fused": {"as built": [], "truncated split": TRUNCATED_SPLIT,
              "hi.hi only": HIHI, "no products": NO_PRODUCTS,
              "no U copies": NO_U_COPIES, "no tile copies": NO_TILE_COPIES,
              "no transforms": NO_TRANSFORMS},
}
RESIDENT = {"as built": 2, "no split": None, "3 blocks a SM": 3}
#: Variants that drop work: timed, their error printed, not gated.
DIAGNOSTIC = {"hi.hi only", "no products", "no U copies", "no tile copies",
              "no transforms"}
GATE = 5e-4


def build(parent: Path | None):
    """((kernel, variant) -> C entry, the (kernel, variant) pairs whose int8
    entry takes no workspace or split count: the earlier, unsplit one),
    all nvcc processes at once."""
    jobs = {}
    for kernel, variants in VARIANTS.items():
        for name, edits in variants.items():
            text = (KERNELS / REL[kernel]).read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{kernel} {name!r}: {old!r} not found once")
                text = text.replace(old, new)
            jobs[kernel, name] = (text, KERNELS)
        if parent is not None:
            base = parent / "src" / "repro_torch" / "kernels"
            jobs[kernel, "parent"] = ((base / REL[kernel]).read_text(), base)
    unsplit = {(k, n) for (k, n), (text, _) in jobs.items()
               if k == "q8" and "int* ws" not in text[text.index('extern "C"'):]}
    procs = {}
    for i, ((kernel, name), (text, base)) in enumerate(jobs.items()):
        d = OUT / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for h in HEADERS:
            if (base / h).exists():
                shutil.copy(base / h, d)
        src = d / REL[kernel].name
        src.write_text(text)
        procs[kernel, name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(src)], cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (kernel, name), (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name!r}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {kernel} {name}: {line.strip()}")
        fn = getattr(ctypes.CDLL(str(path)), SYMBOL[kernel])
        fn.argtypes = (PARENT_Q8_ARGTYPES if (kernel, name) in unsplit
                       else _ARGTYPES_Q8 if kernel == "q8" else FUSED_ARGTYPES)
        fn.restype = ctypes.c_int
        fns[kernel, name] = fn
    return fns, unsplit


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def q8_run(fn, name, geo, unsplit):
    """A closure calling int8 entry ``fn`` as variant ``name`` on
    (x, w, scale, bias); ``unsplit``: through the earlier entry, which
    takes no workspace or split count."""
    b, h, w, c, o, oh, ow, kh, kw, sh, sw, ph, pw, toh = geo
    tow = tile_width(toh, ow)
    if unsplit:
        def run(x, wt, scale, bias):
            out = torch.empty((b, oh, ow, o), device="cuda")
            _build.check(fn(x.data_ptr(), wt.data_ptr(), scale.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), b, h, w, c, o, oh,
                            ow, kh, kw, sh, sw, ph, pw, toh, tow,
                            ACTIVATION_CODES["leaky"], stream()), name)
            return out
        return run
    resident = RESIDENT.get(name, 2)
    splits = (1 if resident is None else
              split_k(grid_blocks(b, oh, ow, o, toh), -(-c // CHUNK_Q8), resident))

    def run(x, wt, scale, bias):
        out = torch.empty((b, oh, ow, o), device="cuda")
        ws = (torch.empty((splits, b * oh * ow, o), device="cuda",
                          dtype=torch.int32) if splits > 1 else None)
        _build.check(fn(x.data_ptr(), wt.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), out.data_ptr(),
                        ws.data_ptr() if ws is not None else None, b, h, w, c,
                        o, oh, ow, kh, kw, sh, sw, ph, pw, toh, tow,
                        ACTIVATION_CODES["leaky"], splits, stream()), name)
        return out
    return run


def fused_run(fn, name):
    def run(tiles, u, bias):
        t, c, o = tiles.shape[0], tiles.shape[-1], u.shape[-1]
        if name == "parent":
            bo = 16
            while bo < min(o, 64):
                bo *= 2
            bt = 256 // bo
        else:
            bt, _, bo = FUSED_BLOCKS
        out = torch.empty((t, 6, 6, o), device="cuda")
        _build.check(fn(tiles.data_ptr(), u.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), t, c, o, bt, bo,
                        ACTIVATION_CODES["leaky"], stream()), name)
        return out
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
    """(cell, label, kernel, args, reference, geometry) of every timed call."""
    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device="cuda")

    def q8(*shape):
        return torch.tensor(rng.integers(-127, 128, shape).astype(np.int8),
                            device="cuda")

    out = []
    for cell, model, dtype in (
            ("yolov3-tiny 416 b1 int8", yolov3.TINY_MODEL, "int8"),
            ("vgg16 224 b1 int8", vgg16.MODEL, "int8"),
            ("yolov3-tiny 416 b1", yolov3.TINY_MODEL, "float32"),
            ("yolov3-20 608 b1", yolov3.MODEL_20, "float32"),
            ("vgg16 224 b1", vgg16.MODEL, "float32")):
        netplan = plan_network(model.layers, *model.input_hw, Planner(),
                               in_channels=model.in_channels, batch=1,
                               dtype=dtype)
        for s in netplan.steps:
            if s.layer.kind != "conv":
                continue
            spec, (h, w), (oh, ow) = s.spec, s.in_hw, s.out_hw
            c, o = s.in_layout.phys_c, spec.out_channels
            if (dtype == "int8" and s.plan.dtype == "int8"
                    and s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM):
                toh = s.plan.kernel_blocks[0]
                x, wt = q8(1, h, w, c), q8(spec.kh, spec.kw, c, o)
                scale = torch.tensor(rng.uniform(0.5, 2.0, o).astype(np.float32)
                                     * 1e-3, device="cuda")
                bias = t(o)
                ref = im2col_conv_q8_ref(x, wt, spec, scale, bias, "leaky")
                geo = (1, h, w, c, o, oh, ow, spec.kh, spec.kw, *spec.stride,
                       *spec.padding, toh)
                label = (f"L{s.index} {h}x{w}x{c}->{oh}x{ow}x{o} s{spec.stride[0]}"
                         f" splits={call_splits_q8(1, oh, ow, c, o, toh)}")
                out.append((cell, label, "q8", (x, wt, scale, bias), ref, geo))
            elif (dtype == "float32" and s.plan.algorithm is ConvAlgorithm.WINOGRAD
                  and s.plan.winograd_fused):
                xp = t(1, h + 2, w + 2, c)
                tiles, _, _ = _tile_input(xp, oh, ow)
                tiles = tiles.reshape(-1, 8, 8, c).contiguous()
                u = transform_weights(t(3, 3, c, o)).contiguous()
                bias = t(o)
                ref = fused_winograd_ref(tiles, u, bias, "leaky")
                out.append((cell, f"L{s.index} T={tiles.shape[0]} C={c} O={o}",
                            "fused", (tiles, u, bias), ref, None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of a checkout of an earlier commit")
    ap.add_argument("--kernels", default="q8,fused",
                    help="which kernels to build and time (q8, fused)")
    args = ap.parse_args()
    for k in set(VARIANTS) - set(args.kernels.split(",")):
        del VARIANTS[k]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns, unsplit = build(args.parent)
    totals = collections.defaultdict(lambda: [0.0, 0.0])
    for cell, label, kernel, operands, ref, geo in cases(np.random.default_rng(0)):
        if kernel not in VARIANTS:
            continue
        names = [n for k, n in fns if k == kernel]
        if kernel == "q8":
            names.insert(1, "no split")
        runs = {}
        for n in names:
            fn = fns[kernel, "as built" if n == "no split" else n]
            runs[n] = (q8_run(fn, n, geo, ("q8", n) in unsplit)
                       if kernel == "q8" else fused_run(fn, n))
        times, rel = {n: [] for n in names}, {}
        scale = max(1.0, float(ref.abs().max()))
        for n in [*names, *reversed(names)]:
            got = runs[n](*operands)
            torch.cuda.synchronize()
            rel[n] = float((got - ref).abs().max()) / scale
            if n not in DIAGNOSTIC and not (torch.equal(got, ref)
                                            if kernel == "q8" else rel[n] <= GATE):
                raise AssertionError(f"{cell} {label} {n}: error {rel[n]:.3g}")
            times[n].append(cold_ms(runs[n], operands))
        for n, ms in times.items():
            totals[cell, n][0] += ms[0]
            totals[cell, n][1] += ms[1]
            print(f"{cell} {label} {n}: ms {ms[0]:.4f} {ms[1]:.4f} (in turns), "
                  f"error / max(1, max|ref|) {rel[n]:.2e}")
    for (cell, n), (t0, t1) in totals.items():
        print(f"total {cell} {n}: ms {t0:.4f} {t1:.4f} (in turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Check and time the 16-bit GEMM (gemm/csrc/gemm_16.cu) and the 16-bit
implicit-GEMM conv (im2col_gemm/csrc/im2col_conv_16.cu) against variants
of their own sources and, with ``--parent``, against an earlier tree's
kernels, on one NVIDIA GPU: one variant for each step of their design.

Each variant is a copy of the kernels' sources (the ``.cu`` file and the
shared headers of ``kernels/csrc``), edited as the variant says and built
by nvcc with the port's flags into its own library under
``build/conv16_variants/``:

    as built     wgmma m64n64k16 fed by a TMA ring (GEMM up to 3 stages,
                 conv 2, no more than a block's chunks), one producer
                 warp, the conv's A from registers (128 raster pixels or
                 two runs of 64 an item), persistent blocks where K is not
                 split, K splits summed across a thread block cluster in
                 the same launch;
    unsplit      the same library with one split on every call: what the
                 in-kernel split-K buys;
    one item a block
                 no persistent blocks: one block a tile, GEMM and conv;
    conv ring of 4
                 the conv's ring up to 4 stages (MAX_STAGES = 4);
    parent       (--parent DIR) the earlier tree's kernels (mma.sync, 64 x
                 64 tiles, the split-K reduce as a second kernel), called
                 with the signatures and the split and row-tile rules they
                 had;
    no products, serial taps, copies only, no window, no weights
                 diagnostics of the conv: its products left out; each
                 tap's products waited for before the next tap's A is
                 loaded; neither products nor A loads, only the copies and
                 the epilogue; the input window's copies left out; the
                 weights' copies left out (not gated: all but serial taps
                 give wrong results).

Every 16-bit GEMM and im2col call of YOLOv3-tiny 416, MODEL_20 608 and
VGG-16 224 at batch 1, as the cost mode plans them and as the cost model
(``mode='model'``) plans them, goes through every variant in bf16 and
fp16 and is held against the plain version (two units of the type's last
place at the largest output: 2^-6 of max(1, max|ref|) in bf16, 2^-9 in
fp16); then, in bf16, each call is timed in turns (variants in order, then
in reverse), each launch on its own cold operands, beside ``torch.addmm``
or ``F.conv2d`` on the same operands.  Prints the card's name and power
limit first, ptxas' registers, shared memory and spills of each variant's
kernels, a line per call and variant, and the sums over each cell's calls.

    PYTHONPATH=src python scripts/conv16_variants.py [--parent DIR] [--check]

``--check`` stops after the checks (no timing); ``--cells TEXT`` times
only the cells whose name holds TEXT.  ``DIR`` is the root of an earlier
checkout (``git archive <commit> | tar -x -C DIR``).
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ACTIVATION_CODES, ConvAlgorithm, \
    ConvSpec, apply_activation
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels._splitk import split_k
from repro_torch.kernels.gemm.ops import _ARGTYPES_16 as GEMM_ARGTYPES
from repro_torch.kernels.gemm.ops import call_splits_16 as gemm_splits
from repro_torch.kernels.gemm.ops import tma_rows16
from repro_torch.kernels.gemm.ref import matmul16_ref
from repro_torch.kernels.im2col_gemm.ops import _ARGTYPES_16 as CONV_ARGTYPES
from repro_torch.kernels.im2col_gemm.ops import call_splits_16 as conv_splits
from repro_torch.kernels.im2col_gemm.ref import im2col_conv16_ref
from repro_torch.util import device_ms

REPO = Path(__file__).resolve().parents[1]
OUT = _build.BUILD_DIR.parent / "conv16_variants"
SOURCES = {"gemm": "gemm/csrc/gemm_16.cu",
           "conv": "im2col_gemm/csrc/im2col_conv_16.cu"}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: The parent's C entries: a workspace pointer after the output; the conv
#: with its row tile (toh, tow).
PARENT_ARGTYPES = {"gemm": [_P] * 5 + [_I] * 6 + [_P],
                   "conv": [_P] * 5 + [_I] * 18 + [_P]}
#: name -> kind -> edits of that kind's source: (old text, new text); a
#: kind a variant does not edit runs the library as built.
VARIANTS = {"as built": {}, "unsplit": {},
            "one item a block": {"gemm": [("if (splits == 1) {",
                                           "if (false) {")],
                                 "conv": [("if (g.splits == 1) {",
                                           "if (false) {")]},
            "conv ring of 4": {"conv": [("MAX_STAGES = 2;",
                                         "MAX_STAGES = 4;")]}}
#: Diagnostics of the conv (not gated: all but "serial taps" give wrong
#: results): its products left out; each tap's products waited for before
#: the next tap's A is loaded; neither products nor A loads; the input
#: window's copies left out; the weights' copies left out: what the
#: products, their overlap and each stream of copies cost.
DIAGNOSTIC = {
    "no products": {"conv": [("        product(a0, wgt, tap);\n", ""),
                             ("          product(a1, wgt, tap + 1);\n", "")]},
    "serial taps": {"conv": [("wgmma16::commit();\n",
                              "wgmma16::commit();\n"
                              "        wgmma16::wait<0>();\n")]},
    "copies only": {"conv": [("        product(a0, wgt, tap);\n", ""),
                             ("          product(a1, wgt, tap + 1);\n", ""),
                             ("      load_a(a0, win, px0, 0);\n", ""),
                             ("          load_a(a1, win, px0, tap + 1);\n",
                              ""),
                             ("          load_a(a0, win, px0, tap + 2);\n",
                              "")]},
    "no window": {"conv": [("mbar_expect_tx(&full[s], g.tx_bytes);",
                            "mbar_expect_tx(&full[s], g.w_bytes);"),
                           ("for (int j = 0; j < g.segs; ++j) {",
                            "for (int j = 0; j < 0; ++j) {")]},
    "no weights": {"conv": [("mbar_expect_tx(&full[s], g.tx_bytes);",
                             "mbar_expect_tx(&full[s], g.tx_bytes - "
                             "g.w_bytes);"),
                            ("        hopper::tma_load_3d(st, &w_map, "
                             "&full[s], x.o0, c * CK, 0);\n", "")]},
}
TOL = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}
CODES = {torch.bfloat16: 0, torch.float16: 1}
#: Calls no cell plans, checked (not timed) beside the cells': a 1x1 head
#: with 255 out channels and a stride-2 conv with C = 8 and O = 20 (the
#: weights' rows padded to a multiple of 8), C = 8 with O not a multiple
#: of 64, and GEMMs with N = 100 and N = 255 (B's rows padded).
EDGE_CALLS = [
    dict(kind="conv", step=0, act="linear", spec=ConvSpec(512, 255, (1, 1),
         padding=(0, 0)), h=13, w=13, c=512, o=255,
         label="im2col 13x13x512->13x13x255 k1"),
    dict(kind="conv", step=0, act="leaky", spec=ConvSpec(8, 20, (3, 3),
         (2, 2)), h=19, w=70, c=8, o=20,
         label="im2col 19x70x8->10x35x20 s2"),
    dict(kind="conv", step=0, act="relu", spec=ConvSpec(8, 72), h=9, w=150,
         c=8, o=72, label="im2col 9x150x8->9x150x72 s1"),
    dict(kind="gemm", step=0, act="leaky", m=70, k=48, n=100,
         label="gemm M=70 K=48 N=100"),
    dict(kind="gemm", step=0, act="leaky", m=169, k=512, n=255,
         label="gemm M=169 K=512 N=255"),
]
CELLS = {"yolov3-tiny 416 b1": yolov3.TINY_MODEL,
         "yolov3-20 608 b1": yolov3.MODEL_20,
         "vgg16 224 b1": vgg16.MODEL}


def log(*parts) -> None:
    print(*parts, flush=True)


def build(parent: Path | None) -> dict:
    """(variant, kind) -> library, one nvcc per library, all at once."""
    jobs = {}
    for name, edits in {**VARIANTS, **DIAGNOSTIC}.items():
        for kind, src in SOURCES.items():
            if name == "as built" or kind in edits:
                jobs[name, kind] = (_build._KERNELS_DIR, src,
                                    edits.get(kind, []))
    if parent is not None:
        for kind, src in SOURCES.items():
            jobs["parent", kind] = (
                parent / _build._KERNELS_DIR.relative_to(REPO), src, [])
    procs = {}
    for i, ((name, kind), (root, src, edits)) in enumerate(jobs.items()):
        d = OUT / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(root / Path(src).parent, d)
        for header in (root / "csrc").glob("*.cuh"):
            shutil.copy(header, d / header.name)
        text = (d / Path(src).name).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in {src}")
            text = text.replace(old, new)
        (d / Path(src).name).write_text(text)
        procs[name, kind] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(d / "lib.so"), str(d / Path(src).name)], cwd=d,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and (
                    "gemm16" in entry or "im2col16" in entry):
                log(f"  ptxas {key[0]} {key[1]} {entry[-50:]}: "
                    f"{line.strip()}")
        libs[key] = ctypes.CDLL(str(lib))
    for name in {**VARIANTS, **DIAGNOSTIC}:
        for kind in SOURCES:
            libs.setdefault((name, kind), libs["as built", kind])
    return libs


def parent_gemm_splits(m, n, k):
    return split_k(-(-m // 64) * -(-n // 64), -(-k // 32), 4)


def parent_conv_tile(oh, ow):
    """The parent's (toh, tow): whole rows of at most 64 pixels, snapped
    to divide OH (im2col_gemm/ops.py::pick_blocks, snap_row_tile)."""
    toh = max(1, min(oh, 64 // ow) if ow <= 64 else 8)
    snapped = min(toh, oh)
    while oh % snapped:
        snapped -= 1
    toh = toh if snapped < min(toh, oh) / 2 else snapped
    return toh, min(ow, 64 // toh)


def entry(libs, variant, kind):
    lib = libs[variant, kind]
    fn = lib.repro_gemm16_bias_act if kind == "gemm" else \
        lib.repro_im2col_conv16
    fn.argtypes = (PARENT_ARGTYPES[kind] if variant == "parent" else
                   GEMM_ARGTYPES if kind == "gemm" else CONV_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def caller(libs, variant, call):
    """A function of the call's operands that launches ``variant``."""
    kind = call["kind"]
    fn = entry(libs, variant, kind)
    act = ACTIVATION_CODES[call["act"]]
    stream = lambda t: torch.cuda.current_stream().cuda_stream  # noqa: E731

    if kind == "gemm":
        def run(a, b, bias):
            m, k = a.shape
            n = call["n"]
            out = torch.empty((m, n), device=a.device, dtype=a.dtype)
            if variant == "parent":
                s = parent_gemm_splits(m, n, k)
                ws = torch.empty((s, m, n), device=a.device) if s > 1 else None
                err = fn(a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), ws.data_ptr() if s > 1 else None,
                         m, n, k, act, s, CODES[a.dtype], stream(a))
            else:
                s = 1 if variant == "unsplit" else gemm_splits(m, n, k)
                err = fn(a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), m, n, k, b.stride(0), act, s,
                         CODES[a.dtype], stream(a))
            if err:
                raise RuntimeError(f"{variant} gemm: CUDA error {err}")
            return out
        return run

    spec = call["spec"]
    (sh, sw), (ph, pw), (kh, kw) = spec.stride, spec.padding, spec.kernel_size

    def run(x, w, bias):
        b, h, ww, c = x.shape
        o = w.shape[-1]
        oh, ow = spec.out_hw(h, ww)
        out = torch.empty((b, oh, ow, o), device=x.device, dtype=x.dtype)
        if variant == "parent":
            toh, tow = parent_conv_tile(oh, ow)
            grid = b * -(-oh // toh) * -(-ow // tow) * -(-o // 64)
            s = split_k(grid, -(-c // 16), 2)
            ws = (torch.empty((s, b * oh * ow, o), device=x.device)
                  if s > 1 else None)
            err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), ws.data_ptr() if s > 1 else None, b, h,
                     ww, c, o, oh, ow, kh, kw, sh, sw, ph, pw, toh, tow, act,
                     s, CODES[x.dtype], stream(x))
        else:
            s = 1 if variant == "unsplit" else conv_splits(b, oh, ow, c, o)
            err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), b, h, ww, c, o, w.stride(2), oh, ow, kh,
                     kw, sh, sw, ph, pw, act, s, CODES[x.dtype], stream(x))
        if err:
            raise RuntimeError(f"{variant} conv: CUDA error {err}")
        return out
    return run


def calls(model, mode):
    """The 16-bit GEMM and im2col calls of ``model`` at batch 1 as ``mode``
    plans them in bf16: their kind, shapes and activation."""
    plan = plan_network(model.layers, *model.input_hw,
                        Planner(impl="torch", device="cpu", mode=mode),
                        in_channels=model.in_channels, batch=1,
                        dtype="bfloat16")
    out = []
    for s in plan.steps:
        if s.layer.kind != "conv" or \
                s.plan.algorithm is ConvAlgorithm.WINOGRAD:
            continue
        (h, w), (oh, ow) = s.in_hw, s.out_hw
        c, o, act = s.in_layout.phys_c, s.spec.out_channels, s.layer.activation
        if s.plan.algorithm is ConvAlgorithm.DIRECT:
            out.append(dict(kind="gemm", step=s.index, act=act,
                            m=oh * ow, k=c, n=o,
                            label=f"L{s.index} gemm M={oh * ow} K={c} N={o}"))
        else:
            out.append(dict(kind="conv", step=s.index, act=act, spec=s.spec,
                            h=h, w=w, c=c, o=o,
                            label=(f"L{s.index} im2col {h}x{w}x{c}->{oh}x{ow}"
                                   f"x{o} s{s.spec.stride[0]}")))
    return out


def operands(call, dtype, rng):
    """Seeded operands of one call, weights scaled by 1 / sqrt(fan-in) and
    laid out as the network plan keeps them (``tma_rows16``: rows padded
    to a multiple of 8 where N or O is not one; the parent's kernels, which
    take no row stride, get ``for_parent``'s contiguous copy)."""
    def t(*shape, scale=1.0):
        return torch.tensor((rng.standard_normal(shape) * scale)
                            .astype(np.float32), device="cuda")
    if call["kind"] == "gemm":
        m, k, n = call["m"], call["k"], call["n"]
        return (t(m, k).to(dtype),
                tma_rows16(t(k, n, scale=k ** -0.5).to(dtype)), t(n))
    spec = call["spec"]
    fan = spec.kh * spec.kw * call["c"]
    return (t(1, call["h"], call["w"], call["c"]).to(dtype),
            tma_rows16(t(spec.kh, spec.kw, call["c"], call["o"],
                         scale=fan ** -0.5).to(dtype)), t(call["o"]))


def for_parent(variant, args):
    """``args`` as ``variant`` takes them: the parent's weights packed."""
    if variant != "parent":
        return args
    return args[0], args[1].contiguous(), args[2]


def plain(call, args):
    if call["kind"] == "gemm":
        return matmul16_ref(args[0], args[1], args[2], call["act"])
    return im2col_conv16_ref(args[0], args[1], call["spec"], args[2],
                             call["act"])


def library(call, args):
    """One PyTorch call of the same function in the 16-bit type, and its
    operands."""
    if call["kind"] == "gemm":
        a, b, bias = args
        return (lambda a, b, bias: apply_activation(
            torch.addmm(bias, a, b), call["act"])), (
            a, b.contiguous(), bias.to(a.dtype))
    x, w, bias = args
    spec = call["spec"]
    return (lambda x, w, bias: apply_activation(F.conv2d(
        x, w, bias, spec.stride, spec.padding), call["act"])), (
        x.permute(0, 3, 1, 2).contiguous(),
        w.permute(3, 2, 0, 1).contiguous(), bias.to(x.dtype))


def cold_ms(fn, args) -> float:
    """Device ms per call, each call on its own copy of ``args`` (the
    copies together exceed twice the L2; a weight's padded rows kept),
    median of 3 rounds."""
    size = sum(a.numel() * a.element_size() for a in args)
    copies = [tuple(a.clone() if a.is_contiguous() else tma_rows16(a.clone())
                    for a in args)
              for _ in range(max(4, 2 * H100.l2_bytes // size + 1))]
    calls_ = [lambda c=c: fn(*c) for c in copies]
    fn(*copies[0])
    return statistics.median(device_ms(calls_) for _ in range(3))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--check", action="store_true",
                    help="check every variant's calls, time nothing")
    ap.add_argument("--cells", default=None,
                    help="time only the cells whose name holds this text")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv16_variants: no CUDA device", file=sys.stderr)
        return 1
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    libs = build(args.parent)
    variants = (list(VARIANTS) + (["parent"] if args.parent else [])
                + list(DIAGNOSTIC))
    rng = np.random.default_rng(0)
    cells = {}
    for cell, model in CELLS.items():
        for mode in ("cost", "model"):
            cells[f"{cell} {mode}"] = calls(model, mode)
    bad = 0
    for dtype in (torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[-1]
        for cell, cs in {**cells, "edge": EDGE_CALLS}.items():
            for call in cs:
                ops = operands(call, dtype, rng)
                ref = plain(call, ops).float()
                tol = TOL[dname] * max(1.0, float(ref.abs().max()))
                errs = []
                for v in variants:
                    got = caller(libs, v, call)(*for_parent(v, ops))
                    torch.cuda.synchronize()
                    err = float((got.float() - ref).abs().max())
                    ok = bool(torch.isfinite(got).all()) and err <= tol
                    if v in DIAGNOSTIC:
                        errs.append(f"{v} {err:.3g} (not gated)")
                        continue
                    bad += not ok
                    errs.append(f"{v} {err:.3g}" + ("" if ok else " FAIL"))
                log(f"check {dname} {cell} {call['label']} tol {tol:.3g}: "
                    + ", ".join(errs))
    if bad:
        raise AssertionError(f"{bad} calls disagree with the plain version")
    log("check: every call of every variant within its gate")
    if args.check:
        return 0
    order = variants + variants[::-1]
    for cell, cs in cells.items():
        if args.cells and args.cells not in cell:
            continue
        sums = dict.fromkeys(variants + ["library"], 0.0)
        for call in cs:
            ops = operands(call, torch.bfloat16, rng)
            ms = {v: [] for v in variants}
            for v in order:
                ms[v].append(cold_ms(caller(libs, v, call),
                                     for_parent(v, ops)))
            lib_fn, lib_args = library(call, ops)
            lib_ms = cold_ms(lib_fn, lib_args)
            sums["library"] += lib_ms
            parts = []
            for v in variants:
                mean = sum(ms[v]) / 2
                sums[v] += mean
                parts.append(f"{v} {mean:.4f} ({ms[v][0]:.4f}, "
                             f"{ms[v][1]:.4f})")
            kind = call["kind"]
            n = call.get("m", 0) if kind == "gemm" else 0
            splits = (gemm_splits(n, call["n"], call["k"]) if kind == "gemm"
                      else conv_splits(1, *call["spec"].out_hw(
                          call["h"], call["w"]), call["c"], call["o"]))
            log(f"time {cell} {call['label']} splits={splits}: "
                + ", ".join(parts) + f", library {lib_ms:.4f}")
        log(f"sum {cell} over {len(cs)} calls: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

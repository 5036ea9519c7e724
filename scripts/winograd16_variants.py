#!/usr/bin/env python3
"""Time the 16-bit fused Winograd kernel and the 16-bit tuple multiply
against variants of their own sources and, with ``--parent``, against an
earlier tree's kernels, on one NVIDIA GPU: one variant for each step of
their design.

Each variant is a copy of the kernels' sources (``kernels/winograd/csrc``
and the shared headers of ``kernels/csrc``) built by nvcc with the port's
flags, and a macro of its own where it has one, into its own library under
``build/winograd16_variants/``:

  fused kernel (winograd_fused_16.cu)
    as built         a ring of 3 U stages fed by TMA, the last warp to
                     release a stage refills it, C split across blocks by
                     ``call_splits_16`` with the ordered reduce;
    unsplit          the same library with one split at every layer;
    2 splits         the same library with two splits at every layer;
    no products, no U copies, no V stores, one barrier a chunk
                     diagnostics: one piece of a chunk's work left out
                     (no mma.sync; no U copies nor waits on them; V's
                     stores; the barrier after V's stores), wrong results
                     (not gated): what each piece costs;
    parent           (--parent) the earlier tree's kernel.
  tuple multiply (winograd_3pass_16.cu)
    as built         persistent blocks, one producer warp, wgmma m64nNk16
                     with N = 64, 128 or 256 by O;
    one item a block the same kernel with a block for every work item
                     (TM16_PERSISTENT=0);
    parent           (--parent) the earlier tree's kernel.

At VGG-16 224 b1's seven Winograd layers in bf16 (its network plan's
shapes), and for the fused kernel also at YOLOv3-tiny 416 b1's four and
MODEL_20 608 b1's six, every variant is held against the plain version
(two units of bf16's last place at the largest output) and timed in turns
(A B C C B A), each call on its own cold operands; prints the card's name
and power limit first, ptxas' registers and spills of each variant's
kernels, a line per layer and variant (grid, splits, ms of both turns)
and the sums over each network's calls.  About 60 s.

    PYTHONPATH=src python scripts/winograd16_variants.py [--parent DIR]

``DIR`` is the root of an earlier checkout (``git archive <commit> | tar
-x -C DIR``); its entry points are called with the signatures they had
before the split (the fused kernel without a workspace and split count).
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

from repro_torch.configs import vgg16, yolov3
from repro_torch.core.conv_spec import ConvAlgorithm
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.core.winograd import split_transformed, transform_weights
from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels.winograd.ops import (
    _ARGTYPES_16,
    _TUPLE_ARGTYPES_16,
    FUSED_BLOCKS_16,
    call_splits_16,
)
from repro_torch.kernels.winograd.ref import (
    fused_winograd16_ref,
    tuple_multiply16_ref,
)
from repro_torch.util import device_ms

REPO = Path(__file__).resolve().parents[1]
CSRC = Path("winograd") / "csrc"
SHARED = Path("csrc")
OUT = _build.BUILD_DIR.parent / "winograd16_variants"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: The fused kernel's C entry before the split: no workspace, no splits.
PARENT_FUSED_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]
# Edits of winograd_fused_16.cu for the diagnostics: (old text, new text).
PRODUCTS = ("""        hm::mma16<T>(acc[g][ni], al, bh[pr][e], bh[pr][e + 1]);
        hm::mma16<T>(acc[g][ni], ah, bl[pr][e], bl[pr][e + 1]);
        hm::mma16<T>(acc[g][ni], ah, bh[pr][e], bh[pr][e + 1]);
""", """        acc[g][ni][0] += __uint_as_float(al[0] ^ ah[1] ^ bh[pr][e] ^
                                         bl[pr][e + 1]);
""")
U_COPIES = [("    for (int j = 0; j < STAGES && j < n_it; ++j) issue(j);\n",
             "    ;\n"),
            ("      hp::mbar_wait(&full[s], (it / STAGES) & 1);\n", ""),
            ("          issue(it + STAGES);\n", "")]
V_STORES = ("""        *reinterpret_cast<T*>(slot) = vh;
        *reinterpret_cast<T*>(slot + V_PART) =
            hm::from_f32<T>(v[a] - hm::to_f32(vh));
""", """        if (v[a] == 12345.f) *reinterpret_cast<T*>(slot) = vh;
""")
BARRIER = ("""    // V is whole for every warp.
    hp::bar_sync(1, THREADS);
""", "")
# name -> (nvcc flags, edits)
FUSED = {"as built": ([], []), "unsplit": ([], []), "2 splits": ([], []),
         "no products": ([], [PRODUCTS]), "no U copies": ([], U_COPIES),
         "no V stores": ([], [V_STORES]),
         "one barrier a chunk": ([], [BARRIER])}
TUPLE = {"as built": ([], []),
         "one item a block": (["-DTM16_PERSISTENT=0"], [])}
#: Variants with a piece of the work left out: wrong results, their error
#: printed and not gated.
DIAGNOSTIC = {"no products", "no U copies", "no V stores",
              "one barrier a chunk"}
TOL = 2.0 ** -6                     # bf16: two units of the last place


def build(variants: dict, source: str, parent: Path | None) -> dict:
    """name -> library of ``source`` (a file of kernels/winograd/csrc), one
    nvcc per variant, all at once; ``parent`` adds "parent", built from
    that tree's sources.  Prints ptxas' register and spill lines."""
    jobs = {name: (_build._KERNELS_DIR, *v) for name, v in variants.items()}
    if parent is not None:
        jobs["parent"] = (parent / _build._KERNELS_DIR.relative_to(REPO), [],
                          [])
    procs = {}
    for i, (name, (root, flags, edits)) in enumerate(jobs.items()):
        d = OUT / f"{Path(source).stem}_v{i}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(root / CSRC, d)
        for header in (root / SHARED).glob("*.cuh"):
            shutil.copy(header, d / header.name)
        text = (d / source).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found "
                                   f"once in {source}")
            text = text.replace(old, new)
        (d / source).write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
             str(d / "lib.so"), str(d / source)], cwd=d,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} {name!r}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and (
                    "fused_kernel" in entry or "tuple_multiply" in entry):
                print(f"  ptxas {source} {name} {entry[-60:]}: "
                      f"{line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


#: The cells whose Winograd calls are timed: (model, what is timed).
CELLS = {"vgg16 224 b1": (vgg16.MODEL, ("fused", "tuple_multiply")),
         "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, ("fused",)),
         "yolov3-20 608 b1": (yolov3.MODEL_20, ("fused",))}


def winograd_layers(model):
    """(T, C, O) of a network's Winograd layers at batch 1 in bf16, C the
    padded count."""
    plan = plan_network(model.layers, *model.input_hw,
                        Planner(impl="torch", device="cpu"),
                        in_channels=model.in_channels, batch=1,
                        dtype="bfloat16")
    return [(-(-s.out_hw[0] // 6) * -(-s.out_hw[1] // 6),
             s.in_layout.phys_c, s.spec.out_channels)
            for s in plan.steps if s.layer.kind == "conv"
            and s.plan.algorithm is ConvAlgorithm.WINOGRAD]


def cold_ms(fn, args) -> float:
    """Device ms per call, each call on its own copy of ``args`` (the
    copies together exceed twice the L2), median of 3 rounds."""
    size = sum(a.numel() * a.element_size() for a in args)
    copies = [tuple(a.clone() for a in args)
              for _ in range(max(4, 2 * H100.l2_bytes // size + 1))]
    calls = [lambda c=c: fn(*c) for c in copies]
    fn(*copies[0])
    return statistics.median(device_ms(calls) for _ in range(3))


def fused_fn(lib, name):
    """The variant's fused call on (tiles, U hi+lo, inv_scale, bias)."""
    parent = name == "parent"
    fn = lib.repro_winograd16_fused
    fn.argtypes = PARENT_FUSED_ARGTYPES if parent else _ARGTYPES_16
    fn.restype = ctypes.c_int
    bt, _, bo = FUSED_BLOCKS_16

    def call(tiles, hl, inv, bias):
        t, c, o = tiles.shape[0], tiles.shape[-1], hl.shape[-1]
        out = torch.empty((t, 6, 6, o), device="cuda", dtype=tiles.dtype)
        stream = torch.cuda.current_stream().cuda_stream
        if parent:
            err = fn(tiles.data_ptr(), hl.data_ptr(), inv.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), t, c, o, bt, bo, 1, 0,
                     stream)
        else:
            splits = {"unsplit": 1, "2 splits": min(2, -(-c // 16))}.get(
                name, call_splits_16(t, c, o))
            ws = (torch.empty((splits, t, 6, 6, o), device="cuda")
                  if splits > 1 else None)
            err = fn(tiles.data_ptr(), hl.data_ptr(), inv.data_ptr(),
                     bias.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(), t, c, o, bt, bo,
                     1, splits, 0, stream)
        _build.check(err, f"fused variant {name}")
        return out
    return call


def tuple_fn(lib, name):
    """The variant's tuple multiply on (V, U hi+lo, inv_scale)."""
    fn = lib.repro_winograd16_tuple_multiply
    fn.argtypes, fn.restype = _TUPLE_ARGTYPES_16, ctypes.c_int

    def call(v, u2, inv):
        _, t, c = v.shape
        o = u2.shape[-1]
        m = torch.empty((64, t, o), device="cuda", dtype=v.dtype)
        err = fn(v.data_ptr(), u2.data_ptr(), inv.data_ptr(), m.data_ptr(),
                 t, c, o, 0, torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"tuple multiply variant {name}")
        return m
    return call


def in_turns(kind, fns, args, ref, label, sums):
    """Each variant held against ``ref`` and timed in turns (A B .. B A)."""
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        got = fns[name](*args)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = TOL * max(1.0, float(ref.float().abs().max()))
        if name not in DIAGNOSTIC and not (
                bool(torch.isfinite(got).all()) and err <= tol):
            raise AssertionError(f"{kind} {label} {name}: max_abs_err {err} "
                                 f"> {tol}")
        times[name].append(cold_ms(fns[name], args))
    for name, ms in times.items():
        sums[name] = sums.get(name, 0.0) + sum(ms) / 2
        print(f"{kind} {label} {name}: ms {ms[0]:.4f} {ms[1]:.4f}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="root of an earlier checkout whose kernels to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fused_libs = build(FUSED, "winograd_fused_16.cu", args.parent)
    tuple_libs = build(TUPLE, "winograd_3pass_16.cu", args.parent)
    fused = {n: fused_fn(lib, n) for n, lib in fused_libs.items()}
    tuples = {n: tuple_fn(lib, n) for n, lib in tuple_libs.items()}
    g = torch.Generator().manual_seed(0)
    dt = torch.bfloat16
    for cell, (model, kinds) in CELLS.items():
        sums = {kind: {} for kind in kinds}
        layers = winograd_layers(model)
        for t, c, o in layers:
            bt, _, bo = FUSED_BLOCKS_16
            grid = -(-t // bt) * -(-o // bo)
            label = (f"{cell} T={t} C={c} O={o} grid={grid} "
                     f"splits={call_splits_16(t, c, o)}")
            w = torch.randn(3, 3, c, o, generator=g) * (9 * c) ** -0.5
            u = split_transformed(transform_weights(w).cuda(), dt)
            tiles = torch.randn(t, 8, 8, c, generator=g).to(dt).cuda()
            bias = torch.randn(o, generator=g).cuda()
            ref = fused_winograd16_ref(tiles, u.hl, u.inv_scale, bias, "relu")
            in_turns("fused", fused, (tiles, u.hl, u.inv_scale, bias), ref,
                     label, sums["fused"])
            if "tuple_multiply" not in kinds:
                continue
            v = torch.randn(64, t, c, generator=g).to(dt).cuda()
            u2 = u.hl.reshape(2, 64, c, o)
            in_turns("tuple_multiply", tuples, (v, u2, u.inv_scale),
                     tuple_multiply16_ref(v, u2, u.inv_scale),
                     f"{cell} T={t} C={c} O={o}", sums["tuple_multiply"])
        for kind, by_variant in sums.items():
            print(f"sum over {cell}'s {len(layers)} calls, {kind}: "
                  + ", ".join(f"{n} {ms:.4f} ms"
                              for n, ms in by_variant.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

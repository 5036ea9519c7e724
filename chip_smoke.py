#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each on its own printed lines:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   and the card's reported properties beside ``repro_torch.hw.H100``;
2. build every CUDA kernel of the port with nvcc (one process per source,
   all at once) and print the build seconds and ptxas' register counts;
3. each kernel against its plain PyTorch version at every shape the model
   cells below give it (YOLOv3-tiny at 416x416, batch 1 and 4; MODEL_20 at
   608x608, batch 1; VGG-16 at 224x224, batch 1, with the fused Winograd
   kernel and with the 3-pass pipeline; the int8 plans of YOLOv3-tiny 416,
   VGG-16 224 and MODEL_20 608 at batch 1, on seeded int8 operands): the
   max-abs error of every call.
   At the shapes of YOLOv3-tiny at batch 1 (GEMM, im2col, fused Winograd)
   and of VGG-16's Winograd layers (fused, and the three 3-pass kernels),
   also the kernel's, the plain version's and one library call's device
   time per call (``cuda_ms``: runs of launches, each between one event
   pair, each launch on its own cold operands), and the least time the card
   could take (bytes over 3.35 TB/s or FLOPs over the 67 TFLOP/s fp32
   peak, whichever is larger), counted for the logical operands, before
   the channel padding the kernels take; the same at the int8 plan of
   YOLOv3-tiny b1 for the two int8 kernels, with int8 operations over the
   1979 TOP/s int8 peak, bytes of int8 operands and fp32 output, scale and
   bias, and ``torch._int_mm`` plus the epilogue as the GEMM's library call
   (no PyTorch call computes an int8 convolution); then, per VGG-16
   Winograd layer, the fused kernel's time beside the 3-pass pipeline's;
4. YOLOv3-tiny at 416x416, batch 1 and 4, through ``repro_torch.compile``
   with ``impl='cuda'``, held against ``impl='torch'`` on the card; each
   kernel's launch count in one forward must equal the plan's count
   (``NetworkPlan.kernel_launches``); ms per forward and images/s; a
   profiler breakdown of the batch-1 forward by CUDA kernel, with the
   device's idle share of the forward;
5. the first 20 layers of Darknet-53 (MODEL_20) at 608x608, batch 1: the
   same comparison (stride-2 im2col, shortcut);
6. VGG-16 at 224x224, batch 1, three forwards: the default (fused
   Winograd), ``winograd_fused=False`` (the 3-pass pipeline on all seven
   Winograd layers) and ``mode='measure'`` (each layer's candidates timed
   on the card; its per-layer choice printed), each the same comparison
   and each profiled; then every kernel call of the measure-mode plan held
   against its plain version, as in phase 3;
7. int8 (``dtype='int8'``): YOLOv3-tiny 416 b1 and MODEL_20 608 b1
   (both profiled, beside their fp32 forwards) and VGG-16 224 b1, each
   with identity batchnorm and calibrated on its input: every step of the
   cuda forward against the plain step fed the same input
   (``check_steps``), the output against ``impl='torch', dtype='int8'``
   (an SQNR of at least 40 dB; printed only for MODEL_20) and against the
   fp32 CUDA forward of the same weights (at least 30 dB), the int8
   kernels' launches equal to the plan's, ms per forward and images/s
   beside the fp32 forward's; then, printed and not gated, the same two
   SQNRs of YOLOv3-tiny and VGG-16 with random batchnorm and the default
   calibration batch (``deployment_sqnr``);
8. one JSON line with every kernel's numbers — its launches in the forward
   its ``cell`` names (YOLOv3-tiny 416 b1 for the GEMM, im2col and fused
   Winograd kernels, VGG-16 224 b1 with ``winograd_fused=False`` for the
   three 3-pass kernels, YOLOv3-tiny 416 b1 int8 for the two int8
   kernels), and its times, errors and bounds summed over the calls of
   that forward — then the last line ``{"ok": true, "device": ...}``.

Any failure raises and exits non-zero before the last line is printed.  It
exits 1 at once when no CUDA device is visible, and fails to import the
port when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
ROUNDS = 5                # timed runs of launches per kernel measurement
FORWARD_REPS = 20         # timed forwards of the main cells
SHORT_FORWARD_REPS = 10   # YOLOv3-tiny b4 and MODEL_20, to keep to the time
# The int8 kernels sum exactly in int32, as their plain versions do; only
# the fp32 epilogue could differ (FMA contraction, which the kernels avoid).
KERNEL_TOL = {"gemm": 1e-4, "im2col_conv": 1e-4, "winograd_fused": 5e-4,
              "input_transform": 5e-4, "tuple_multiply": 1e-4,
              "output_transform": 5e-4, "gemm_q8": 1e-5,
              "im2col_conv_q8": 1e-5}
# Whole-network tolerance, relative to max|ref|: both impls run fp32 on the
# same card with the same layouts; they differ only in the order of the sums
# inside each kernel (and, in measure mode, in the algorithm a layer takes),
# which compounds over the network's depth.
NET_RTOL = 1e-3
# int8 networks.  Step by step, each step of the impl='cuda' forward, fed
# that forward's own input, against the impl='torch' step on the same
# input: int8 steps and the layers between convs exactly as their kernels'
# tolerance says, fp32 steps at theirs.  End to end, against the
# impl='torch' forward (the same integer sums, but an fp32 layer before an
# int8 one sums in another order, so a value near a quantization step may
# round the other way, and such flips compound over the int8 layers), and
# against the fp32 forward of the same weights (the reference's
# acceptance gate).
INT8_VS_PLAIN_DB = 40.0
INT8_VS_FP32_DB = 30.0

REPLACES = {
    "gemm": "src/repro/kernels/gemm/kernel.py:140",
    "gemm_q8": "src/repro/kernels/gemm/kernel.py:107-137",
    "im2col_conv": "src/repro/kernels/im2col_gemm/kernel.py:162",
    "im2col_conv_q8": "src/repro/kernels/im2col_gemm/kernel.py:97-159",
    "winograd_fused": "src/repro/kernels/winograd/kernel.py:143",
    "input_transform": "src/repro/kernels/winograd/kernel.py:195",
    "tuple_multiply": "src/repro/kernels/winograd/kernel.py:216",
    "output_transform": "src/repro/kernels/winograd/kernel.py:244",
}
SOURCE = {"gemm": "gemm", "im2col_conv": "im2col_conv",
          "gemm_q8": "gemm_q8", "im2col_conv_q8": "im2col_conv_q8",
          "winograd_fused": "winograd_fused",
          "input_transform": "winograd_3pass",
          "tuple_multiply": "winograd_3pass",
          "output_transform": "winograd_3pass"}
# The CUDA function of each kernel, as the profiler names it.
CUDA_NAMES = {"gemm": "gemm_bias_act_kernel",
              "gemm_q8": "gemm_q8_bias_act_kernel",
              "im2col_conv": "im2col_conv_kernel",
              "im2col_conv_q8": "im2col_conv_q8_kernel",
              "winograd_fused": "winograd_fused_kernel",
              "input_transform": "winograd_input_transform_kernel",
              "tuple_multiply": "winograd_tuple_multiply_kernel",
              "output_transform": "winograd_output_transform_kernel"}


def log(*parts) -> None:
    print(*parts, flush=True)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, args, rounds: int = ROUNDS) -> float:
    """Median device milliseconds per call of ``fn(*args)``.

    Each round times the calls in runs, each between one pair of CUDA
    events, with the host's launches hidden behind a hold of the stream
    (``repro_torch.util.device_ms``).  Every call of the run gets its own
    copy of ``args``, and the copies together exceed twice the 50 MB L2, so
    each call finds its operands cold, as a layer of a forward finds its
    weights.
    """
    from repro_torch.hw import H100
    from repro_torch.util import device_ms

    n = max(4, -(-2 * H100.l2_bytes // max(1, nbytes(args))) + 1)
    copies = [tuple(a.clone() for a in args) for _ in range(n)]
    fn(*copies[0])                                  # build, warm the allocator
    calls = [lambda c=c: fn(*c) for c in copies]
    return statistics.median(device_ms(calls) for _ in range(rounds))


def reset_counts() -> None:
    from repro_torch.kernels.conv_ops import kernel_wrappers

    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    """Launches per kernel since the last reset, kernels never launched
    left out."""
    from repro_torch.kernels.conv_ops import kernel_wrappers

    return {k: fn.launches for k, fn in kernel_wrappers().items()
            if fn.launches}


# ---------------------------------------------------------------------------
# Phase 3: kernel calls at the main paths' shapes


def kernel_cases(netplan, rng, hw, cell, winograd_only=False):
    """One case per kernel call of one forward of ``netplan``: the kernel's
    name, the conv step, a label, the call's operands and closures for the
    kernel (and, with ``impl='torch'``, its plain version) and for one
    library call on the logical operands, plus the work the call must do.

    Inputs are made at the conv's logical in-channels and zero-padded to
    the step's physical layout, as the path hands them to the kernel; the
    library call and the bound see the logical operands: the function the
    call computes, not the padding the kernel takes.  The 3-pass stages
    are chained: V is the plain input transform of the step's tiles, M the
    plain product of V and U."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.conv_spec import ConvAlgorithm, apply_activation
    from repro_torch.core.winograd import AT, BT, _const, _tile_input, \
        transform_weights
    from repro_torch.kernels.gemm.ops import matmul_bias_act, matmul_q8_bias_act
    from repro_torch.kernels.im2col_gemm.ops import im2col_conv, im2col_conv_q8
    from repro_torch.kernels.winograd.ops import (
        fused_winograd,
        input_transform,
        output_transform,
        tuple_multiply,
    )
    from repro_torch.kernels.winograd.ref import (
        input_transform_ref,
        tuple_multiply_ref,
    )

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device="cuda")

    def q8(*shape):
        return torch.tensor(rng.integers(-127, 128, shape).astype(np.int8),
                            device="cuda")

    def dequant(o):
        """A dequant row of the size calibration gives (about 1e-3)."""
        return torch.tensor(rng.uniform(0.5, 2.0, o).astype(np.float32) * 1e-3,
                            device="cuda")

    def pad_to(v, shape):
        """Zero-pad ``v`` up to ``shape`` (the padding ``torch._int_mm``
        needs: K and N multiples of 8)."""
        return F.pad(v, [p for d, n in zip(reversed(v.shape), reversed(shape))
                         for p in (0, n - d)]).contiguous()

    cases = []
    b = netplan.batch

    def pad_c(v, dim):
        """Zero-pad dimension ``dim`` of ``v`` from ``c`` to ``phys_c``."""
        extra = phys_c - c
        if not extra:
            return v
        shape = list(v.shape)
        shape[dim] = extra
        return torch.cat([v, v.new_zeros(shape)], dim=dim).contiguous()

    for s in netplan.steps:
        if s.layer.kind != "conv":
            continue
        algo = s.plan.algorithm
        if winograd_only and algo is not ConvAlgorithm.WINOGRAD:
            continue
        spec, act, blocks = s.spec, s.layer.activation, s.plan.kernel_blocks
        (h, w), (oh, ow) = s.in_hw, s.out_hw
        c, phys_c, o = spec.in_channels, s.in_layout.phys_c, spec.out_channels
        kh, kw = spec.kh, spec.kw
        bias = t(o)
        head = f"{cell} L{s.index}"
        base = dict(step=s.index, peak=hw.peak_flops_fp32)
        if s.plan.dtype == "int8":
            # int8 operands, fp32 dequant row, bias and output; the bound
            # divides by the int8 tensor-core peak.
            base["peak"], scale = hw.peak_ops_int8, dequant(o)
            m = b * oh * ow
            out_bytes = 4 * (2 * o + m * o)
            if algo is ConvAlgorithm.DIRECT:
                a, wm = q8(m, c), q8(c, o)
                k8, n8 = -(-c // 8) * 8, -(-o // 8) * 8
                cases.append(dict(
                    base, kernel="gemm_q8",
                    label=f"{head} gemm_q8 M={m} K={phys_c} N={o}",
                    args=(pad_c(a, 1), pad_c(wm, 0), scale, bias),
                    run=lambda a, wm, scale, bias, act=act, impl="cuda":
                        matmul_q8_bias_act(a, wm, scale, bias, act, impl=impl),
                    lib_args=(pad_to(a, (m, k8)), pad_to(wm, (k8, n8)), scale,
                              bias),
                    library=lambda a, wm, scale, bias, o=o, act=act:
                        apply_activation(torch._int_mm(a, wm)[:, :o].float()
                                         * scale + bias, act),
                    flops=2 * m * c * o,
                    bytes=m * c + c * o + out_bytes,
                ))
                continue
            x, wt = q8(b, h, w, c), q8(kh, kw, c, o)
            cases.append(dict(
                base, kernel="im2col_conv_q8",
                label=(f"{head} im2col_q8 {h}x{w}x{phys_c}->{oh}x{ow}x{o} "
                       f"k{kh} s{spec.stride[0]} blocks={blocks}"),
                args=(pad_c(x, 3), pad_c(wt, 2), scale, bias),
                run=lambda x, wt, scale, bias, spec=spec, blocks=blocks,
                act=act, impl="cuda": im2col_conv_q8(
                    x, wt, spec, scale, blocks, bias, act, impl=impl),
                # No single PyTorch call computes an int8 convolution.
                lib_args=None, library=None,
                flops=2 * m * o * kh * kw * c,
                bytes=b * h * w * c + kh * kw * c * o + out_bytes,
            ))
            continue
        if algo is ConvAlgorithm.DIRECT:
            m = b * oh * ow
            a, wm = t(m, c), t(c, o)
            cases.append(dict(
                base, kernel="gemm",
                label=f"{head} gemm M={m} K={phys_c} N={o}",
                args=(pad_c(a, 1), pad_c(wm, 0), bias),
                run=lambda a, wm, bias, act=act, impl="cuda":
                    matmul_bias_act(a, wm, bias, act, impl=impl),
                lib_args=(a, wm, bias),
                library=lambda a, wm, bias, act=act:
                    apply_activation(torch.addmm(bias, a, wm), act),
                flops=2 * m * c * o,
                bytes=4 * (m * c + c * o + o + m * o),
            ))
            continue
        # Both convs: the logical NHWC input and HWIO weights, read once,
        # and the output written once.
        x, wt = t(b, h, w, c), t(kh, kw, c, o)
        xp, wtp = pad_c(x, 3), pad_c(wt, 2)
        conv_bytes = 4 * (b * h * w * c + kh * kw * c * o + o + b * oh * ow * o)
        conv_lib = dict(
            lib_args=(x, wt.permute(3, 2, 0, 1).contiguous(), bias),
            library=lambda x, w_oihw, bias, spec=spec, act=act:
                apply_activation(F.conv2d(
                    x.permute(0, 3, 1, 2), w_oihw, bias, spec.stride,
                    spec.padding), act).permute(0, 2, 3, 1))
        if algo is ConvAlgorithm.IM2COL_GEMM:
            cases.append(dict(
                base, **conv_lib, kernel="im2col_conv",
                label=(f"{head} im2col {h}x{w}x{phys_c}->{oh}x{ow}x{o} "
                       f"k{kh} s{spec.stride[0]} blocks={blocks}"),
                args=(xp, wtp, bias),
                run=lambda x, wt, bias, spec=spec, blocks=blocks, act=act,
                impl="cuda": im2col_conv(x, wt, spec, blocks, bias, act,
                                         impl=impl),
                flops=2 * b * oh * ow * o * kh * kw * c,
                bytes=conv_bytes,
            ))
            continue
        tiles, _, _ = _tile_input(F.pad(xp, (0, 0, 1, 1, 1, 1)), oh, ow)
        tiles = tiles.reshape(-1, 8, 8, phys_c).contiguous()
        u = transform_weights(wtp).contiguous()
        n_t = tiles.shape[0]
        shape = f"T={n_t} C={phys_c} O={o}"
        if s.plan.winograd_fused:
            cases.append(dict(
                base, **conv_lib, kernel="winograd_fused",
                label=f"{head} winograd {shape} blocks={blocks}",
                args=(tiles, u, bias),
                run=lambda tiles, u, bias, blocks=blocks, act=act,
                impl="cuda": fused_winograd(tiles, u, blocks, bias, act,
                                            impl=impl),
                # F(6,3) at the logical C: 64 per-position products +
                # B^T d B (2048 per tile-channel) + A^T M A (1344 per
                # tile-out), the reference's count.
                flops=2 * n_t * 64 * c * o + n_t * c * 2048 + n_t * o * 1344,
                bytes=conv_bytes,
            ))
            continue
        # The 3-pass stages, each with its own reads and writes of V and M.
        bt_m, at_m = _const(BT, tiles), _const(AT, tiles)
        v = input_transform_ref(tiles).reshape(64, n_t, phys_c).contiguous()
        u64 = u.reshape(64, phys_c, o)
        mm = tuple_multiply_ref(v, u64).reshape(8, 8, n_t, o).contiguous()
        cases.append(dict(
            base, kernel="input_transform",
            label=f"{head} input_transform {shape}",
            args=(tiles,),
            run=lambda tiles, impl="cuda": input_transform(tiles, impl=impl),
            lib_args=(tiles[..., :c].contiguous(),),
            library=lambda d, bt_m=bt_m:
                torch.einsum("ai,bj,tijc->abtc", bt_m, bt_m, d),
            flops=2048 * n_t * c,
            bytes=4 * 2 * 64 * n_t * c,
        ))
        cases.append(dict(
            base, kernel="tuple_multiply",
            label=f"{head} tuple_multiply {shape} blocks={blocks}",
            args=(v, u64),
            run=lambda v, u, impl="cuda": tuple_multiply(v, u, impl=impl),
            lib_args=(v[..., :c].contiguous(), u64[:, :c].contiguous()),
            library=torch.bmm,
            flops=2 * 64 * n_t * c * o,
            bytes=4 * 64 * (n_t * c + c * o + n_t * o),
        ))
        cases.append(dict(
            base, kernel="output_transform",
            label=f"{head} output_transform {shape} act={act}",
            args=(mm, bias),
            run=lambda m, bias, act=act, impl="cuda":
                output_transform(m, bias, act, impl=impl),
            lib_args=(mm, bias),
            library=lambda m, bias, at_m=at_m, act=act: apply_activation(
                torch.einsum("xa,yb,abto->txyo", at_m, at_m, m) + bias, act),
            flops=1344 * n_t * o,
            bytes=4 * (64 * n_t * o + o + 36 * n_t * o),
        ))
    return cases


def check_kernels(netplan, rng, hw, cell, timed=(), winograd_only=False):
    """Phase 3: every kernel call of one forward held against its plain
    version; the calls of the kernels named in ``timed`` also timed.
    Returns the timed calls' sums per kernel, and their ms per conv step
    and kernel."""
    import torch

    summary, per_step = {}, {}
    t0, n = time.perf_counter(), 0
    for case in kernel_cases(netplan, rng, hw, cell, winograd_only):
        n += 1
        name, args = case["kernel"], case["args"]
        got = case["run"](*args)
        ref = case["run"](*args, impl="torch")
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        tol = KERNEL_TOL[name] * scale
        if not (bool(torch.isfinite(got).all()) and got.shape == ref.shape
                and err <= tol):
            raise AssertionError(
                f"{case['label']}: kernel disagrees with its plain version:"
                f" max_abs_err {err} > {tol}"
            )
        if name not in timed:
            log(f"kernel {case['label']}: max_abs_err={err:.3g} (tol {tol:.3g})")
            continue
        ms = cuda_ms(case["run"], args)
        plain_ms = cuda_ms(lambda *a, run=case["run"]: run(*a, impl="torch"),
                           args)
        library_ms = (cuda_ms(case["library"], case["lib_args"])
                      if case["library"] is not None else None)
        t_ops = case["flops"] / case["peak"] * 1e3
        t_bytes = case["bytes"] / hw.hbm_bandwidth * 1e3
        bound_ms = max(t_ops, t_bytes)
        log(f"kernel {case['label']}: max_abs_err={err:.3g} (tol {tol:.3g})"
            f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            + ("-" if library_ms is None else f"{library_ms:.4f}")
            + f" bound_ms={bound_ms:.5f} "
            f"({'operations' if t_ops >= t_bytes else 'bytes'})")
        agg = summary.setdefault(name, dict(
            calls=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
            bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0))
        agg["calls"] += 1
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["library_ms"] = (None if library_ms is None or agg["library_ms"]
                             is None else agg["library_ms"] + library_ms)
        agg["bound_ms"] += bound_ms
        agg["ops_ms" if t_ops >= t_bytes else "bytes_ms"] += bound_ms
        per_step.setdefault(case["step"], {})[name] = ms
    log(f"kernels {cell}: {n} calls checked in "
        f"{time.perf_counter() - t0:.1f} s")
    return summary, per_step


# ---------------------------------------------------------------------------
# Phases 4 to 6: whole networks


def forward_ms(fn, reps: int) -> float:
    """Host milliseconds per call of ``fn`` over ``reps`` calls that end in
    a synchronize, after three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def check_steps(compiled, plain, x, name) -> None:
    """Every step of ``compiled``'s forward on ``x`` against ``plain``'s
    step on the same input (the cuda forward's own activation), the
    forward continuing with the cuda step's output: a conv step within its
    kernels' tolerance of ``max(1, max|ref|)``, any other step equal.
    Also prints, after each conv step, the SQNR between the two forwards
    each run on its own outputs, which shows where they drift apart."""
    import torch

    from repro_torch.core.netplan import run_step
    from repro_torch.core.quant import sqnr_db
    from repro_torch.kernels.conv_ops import plan_kernels

    ex, ex_plain = compiled.executor(int(x.shape[0])), plain.executor(
        int(x.shape[0]))
    outputs, outputs_plain, cur, cur_plain = [], [], x, x
    worst, drift = {}, []
    with torch.inference_mode():
        for s, sp in zip(ex.netplan.steps, ex_plain.netplan.steps):
            y = run_step(s, ex.params[s.index], cur, outputs,
                         ex.pretransformed[s.index])
            ref = run_step(sp, ex_plain.params[s.index], cur, outputs,
                           ex_plain.pretransformed[s.index])
            cur_plain = run_step(sp, ex_plain.params[s.index], cur_plain,
                                 outputs_plain, ex_plain.pretransformed[s.index])
            err = float((y - ref).abs().max())
            tol = 0.0
            if s.layer.kind == "conv":
                tol = max(KERNEL_TOL[k] for k in plan_kernels(s.plan)) * max(
                    1.0, float(ref.abs().max()))
                worst[s.plan.dtype] = max(worst.get(s.plan.dtype, 0.0), err)
                drift.append(f"{s.index}:{sqnr_db(cur_plain, y):.1f}")
            if not (bool(torch.isfinite(y).all()) and err <= tol):
                raise AssertionError(
                    f"{name} step {s.index} ({s.layer.kind}"
                    f"{'' if s.plan is None else ' ' + s.plan.label}): cuda vs"
                    f" torch on the same input max_abs_err {err} > {tol}")
            outputs.append(y)
            outputs_plain.append(cur_plain)
            cur = y
    log(f"steps {name}: every step matches its plain version on the cuda "
        f"forward's own input; max_abs_err by conv dtype {worst}; "
        f"free-running SQNR (dB) after each conv: {' '.join(drift)}")


def run_cell(model, batch, rng, params=None, options=None, name=None,
             profile=False, reps=FORWARD_REPS,
             min_sqnr_vs_plain=INT8_VS_PLAIN_DB):
    """Compile ``model`` with ``options`` and with ``impl='torch'``, drive
    the cuda one once with counts at zero, compare, and time.  Returns the
    launch counts of that forward and the compiled model.

    Under ``dtype='int8'`` both compilations calibrate on the cell's input
    (made from the seed with numpy); every step is held against its plain
    version on the same input (``check_steps``); the output is held at an
    SQNR of at least ``min_sqnr_vs_plain`` against the plain forward (None:
    printed only) and at ``INT8_VS_FP32_DB`` against the fp32 CUDA forward
    of the same weights, whose time is printed beside the int8 one (and
    which is profiled too when ``profile`` is set)."""
    import torch

    import repro_torch
    from repro_torch.core.quant import sqnr_db
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    options = dict(options or {})
    int8 = options.get("dtype") == "int8"
    name = name or f"{model.name} {model.input_hw[0]} b{batch}"
    # Seeded weights with random batchnorm statistics, so folding is
    # exercised.
    if params is None:
        params = random_batchnorm(init_cnn(rng, model.layers), rng)
    h, w = model.input_hw
    x = torch.tensor(
        rng.standard_normal((batch, h, w, model.in_channels)).astype(np.float32),
        device="cuda")
    calibration = x if int8 else None
    t0 = time.perf_counter()
    cu = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        batch=batch, **options), calibration=calibration)
    compile_s = time.perf_counter() - t0
    plain = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cuda", batch=batch,
        dtype=options.get("dtype", "float32")), calibration=calibration)

    reset_counts()
    y = cu.run(x)
    torch.cuda.synchronize()
    counts = read_counts()

    want = cu.network_plan(batch).kernel_launches()
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != planned {want}")
    y_ref = plain.run(x)
    torch.cuda.synchronize()
    scale = float(y_ref.abs().max())
    err = float((y - y_ref).abs().max())
    ok = bool(torch.isfinite(y).all()) and y.shape == y_ref.shape
    fp32 = None
    if int8:
        check_steps(cu, plain, x, name)
        quality = sqnr_db(y_ref, y)
        if not (ok and (min_sqnr_vs_plain is None
                        or quality >= min_sqnr_vs_plain)):
            raise AssertionError(f"{name}: cuda vs torch SQNR {quality:.2f} dB"
                                 f" < {min_sqnr_vs_plain} (max_abs_err {err})")
        fp32 = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
            batch=batch))
        y32 = fp32.run(x)
        vs_fp32 = sqnr_db(y32, y)
        if not vs_fp32 >= INT8_VS_FP32_DB:
            raise AssertionError(f"{name}: int8 vs fp32 SQNR {vs_fp32:.2f} dB"
                                 f" < {INT8_VS_FP32_DB}")
        fp32_ms = forward_ms(lambda: fp32.run(x), reps)
        detail = (f"sqnr_vs_plain_db={quality:.2f} sqnr_vs_fp32_db={vs_fp32:.2f}"
                  f" int8_layers={sum(r['dtype'] == 'int8' for r in cu.plan_report()['layers'])}"
                  f" fp32_ms_per_forward={fp32_ms:.3f}"
                  f" fp32_images_per_s={batch * 1e3 / fp32_ms:.1f}")
    else:
        if not (ok and err <= NET_RTOL * max(scale, 1.0)
                and torch.allclose(y, y_ref, rtol=NET_RTOL,
                                   atol=NET_RTOL * max(scale, 1.0))):
            raise AssertionError(f"{name}: cuda vs torch max_abs_err {err} "
                                 f"(max|ref| {scale})")
        detail = ""

    ms = forward_ms(lambda: cu.run(x), reps)
    plain_ms = forward_ms(lambda: plain.run(x), 5)
    log(f"model {name}: out {tuple(y.shape)} max_abs_err={err:.3g} "
        f"max|ref|={scale:.3g} launches={counts} compile_s={compile_s:.2f} "
        f"ms_per_forward={ms:.3f} images_per_s={batch * 1e3 / ms:.1f} "
        f"plain_ms_per_forward={plain_ms:.3f} {detail}".rstrip())
    if profile:
        profile_forward(cu, x, ms, name)
        if fp32 is not None:
            profile_forward(fp32, x, fp32_ms, f"{name} (its fp32 forward)")
    return counts, cu


def deployment_sqnr(model, rng, name) -> None:
    """Prints, without gating, the int8 forward's SQNR against the fp32
    forward and against the plain int8 forward, with random batchnorm
    statistics and ``compile``'s default calibration batch (seeded, two
    images, not the input): how far that setup sits from the int8 cells'
    gates, which use identity batchnorm and calibrate on the input."""
    import repro_torch
    from repro_torch.core.quant import sqnr_db
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    h, w = model.input_hw
    x = rng.standard_normal((1, h, w, model.in_channels)).astype(np.float32)
    opts = repro_torch.ExecutionOptions
    y = repro_torch.compile(model, params, opts(dtype="int8")).run(x)
    y_plain = repro_torch.compile(model, params, opts(
        impl="torch", dtype="int8")).run(x)
    y32 = repro_torch.compile(model, params, opts()).run(x)
    log(f"deployment {name}: random batchnorm, default calibration batch: "
        f"sqnr_vs_fp32_db={sqnr_db(y32, y):.2f} "
        f"sqnr_vs_plain_db={sqnr_db(y_plain, y):.2f} (printed, not gated)")


def profile_forward(compiled, x, ms_per_forward: float, name: str,
                    reps: int = 5) -> None:
    """Device time of one forward by CUDA kernel (torch.profiler), and the
    share of the measured forward time in which the device was idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            compiled.run(x)
        torch.cuda.synchronize()
    # Kernel rows only: an operator's row repeats the time of its kernels.
    rows = sorted(
        ((ev.self_device_time_total / reps, ev.count // reps, ev.key)
         for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile {name}: device busy "
        f"{busy_ms:.4f} ms per forward in {sum(r[1] for r in rows)} kernel "
        f"launches; idle share {max(0.0, 1.0 - busy_ms / ms_per_forward):.3f}"
        f" of {ms_per_forward:.3f} ms")
    for us, n, key in rows[:14]:
        log(f"  profile {us / 1e3:.4f} ms x{n} {key[:90]}")
    # Each port kernel's launches in forward order, median over the reps.
    kernels = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    for name in CUDA_NAMES.values():
        us = [ev.time_range.elapsed_us() for ev in kernels if name in ev.name]
        n = len(us) // reps
        if not n:
            continue
        per_call = [statistics.median(us[i::n]) / 1e3 for i in range(n)]
        log(f"  in forward order, {name} ms: "
            + " ".join(f"{t:.4f}" for t in per_call))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available()"
              " is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.configs import vgg16, yolov3
    from repro_torch.core.conv_spec import ConvAlgorithm
    from repro_torch.core.netplan import plan_network
    from repro_torch.core.planner import Planner
    from repro_torch.hw import H100, check_device
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    t_start = time.perf_counter()
    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"device vs hw.H100 (reported, spec): {check_device(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build every kernel, all nvcc processes at once.
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"build: {len(paths)} sources in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # Phase 3: each kernel against its plain version at every shape the
    # model cells give it; timed at YOLOv3-tiny b1's shapes and at
    # VGG-16's Winograd layers.
    rng = np.random.default_rng(SEED)
    tiny_cell, vgg3_cell = "yolov3-tiny 416 b1", "vgg16 224 b1 winograd_fused=False"
    tiny8_cell = "yolov3-tiny 416 b1 int8"

    def netplan_of(model, batch, dtype="float32", **planner):
        return plan_network(model.layers, *model.input_hw, Planner(**planner),
                            in_channels=model.in_channels, batch=batch,
                            dtype=dtype)

    summaries = {}
    summaries[tiny_cell], _ = check_kernels(
        netplan_of(yolov3.TINY_MODEL, 1), rng, H100, tiny_cell,
        timed=("gemm", "im2col_conv", "winograd_fused"))
    check_kernels(netplan_of(yolov3.TINY_MODEL, 4), rng, H100,
                  "yolov3-tiny 416 b4")
    check_kernels(netplan_of(yolov3.MODEL_20, 1), rng, H100, "yolov3-20 608 b1")
    _, fused_steps = check_kernels(
        netplan_of(vgg16.MODEL, 1), rng, H100, "vgg16 224 b1",
        timed=("winograd_fused",))
    summaries[vgg3_cell], three_steps = check_kernels(
        netplan_of(vgg16.MODEL, 1, winograd_fused=False), rng, H100, vgg3_cell,
        timed=("input_transform", "tuple_multiply", "output_transform"),
        winograd_only=True)
    for i, fused in sorted(fused_steps.items()):
        parts = three_steps[i]
        total = sum(parts.values())
        log(f"vgg16 224 b1 L{i}: fused {fused['winograd_fused']:.4f} ms, "
            f"3-pass {total:.4f} ms ("
            + " + ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f"), 3-pass / fused {total / fused['winograd_fused']:.2f}")
    # The int8 kernels: every call of the int8 plans, timed at YOLOv3-tiny
    # b1's shapes; MODEL_20's stride-2 int8 im2col with 8x8 tiles is on no
    # other cell.
    summaries[tiny8_cell], _ = check_kernels(
        netplan_of(yolov3.TINY_MODEL, 1, "int8"), rng, H100, tiny8_cell,
        timed=("gemm_q8", "im2col_conv_q8"))
    check_kernels(netplan_of(vgg16.MODEL, 1, "int8"), rng, H100,
                  "vgg16 224 b1 int8")
    check_kernels(netplan_of(yolov3.MODEL_20, 1, "int8"), rng, H100,
                  "yolov3-20 608 b1 int8")
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 4: YOLOv3-tiny end to end; batch 1 is the main path of the
    # GEMM, im2col and fused Winograd kernels.
    launches = {}
    launches[tiny_cell], _ = run_cell(yolov3.TINY_MODEL, 1, rng, profile=True)
    run_cell(yolov3.TINY_MODEL, 4, rng, reps=SHORT_FORWARD_REPS)

    # Phase 5: MODEL_20 at 608 (stride-2 im2col, shortcut).
    run_cell(yolov3.MODEL_20, 1, rng, reps=SHORT_FORWARD_REPS)

    # Phase 6: VGG-16 at 224, batch 1: fused, 3-pass (the main path of the
    # three 3-pass kernels), measure mode; one set of weights.
    params = random_batchnorm(init_cnn(rng, vgg16.MODEL.layers), rng)
    run_cell(vgg16.MODEL, 1, rng, params, profile=True)
    launches[vgg3_cell], _ = run_cell(
        vgg16.MODEL, 1, rng, params, {"winograd_fused": False}, vgg3_cell,
        profile=True)
    want = {k: 7 for k in ("input_transform", "tuple_multiply",
                           "output_transform")}
    if any(launches[vgg3_cell].get(k) != n for k, n in want.items()):
        raise AssertionError(f"{vgg3_cell}: launches {launches[vgg3_cell]}, "
                             f"want {want} of the 3-pass kernels")
    _, measured = run_cell(vgg16.MODEL, 1, rng, params, {"mode": "measure"},
                           "vgg16 224 b1 mode=measure", profile=True)
    for row in measured.plan_report()["layers"]:
        if row["source"] != "measured":
            raise AssertionError(f"measure mode: layer {row['index']} planned "
                                 f"by {row['source']}")
        log(f"measure L{row['index']} {row['in_hw'][0]}x{row['in_hw'][1]}: "
            f"chose {row['algorithm']}"
            + (f" fused={row['winograd_fused']}"
               if row["algorithm"] == ConvAlgorithm.WINOGRAD.value else "")
            + " (" + ", ".join(f"{k} {v:.4f} ms"
                               for k, v in row["measured_ms"].items()) + ")")
    # Every kernel call of the plan measure mode chose, one at a time, at
    # the kernel tolerances (phase 3 saw only the cost-mode plans).
    check_kernels(measured.network_plan(1), rng, H100,
                  "vgg16 224 b1 mode=measure")

    # Phase 7: int8 (YOLOv3-tiny 416 b1 is the main path of both int8
    # kernels), with the reference acceptance test's weights: seeded, with
    # identity batchnorm.
    int8 = {"dtype": "int8"}
    launches[tiny8_cell], _ = run_cell(
        yolov3.TINY_MODEL, 1, rng, init_cnn(rng, yolov3.TINY_LAYERS), int8,
        tiny8_cell, profile=True)
    vgg8, _ = run_cell(vgg16.MODEL, 1, rng, init_cnn(rng, vgg16.MODEL.layers),
                       int8, "vgg16 224 b1 int8")
    # Its end-to-end SQNR against the plain forward is printed, not gated:
    # with every step exact on the same input (check_steps), flips at the
    # quantization steps after its two fp32 Winograd layers compound over
    # 13 int8 layers to about 40 dB (PERF.md, section 6).
    run_cell(yolov3.MODEL_20, 1, rng, init_cnn(rng, yolov3.LAYERS_20), int8,
             "yolov3-20 608 b1 int8", profile=True, reps=SHORT_FORWARD_REPS,
             min_sqnr_vs_plain=None)
    deployment_sqnr(yolov3.TINY_MODEL, rng, tiny8_cell)
    deployment_sqnr(vgg16.MODEL, rng, "vgg16 224 b1 int8")
    for cell, counts, names in ((tiny8_cell, launches[tiny8_cell],
                                 ("gemm_q8", "im2col_conv_q8")),
                                ("vgg16 224 b1 int8", vgg8, ("im2col_conv_q8",))):
        if any(counts.get(k, 0) <= 0 for k in names):
            raise AssertionError(f"{cell}: launches {counts}, want {names}")

    # Phase 8: the kernels line, then the last line.
    kernels = []
    for cell, summary in summaries.items():
        for name, agg in summary.items():
            if launches[cell].get(name, 0) <= 0:
                raise AssertionError(f"{name} was not launched in {cell}")
            kernels.append({
                "name": name,
                "route": "cuda",
                "source": "src/repro_torch/kernels/" + _build.SOURCES[SOURCE[name]],
                "replaces": REPLACES[name],
                "cell": cell,
                "launches": launches[cell][name],
                "max_abs_err": agg["max_abs_err"],
                "ms": agg["ms"],
                "plain_ms": agg["plain_ms"],
                "bound_ms": agg["bound_ms"],
                "bound_by": ("operations" if agg["ops_ms"] >= agg["bytes_ms"]
                             else "bytes"),
                "library_ms": agg["library_ms"],
            })
    if sorted(k["name"] for k in kernels) != sorted(REPLACES):
        raise AssertionError(f"kernels line lists {[k['name'] for k in kernels]}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

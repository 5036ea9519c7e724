#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each on its own printed lines:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   and the card's reported properties beside ``repro_torch.hw.H100``;
2. build every CUDA kernel of the port with nvcc (one process per source,
   all at once) and print the build seconds and ptxas' register, spill
   and shared-memory counts;
3. each kernel against its plain PyTorch version at every shape the model
   cells below give it (YOLOv3-tiny at 416x416, batch 1 and 4; MODEL_20 at
   608x608, batch 1; VGG-16 at 224x224, batch 1, with the fused Winograd
   kernel and with the 3-pass pipeline; the int8 plans of YOLOv3-tiny 416,
   VGG-16 224 and MODEL_20 608 at batch 1, on seeded int8 operands): the
   max-abs error of every call.
   At the shapes of YOLOv3-tiny at batch 1 (GEMM, im2col, fused Winograd),
   of MODEL_20 at 608 (GEMM, fused Winograd) and of VGG-16's Winograd
   layers (fused, and the three 3-pass kernels), also the kernel's, the
   plain version's and
   one library call's device time per call (``cuda_ms``: runs of launches,
   each between one event pair, each launch on its own cold operands), and
   the least time the card could take (bytes over 3.35 TB/s or FLOPs over
   the 67 TFLOP/s fp32 peak, whichever is larger; for the GEMM, the
   tuple multiply and the fused Winograd kernel's 64 per-position
   products, which run three TF32 products per fp32 product on the
   tensor cores, 3 x FLOPs over the 495 TFLOP/s TF32 peak — the fused
   kernel's transforms over the fp32 peak beside them — with the fp32
   CUDA-core bound of all of it printed beside), counted for the logical operands,
   before the channel padding the kernels take; the same at the int8 plan of
   YOLOv3-tiny b1 for the two int8 kernels, with int8 operations over the
   1979 TOP/s int8 peak, bytes of int8 operands and fp32 output, scale and
   bias, and ``torch._int_mm`` plus the epilogue as the GEMM's library call
   (no PyTorch call computes an int8 convolution); each timed line also
   gives the kernel's time over the library call's, and each im2col (fp32
   and int8) and GEMM (fp32 and int8) line the number of split-K ranges
   the wrapper chose (``splits``); MODEL_20 608 b1 int8's int8 GEMM calls
   (large M, bytes-bound) are timed too; each timed cell's sums per
   kernel follow; then,
   per VGG-16 Winograd layer, the fused kernel's time beside the 3-pass
   pipeline's;
4. YOLOv3-tiny at 416x416, batch 1 and 4, through ``repro_torch.compile``
   with ``impl='cuda'``, held against ``impl='torch'`` on the card; ``run``
   replays the forward's CUDA graph (``repro_torch.graphs``), captured at
   its first call: that call's launch count of each kernel (counted by
   the wrappers while the graph is captured) must equal the plan's count
   (``NetworkPlan.kernel_launches``), and the replayed forward must equal
   the eager forward (``executor(b).eager``) bit for bit; the count after
   ``GRAPH_REPLAYS`` calls is that many times the plan's by construction
   (the capture's counts multiplied out, ``graphs.add_launches``); then
   the replayed and the eager forward timed in turns (eager, graph,
   graph, eager: ms per forward and images/s) and each profiled (device
   busy time and idle share; by CUDA kernel for the profiled cells); in
   every profiled forward, replayed or eager, each port kernel the plan
   launches must appear in the trace, at most as often as the plan says
   (the split-K reduce kernels of the fp32 and int8 im2col convs and of
   the fp32 and int8 GEMMs once for each call with ``splits > 1``), and
   no other port kernel: the replay's trace is what shows on the card
   that the graph launches the port's kernels (the trace may lose
   records, so the exact counts are the wrappers');
5. the first 20 layers of Darknet-53 (MODEL_20) at 608x608, batch 1: the
   same comparison (stride-2 im2col, shortcut);
6. VGG-16 at 224x224, batch 1, three forwards: the default (fused
   Winograd), ``winograd_fused=False`` (the 3-pass pipeline on all seven
   Winograd layers) and ``mode='measure'`` (each layer's candidates timed
   on the card; its per-layer choice printed), each the same comparison
   and each profiled; then every kernel call of the measure-mode plan held
   against its plain version, as in phase 3;
6b. the co-design cost model (``mode='model'``): YOLOv3-tiny 416 (batch 1
   and 4), MODEL_20 608 b1 and VGG-16 224 b1 planned by it, each the same
   comparison as in phases 4 to 6 (profiled) with every layer planned by
   the model (``source == 'cost_model'``, a modeled time) and every kernel
   call of its plan held against its plain version; measure mode on the
   three cells phase 6 did not measure, the same way; per layer, the
   model's pick and modeled ms beside measure mode's pick and, for every
   candidate measure mode timed, the model's price of that call over its
   measured ms (``model vs measure`` lines), and the fit per candidate
   kernel over all of them (median and worst predicted / measured); the
   three modes' replayed forwards timed in turns (``modes`` lines: cost,
   measure, model, then in reverse); then the plan cache (``plan cache``
   line): VGG-16 224 b1 in measure mode compiled cold into a cache file in
   a fresh temporary directory and again warm from it (0 tunes, 1 network
   hit; ``compile_s`` of both), then ``save`` and ``repro_torch.load``
   (0 tunes), whose replay equals the warm compilation's bit for bit;
7. int8 (``dtype='int8'``): YOLOv3-tiny 416 b1, VGG-16 224 b1 and
   MODEL_20 608 b1 (each profiled, beside its fp32 forward), each
   with identity batchnorm and calibrated on its input: every step of the
   cuda forward against the plain step fed the same input
   (``check_steps``), the output against ``impl='torch', dtype='int8'``
   (an SQNR of at least 40 dB; printed only for MODEL_20) and against the
   fp32 CUDA forward of the same weights (at least 30 dB), the int8
   kernels' launches equal to the plan's, ms per forward and images/s
   beside the fp32 forward's; then, printed and not gated, the same two
   SQNRs of YOLOv3-tiny and VGG-16 with random batchnorm and the default
   calibration batch (``deployment_sqnr``); then YOLOv3-tiny 416 b1 int8
   planned by the cost model's int8 gate (``mode='model'``), under the same
   gates as the first int8 cell;
7b. bf16 and fp16 (``dtype='bfloat16' | 'float16'``), on their own
   generator's draws: YOLOv3-tiny 416 b1, MODEL_20 608 b1 and VGG-16 224 b1
   (fused, and ``winograd_fused=False``), in each type: every call of the
   16-bit kernels (GEMM, im2col conv, fused Winograd, the three 3-pass
   kernels) held against its plain version within two units of the last
   place at the largest output (2^-6 of max(1, max|ref|) in bf16, 2^-9 in
   fp16), each Winograd call's distance from the fp32 kernel on the same
   values printed, timed at YOLOv3-tiny's and VGG-16's shapes (ms, plain
   ms, the library call in the 16-bit type -- ``torch.addmm``,
   ``F.conv2d``, ``torch.bmm``, einsum -- and the bound: 16-bit tensor-core
   FLOPs over 989 TFLOP/s, the Winograd products counted three times
   (fused) or twice (3-pass) for their split operands, the transforms over
   the fp32 peak, or 2 bytes an operand over 3.35 TB/s); then each cell
   end to end: ``impl='cuda'`` against ``impl='torch'`` (the same Winograd
   realization) within 2e-2 (bf16) or 5e-3 (fp16) of max(1, max|ref|), every
   step against its plain step on the cuda forward's own input
   (``check_steps``), the 16-bit kernels' launches equal to the plan's, the
   replay equal to eager, a finite output of the reference's dtype (fp32
   for VGG-16's fc head), its distance from the fp32 forward of the same
   weights printed, the 16-bit and the fp32 replayed forwards timed in
   turns (ms and images/s), and the replayed and eager forwards profiled:
   each 16-bit kernel (and its split-K reduce where a call splits) at most
   as planned, and no other port kernel; then YOLOv3-tiny 416 b1 and
   VGG-16 224 b1 in bf16 planned by the cost model (``mode='model'``, the
   16-bit kernels' own fitted constants), each checked the same way beside
   the fp32 model-mode forward, its plan and modeled conv ms printed;
8. the LM stack (``repro_torch.compile(cfg, params)`` on an LM config,
   random weights from a seeded ``torch.Generator`` on the card):
   the flash-attention kernel against its plain version at the shapes of
   the cells below, in bf16 and fp32 (Llama-3.2-1B: H 32, KV 8, hd 64,
   causal, S 4096; Gemma2-27B: H 32, KV 16, hd 128, softcap 50, S 8192,
   with and without the 4096 window; a non-causal case with a ragged Sk),
   each element within 2e-4 (fp32) or 3e-2 (bf16) of max(1, max|ref|) and
   each query row's difference within 1e-4 (fp32) or 1e-2 (bf16) of that
   row's norm, each timed beside its plain version, ``F.scaled_dot_product_attention``
   where one PyTorch call computes the case (in fp32 with TF32 off, the
   kernels of the backend that served it printed), and its bound (FLOPs
   of the unmasked pairs over the 989 TFLOP/s bf16 tensor-core peak; in
   fp32, which runs three TF32 products per fp32 product, 3 x FLOPs over
   the 495 TFLOP/s TF32 peak, with the 67 TFLOP/s CUDA-core bound printed
   beside; or bytes of q, k, v and o over 3.35 TB/s), the
   achieved TFLOP/s of those FLOPs and the time over SDPA's; the
   global Gemma2 case again with q scaled by 8, so the scores reach the
   softcap's bend (untimed; the plain version without the cap must fail
   the row gate there); then
   Llama-3.2-1B prefill at full width (16 layers, B 1, S 4096, bf16):
   ``impl='cuda'`` against ``impl='torch'`` in fp32 (within 1e-3 of
   max(1, max|ref|)) and in bf16 on the same weights (the bf16 logits'
   relative distance from the fp32 forward at most 1.25 times the plain
   bf16 forward's), exactly 16 flash launches per forward, the bf16
   forward's replay equal to its eager forward bit for bit, ms per
   forward and tokens/s of both, timed in turns, and a profile of each
   with the kernel's share (the plain reference forwards run eagerly);
   then a second shape (S 2048) captured into the same graph pool, both
   shapes' replays equal to their eager forwards, with the reserved
   memory the second capture added beside what the same graph adds in a
   pool of its own (printed);
   Gemma2-27B at full width cut to 2 layers (local, attn), B 1, S 8192:
   the same checks with 2 launches; Llama-3.2-1B serving
   (``.serve(batch_size=4, capacity=128)``, 6 requests of 8 prompt
   tokens and 12 new ones, greedy; the decode step a CUDA graph captured
   with the engine): the engine's tokens against a greedy ``decode_step``
   loop and against the same engine with its step run eagerly
   (``EagerServingEngine``), tokens/s of both; one decode step's replay
   beside the eager step, timed in turns and profiled (no port kernel in
   either trace); ``prefill_with_cache`` (the kernel) then one decode step against
   token-by-token decode (fp32 within 1e-3 of max(1, max|ref|); bf16
   printed), tokens/s; each LM cell prints its peak device memory;
9. one JSON line with every kernel's numbers — its launches in the forward
   its ``cell`` names (YOLOv3-tiny 416 b1 for the GEMM, im2col and fused
   Winograd kernels, VGG-16 224 b1 with ``winograd_fused=False`` for the
   three 3-pass kernels, YOLOv3-tiny 416 b1 int8 for the two int8
   kernels, the Llama-3.2-1B prefill for flash attention, YOLOv3-tiny 416
   b1 bfloat16 for the 16-bit GEMM, im2col and fused Winograd kernels,
   VGG-16 224 b1 with ``winograd_fused=False`` in bfloat16 for the three
   16-bit 3-pass kernels), and its times,
   errors and bounds summed over the calls of that forward — then the
   last line ``{"ok": true, "device": ...}``.

Any failure raises and exits non-zero before the last line is printed.  It
exits 1 at once when no CUDA device is visible, and fails to import the
port when run outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
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
# The int8 kernels sum exactly in int32, as their plain versions do, and
# round the fp32 epilogue as they do (no FMA contraction): held bit for
# bit, split or not.
KERNEL_TOL = {"gemm": 1e-4, "im2col_conv": 1e-4, "winograd_fused": 5e-4,
              "input_transform": 5e-4, "tuple_multiply": 1e-4,
              "output_transform": 5e-4, "gemm_q8": 0.0,
              "im2col_conv_q8": 0.0}
# The 16-bit kernels against their plain versions: both sum exact products
# of the same 16-bit operands in fp32 and round at the same points, so they
# differ only where a rounding flips: two units of the last place at the
# largest output, of max(1, max|ref|).
HALF = ("bfloat16", "float16")
KERNEL_TOL16 = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}
# A 16-bit network, impl='cuda' against impl='torch' on the card, of
# max(1, max|ref|): the reference suite's bf16 tolerance, and 4 times finer
# in fp16 (8 times finer rounding, a factor of 2 kept).
NET_TOL16 = {"bfloat16": 2e-2, "float16": 5e-3}
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
# Flash attention against its plain version, two gates.  Per element, of
# max(1, max|ref|): fp32 at the reference suite's tolerance; bf16 two units
# of bf16's last place at the largest output.  Per query row (one head's hd
# outputs), the norm of the difference over the norm of the plain row, so
# that late causal rows, whose outputs are 100 times smaller than the
# first rows', are held at their own scale: bf16 rounds each output to 8
# significant bits (at most 2^-8 of it on each side) and p before P.V (the
# kernel p = exp2(x - m), the plain version p / l, so the two round apart;
# rows of a few keys whose outputs cancel lose most): at most 0.006 of the
# row norm in scripts/flash_bf16_replay.py, a CPU replay of the kernel's
# arithmetic, where a per-element bound of 2^-6|ref| + 1e-3 fails at such
# rows and the row gate catches a 3 % error on the later rows, a dropped
# key per tile, the wrong KV head and a missing softcap.
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
FLASH_ROW_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# An LM's bf16 logits against the fp32 forward of the same weights (relative
# norm of the difference): the kernel's bf16 forward within this factor of
# the plain bf16 forward's distance.  With random weights the distance
# between any two bf16 forwards is of the order of bf16's own distance
# from fp32 (each layer's rounding is carried by the later layers), so
# bf16 against bf16 gives no tighter bound.
LM_BF16_SPREAD = 1.25
LM_REPS = 5               # timed forwards of the LM prefill cells
# Replays after which a captured forward's launch counts must be this
# many times the plan's (the first is the call that captures).
GRAPH_REPLAYS = 3

REPLACES = {
    "gemm": "src/repro/kernels/gemm/kernel.py:140",
    "gemm_q8": "src/repro/kernels/gemm/kernel.py:107-137",
    "im2col_conv": "src/repro/kernels/im2col_gemm/kernel.py:162",
    "im2col_conv_q8": "src/repro/kernels/im2col_gemm/kernel.py:97-159",
    "winograd_fused": "src/repro/kernels/winograd/kernel.py:143",
    "input_transform": "src/repro/kernels/winograd/kernel.py:195",
    "tuple_multiply": "src/repro/kernels/winograd/kernel.py:216",
    "output_transform": "src/repro/kernels/winograd/kernel.py:244",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:69",
    "gemm_16": "src/repro/kernels/gemm/kernel.py:140",
    "im2col_conv_16": "src/repro/kernels/im2col_gemm/kernel.py:162",
    "winograd_fused_16": "src/repro/kernels/winograd/kernel.py:143",
    "input_transform_16": "src/repro/kernels/winograd/kernel.py:195",
    "tuple_multiply_16": "src/repro/kernels/winograd/kernel.py:216",
    "output_transform_16": "src/repro/kernels/winograd/kernel.py:244",
}
SOURCE = {"gemm": "gemm", "im2col_conv": "im2col_conv",
          "gemm_q8": "gemm_q8", "im2col_conv_q8": "im2col_conv_q8",
          "winograd_fused": "winograd_fused",
          "input_transform": "winograd_3pass",
          "tuple_multiply": "winograd_3pass",
          "output_transform": "winograd_3pass",
          "flash_attention": "flash_attention",
          "gemm_16": "gemm_16", "im2col_conv_16": "im2col_conv_16",
          "winograd_fused_16": "winograd_fused_16",
          "input_transform_16": "winograd_3pass_16",
          "tuple_multiply_16": "winograd_3pass_16",
          "output_transform_16": "winograd_3pass_16"}
# The CUDA function of each kernel, as the profiler names it (a substring
# of it: flash attention has an fp32 and a bf16 kernel).
CUDA_NAMES = {"gemm": "gemm_bias_act_kernel",
              "gemm_q8": "gemm_q8_bias_act_kernel",
              "im2col_conv": "im2col_conv_kernel",
              "im2col_conv_q8": "im2col_conv_q8_kernel",
              "winograd_fused": "winograd_fused_kernel",
              "input_transform": "winograd_input_transform_kernel",
              "tuple_multiply": "winograd_tuple_multiply_kernel",
              "output_transform": "winograd_output_transform_kernel",
              "flash_attention": "flash_attention",
              "gemm_16": "hgemm16_bias_act_kernel",
              "im2col_conv_16": "im2col16_conv_kernel",
              "winograd_fused_16": "winograd16_fused_kernel",
              "input_transform_16": "winograd16_input_transform_kernel",
              "tuple_multiply_16": "winograd16_tuple_multiply_kernel",
              "output_transform_16": "winograd16_output_transform_kernel"}
# The second kernels of the fp32, 16-bit and int8 im2col convs and GEMMs,
# launched by the calls that split K.  No name here or in CUDA_NAMES holds
# another as a substring.
SPLITK_REDUCE = "im2col_conv_splitk_reduce_kernel"
Q8_SPLITK_REDUCE = "im2col_conv_q8_splitk_reduce_kernel"
GEMM_SPLITK_REDUCE = "gemm_splitk_reduce_kernel"
GEMM_Q8_SPLITK_REDUCE = "gemm_q8_splitk_reduce_kernel"
SPLITK16_REDUCE = "im2col16_conv_splitk_reduce_kernel"
GEMM16_SPLITK_REDUCE = "hgemm16_splitk_reduce_kernel"
REDUCE_NAMES = (SPLITK_REDUCE, Q8_SPLITK_REDUCE, GEMM_SPLITK_REDUCE,
                GEMM_Q8_SPLITK_REDUCE, SPLITK16_REDUCE, GEMM16_SPLITK_REDUCE)


def kernel_tol(name, dtype):
    """The tolerance of kernel ``name``'s calls in ``dtype``, of max(1,
    max|ref|)."""
    return KERNEL_TOL16[dtype] if dtype in HALF else KERNEL_TOL[name]


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
    from repro_torch.graphs import launch_counters

    for fn in launch_counters().values():
        fn.launches = 0


def read_counts():
    """Launches per kernel since the last reset, kernels never launched
    left out."""
    from repro_torch.graphs import launch_counters

    return {k: fn.launches for k, fn in launch_counters().items()
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
    from repro_torch.kernels.gemm.ops import call_splits as gemm_splits
    from repro_torch.kernels.gemm.ops import (
        call_splits_q8 as gemm_splits_q8,
        matmul_bias_act,
        matmul_q8_bias_act,
    )
    from repro_torch.kernels.im2col_gemm.ops import (
        call_splits,
        call_splits_q8,
        im2col_conv,
        im2col_conv_q8,
    )
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
        # The GEMM and the tuple multiply run three TF32 products per fp32
        # product on the tensor cores: their bound divides 3 x FLOPs by the
        # TF32 peak, with the fp32 CUDA-core bound printed beside it.
        tensor_core = dict(step=s.index, peak=hw.peak_flops_tf32 / 3,
                           cuda_core_peak=hw.peak_flops_fp32)
        if s.plan.dtype in HALF:
            cases += half_cases(s, t, pad_c, bias, head, hw, b, act)
            continue
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
                    label=(f"{head} gemm_q8 M={m} K={phys_c} N={o} "
                           f"splits={gemm_splits_q8(m, o, phys_c)}"),
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
                       f"k{kh} s{spec.stride[0]} blocks={blocks} splits="
                       f"{call_splits_q8(b, oh, ow, phys_c, o, blocks[0])}"),
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
                tensor_core, kernel="gemm",
                label=(f"{head} gemm M={m} K={phys_c} N={o} "
                       f"splits={gemm_splits(m, o, phys_c)}"),
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
                       f"k{kh} s{spec.stride[0]} blocks={blocks} splits="
                       f"{call_splits(b, oh, ow, phys_c, o, blocks[0])}"),
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
            # F(6,3) at the logical C: 64 per-position products, 3xTF32 on
            # the tensor cores, + B^T d B (2048 per tile-channel) + A^T M A
            # (1344 per tile-out) on the fp32 CUDA cores, the reference's
            # count; the fp32 CUDA-core bound of all of it printed beside.
            products = 2 * n_t * 64 * c * o
            transforms = n_t * c * 2048 + n_t * o * 1344
            cases.append(dict(
                tensor_core, **conv_lib, kernel="winograd_fused",
                label=f"{head} winograd {shape} blocks={blocks}",
                args=(tiles, u, bias),
                run=lambda tiles, u, bias, blocks=blocks, act=act,
                impl="cuda": fused_winograd(tiles, u, blocks, bias, act,
                                            impl=impl),
                flops=products, flops_fp32=transforms,
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
            tensor_core, kernel="tuple_multiply",
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


def half_cases(s, t, pad_c, bias, head, hw, b, act):
    """``kernel_cases`` of one conv step of a bf16 or fp16 plan: 16-bit
    operands (weights scaled by 1 / sqrt(fan-in), so outputs stay near 1),
    the fp32 bias, the 16-bit kernels.  The bound divides the operations
    on the tensor cores by the dense 16-bit peak (989 TFLOP/s) -- the
    Winograd products count three 16-bit products (fused: V and U split)
    or two (3-pass: U split) per product -- and the transforms by the fp32
    CUDA-core peak; bytes are 2 an operand or output value, 4 a bias
    value.  The library calls run in the 16-bit type: ``torch.addmm``,
    ``F.conv2d`` (cuDNN), ``torch.bmm`` of V by U's hi part, einsum."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.conv_spec import ConvAlgorithm, apply_activation
    from repro_torch.core.winograd import AT, BT, _const, _tile_input, \
        split_transformed, transform_weights
    from repro_torch.kernels.gemm.ops import call_splits_16 as gemm_splits16
    from repro_torch.kernels.gemm.ops import matmul16_bias_act
    from repro_torch.kernels.im2col_gemm.ops import call_splits_16, \
        im2col_conv16
    from repro_torch.kernels.winograd.ops import (
        fused_winograd,
        fused_winograd16,
        input_transform,
        input_transform16,
        output_transform,
        output_transform16,
        tuple_multiply,
        tuple_multiply16,
    )
    from repro_torch.kernels.winograd.ref import (
        input_transform16_ref,
        tuple_multiply16_ref,
    )

    dtype = s.plan.dtype
    dt = getattr(torch, dtype)
    spec, blocks, algo = s.spec, s.plan.kernel_blocks, s.plan.algorithm
    (h, w), (oh, ow) = s.in_hw, s.out_hw
    c, phys_c, o = spec.in_channels, s.in_layout.phys_c, spec.out_channels
    kh, kw = spec.kh, spec.kw
    base = dict(step=s.index, dtype=dtype, peak=hw.peak_flops_bf16)
    if algo is ConvAlgorithm.DIRECT:
        m = b * oh * ow
        a, wm = t(m, c).to(dt), (t(c, o) * c ** -0.5).to(dt)
        return [dict(
            base, kernel="gemm_16",
            label=(f"{head} gemm_16 {dtype} M={m} K={phys_c} N={o} "
                   f"splits={gemm_splits16(m, o, phys_c)}"),
            args=(pad_c(a, 1), pad_c(wm, 0), bias),
            run=lambda a, wm, bias, act=act, impl="cuda":
                matmul16_bias_act(a, wm, bias, act, impl=impl),
            lib_args=(a, wm, bias.to(dt)),
            library=lambda a, wm, bias, act=act:
                apply_activation(torch.addmm(bias, a, wm), act),
            flops=2 * m * c * o,
            bytes=2 * (m * c + c * o + m * o) + 4 * o,
        )]
    x = t(b, h, w, c).to(dt)
    wt32 = t(kh, kw, c, o) * (kh * kw * c) ** -0.5
    wt = wt32.to(dt)
    conv_bytes = 2 * (b * h * w * c + kh * kw * c * o + b * oh * ow * o) + 4 * o
    conv_lib = dict(
        lib_args=(x, wt.permute(3, 2, 0, 1).contiguous(), bias.to(dt)),
        library=lambda x, w_oihw, bias, spec=spec, act=act:
            apply_activation(F.conv2d(
                x.permute(0, 3, 1, 2), w_oihw, bias, spec.stride,
                spec.padding), act).permute(0, 2, 3, 1))
    if algo is ConvAlgorithm.IM2COL_GEMM:
        return [dict(
            base, **conv_lib, kernel="im2col_conv_16",
            label=(f"{head} im2col_16 {dtype} {h}x{w}x{phys_c}->{oh}x{ow}x{o}"
                   f" k{kh} s{spec.stride[0]} blocks={blocks} splits="
                   f"{call_splits_16(b, oh, ow, phys_c, o, blocks[0])}"),
            args=(pad_c(x, 3), pad_c(wt, 2), bias),
            run=lambda x, wt, bias, spec=spec, blocks=blocks, act=act,
            impl="cuda": im2col_conv16(x, wt, spec, blocks, bias, act,
                                       impl=impl),
            flops=2 * b * oh * ow * o * kh * kw * c,
            bytes=conv_bytes,
        )]
    xp = pad_c(x, 3)
    tiles, _, _ = _tile_input(F.pad(xp, (0, 0, 1, 1, 1, 1)), oh, ow)
    tiles = tiles.reshape(-1, 8, 8, phys_c).contiguous()
    u32 = transform_weights(pad_c(wt32, 2)).contiguous()
    u = split_transformed(u32, dt)
    n_t = tiles.shape[0]
    shape = f"T={n_t} C={phys_c} O={o}"
    products = 2 * n_t * 64 * c * o
    if s.plan.winograd_fused:
        return [dict(
            base, **conv_lib, kernel="winograd_fused_16",
            label=f"{head} winograd_16 {dtype} {shape} blocks={blocks}",
            args=(tiles, u.hl, u.inv_scale, bias),
            run=lambda tiles, hl, inv, bias, blocks=blocks, act=act,
            impl="cuda": fused_winograd16(tiles, hl, inv, blocks, bias, act,
                                          impl=impl),
            flops=3 * products, flops_fp32=n_t * c * 2048 + n_t * o * 1344,
            bytes=conv_bytes,
            fp32=lambda: fused_winograd(tiles.float(), u32, None, bias, act),
        )]
    bt_m, at_m = _const(BT, tiles).to(dt), _const(AT, tiles).to(dt)
    v = input_transform16_ref(tiles).reshape(64, n_t, phys_c).contiguous()
    u2 = u.hl.reshape(2, 64, phys_c, o)
    mm = tuple_multiply16_ref(v, u2, u.inv_scale).reshape(8, 8, n_t, o)
    return [
        dict(base, kernel="input_transform_16",
             label=f"{head} input_transform_16 {dtype} {shape}",
             args=(tiles,),
             run=lambda tiles, impl="cuda": input_transform16(tiles,
                                                              impl=impl),
             lib_args=(tiles[..., :c].contiguous(),),
             library=lambda d, bt_m=bt_m:
                 torch.einsum("ai,bj,tijc->abtc", bt_m, bt_m, d),
             flops=0, flops_fp32=2048 * n_t * c,
             bytes=2 * 2 * 64 * n_t * c,
             fp32=lambda: input_transform(tiles.float())),
        dict(base, kernel="tuple_multiply_16",
             label=f"{head} tuple_multiply_16 {dtype} {shape} blocks={blocks}",
             args=(v, u2, u.inv_scale),
             run=lambda v, u2, inv, impl="cuda": tuple_multiply16(
                 v, u2, inv, impl=impl),
             lib_args=(v[..., :c].contiguous(), u2[0, :, :c].contiguous()),
             library=torch.bmm,
             flops=2 * products,
             bytes=2 * 64 * (n_t * c + 2 * c * o + n_t * o),
             fp32=lambda: tuple_multiply(v.float(),
                                         u32.reshape(64, phys_c, o))),
        dict(base, kernel="output_transform_16",
             label=f"{head} output_transform_16 {dtype} {shape} act={act}",
             args=(mm.contiguous(), bias),
             run=lambda m, bias, act=act, impl="cuda":
                 output_transform16(m, bias, act, impl=impl),
             lib_args=(mm.contiguous(), bias.to(dt)),
             library=lambda m, bias, at_m=at_m, act=act: apply_activation(
                 torch.einsum("xa,yb,abto->txyo", at_m, at_m, m) + bias, act),
             flops=0, flops_fp32=1344 * n_t * o,
             bytes=2 * (64 * n_t * o + 36 * n_t * o) + 4 * o,
             fp32=lambda: output_transform(mm.float().contiguous(), bias,
                                           act)),
    ]


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
        err = float((got.float() - ref.float()).abs().max())
        scale = max(1.0, float(ref.float().abs().max()))
        tol = kernel_tol(name, case.get("dtype", "float32")) * scale
        if not (bool(torch.isfinite(got).all()) and got.shape == ref.shape
                and got.dtype == ref.dtype and err <= tol):
            raise AssertionError(
                f"{case['label']}: kernel disagrees with its plain version:"
                f" max_abs_err {err} > {tol}"
            )
        vs32 = ""
        if "fp32" in case:
            y32 = case["fp32"]()
            vs32 = (f" vs_fp32_err={float((got.float() - y32).abs().max()):.3g}"
                    f" (max|fp32| {float(y32.abs().max()):.3g})")
        if name not in timed:
            log(f"kernel {case['label']}: max_abs_err={err:.3g} (tol {tol:.3g})"
                + vs32)
            continue
        ms = cuda_ms(case["run"], args)
        plain_ms = cuda_ms(lambda *a, run=case["run"]: run(*a, impl="torch"),
                           args)
        library_ms = (cuda_ms(case["library"], case["lib_args"])
                      if case["library"] is not None else None)
        # Work on the tensor cores over their peak, and what runs on the
        # fp32 CUDA cores beside it (the fused Winograd kernel's
        # transforms) over theirs: the two units run side by side.
        fp32_work = case.get("flops_fp32", 0)
        t_ops = max(case["flops"] / case["peak"],
                    fp32_work / hw.peak_flops_fp32) * 1e3
        t_bytes = case["bytes"] / hw.hbm_bandwidth * 1e3
        bound_ms = max(t_ops, t_bytes)
        cc_bound_ms = (max((case["flops"] + fp32_work)
                           / case["cuda_core_peak"] * 1e3, t_bytes)
                       if "cuda_core_peak" in case else None)
        log(f"kernel {case['label']}: max_abs_err={err:.3g} (tol {tol:.3g})"
            + vs32 + f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            + ("-" if library_ms is None else f"{library_ms:.4f}")
            + f" bound_ms={bound_ms:.5f} "
            f"({'operations' if t_ops >= t_bytes else 'bytes'})"
            + ("" if cc_bound_ms is None
               else f" fp32_cuda_core_bound_ms={cc_bound_ms:.5f}")
            + ("" if library_ms is None
               else f" ms/library_ms={ms / library_ms:.3f}"))
        agg = summary.setdefault(name, dict(
            calls=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
            bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0, cuda_core_bound_ms=0.0))
        agg["calls"] += 1
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["library_ms"] = (None if library_ms is None or agg["library_ms"]
                             is None else agg["library_ms"] + library_ms)
        agg["bound_ms"] += bound_ms
        agg["ops_ms" if t_ops >= t_bytes else "bytes_ms"] += bound_ms
        agg["cuda_core_bound_ms"] += cc_bound_ms or 0.0
        per_step.setdefault(case["step"], {})[name] = ms
    log(f"kernels {cell}: {n} calls checked in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, agg in summary.items():
        log(f"kernels {cell} {name} over {agg['calls']} calls: "
            f"ms={agg['ms']:.4f} plain_ms={agg['plain_ms']:.4f} library_ms="
            + ("-" if agg["library_ms"] is None else f"{agg['library_ms']:.4f}")
            + f" bound_ms={agg['bound_ms']:.5f}"
            + (f" fp32_cuda_core_bound_ms={agg['cuda_core_bound_ms']:.5f}"
               if agg["cuda_core_bound_ms"] else ""))
    return summary, per_step


# ---------------------------------------------------------------------------
# Phases 4 to 6: whole networks


def forward_ms(fn, reps: int, warmup: int = 3) -> float:
    """Host milliseconds per call of ``fn`` over ``reps`` calls that end in
    a synchronize, after ``warmup`` warm-up calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def three_pass16_stages(step, p, cur):
    """A 16-bit 3-pass Winograd step's three kernel calls on the cuda
    chain's own intermediates, each beside its plain version on the same
    input: [(kernel, got, ref)].  The step's output is not held at the
    kernels' gate: V and M are rounded to 16 bits between the kernels, and
    where the two sums of an M value round apart, the output transform
    carries that unit of M's last place (M runs about 14 times larger than
    the output) into the output."""
    import torch.nn.functional as F

    from repro_torch.core.netplan import _align_channels
    from repro_torch.core.winograd import _tile_input, split_transformed, \
        transform_weights
    from repro_torch.kernels.winograd.ops import (
        input_transform16,
        output_transform16,
        tuple_multiply16,
    )

    x = _align_channels(cur, step.in_layout.phys_c)
    c = x.shape[-1]
    oh, ow = step.out_hw
    ph, pw = step.spec.padding
    tiles, _, _ = _tile_input(F.pad(x, (0, 0, pw, pw, ph, ph)), oh, ow)
    tiles = tiles.reshape(-1, 8, 8, c)
    u = p["w"]
    if u.shape[0] != 8:                         # not pre-transformed
        u = split_transformed(transform_weights(u.float()), x.dtype)
    t, o = tiles.shape[0], u.shape[-1]
    u2 = u.hl.reshape(2, 64, c, o)
    v = input_transform16(tiles)
    m = tuple_multiply16(v.reshape(64, t, c), u2, u.inv_scale)
    act = step.layer.activation
    return [
        ("input_transform_16", v, input_transform16(tiles, impl="torch")),
        ("tuple_multiply_16", m, tuple_multiply16(
            v.reshape(64, t, c), u2, u.inv_scale, impl="torch")),
        ("output_transform_16", output_transform16(
            m.reshape(8, 8, t, o), p["b"], act), output_transform16(
            m.reshape(8, 8, t, o), p["b"], act, impl="torch")),
    ]


def check_steps(compiled, plain, x, name) -> None:
    """Every step of ``compiled``'s forward on ``x`` against ``plain``'s
    step on the same input (the cuda forward's own activation), the
    forward continuing with the cuda step's output: a conv step within its
    kernels' tolerance of ``max(1, max|ref|)`` (a 16-bit 3-pass Winograd
    step each of its three kernels, on the cuda chain's intermediates:
    ``three_pass16_stages``), any other step equal.
    Also prints, after each conv step, the SQNR between the two forwards
    each run on its own outputs, which shows where they drift apart."""
    import torch

    from repro_torch.core.netplan import run_step
    from repro_torch.core.quant import sqnr_db
    from repro_torch.kernels.conv_ops import plan_kernels

    from repro_torch.core.conv_spec import ConvAlgorithm

    ex, ex_plain = compiled.executor(int(x.shape[0])), plain.executor(
        int(x.shape[0]))
    x = x.to(getattr(torch, compiled.options.input_dtype))   # as run() does
    outputs, outputs_plain, cur, cur_plain = [], [], x, x
    worst, drift, three_pass = {}, [], []
    with torch.inference_mode():
        for s, sp in zip(ex.netplan.steps, ex_plain.netplan.steps):
            y = run_step(s, ex.params[s.index], cur, outputs,
                         ex.pretransformed[s.index])
            ref = run_step(sp, ex_plain.params[s.index], cur, outputs,
                           ex_plain.pretransformed[s.index])
            cur_plain = run_step(sp, ex_plain.params[s.index], cur_plain,
                                 outputs_plain, ex_plain.pretransformed[s.index])
            err = float((y.float() - ref.float()).abs().max())
            tol = 0.0
            if s.layer.kind == "conv":
                tol = max(kernel_tol(k, s.plan.dtype)
                          for k in plan_kernels(s.plan)) * max(
                    1.0, float(ref.float().abs().max()))
                worst[s.plan.dtype] = max(worst.get(s.plan.dtype, 0.0), err)
                drift.append(f"{s.index}:"
                             f"{sqnr_db(cur_plain.float(), y.float()):.1f}")
                if (s.plan.dtype in HALF and not s.plan.winograd_fused
                        and s.plan.algorithm is ConvAlgorithm.WINOGRAD):
                    # Held kernel by kernel instead (three_pass16_stages).
                    for k, got, want in three_pass16_stages(
                            s, ex.params[s.index], cur):
                        e = float((got.float() - want.float()).abs().max())
                        t = kernel_tol(k, s.plan.dtype) * max(
                            1.0, float(want.float().abs().max()))
                        if not (bool(torch.isfinite(got).all()) and e <= t):
                            raise AssertionError(
                                f"{name} step {s.index} {k}: cuda vs torch "
                                f"on the same input max_abs_err {e} > {t}")
                    three_pass.append(f"{s.index}:{err:.3g}")
                    tol = float("inf")
            if not (bool(torch.isfinite(y).all()) and y.dtype == ref.dtype
                    and err <= tol):
                raise AssertionError(
                    f"{name} step {s.index} ({s.layer.kind}"
                    f"{'' if s.plan is None else ' ' + s.plan.label}): cuda vs"
                    f" torch on the same input max_abs_err {err} > {tol}")
            outputs.append(y)
            outputs_plain.append(cur_plain)
            cur = y
    log(f"steps {name}: every step matches its plain version on the cuda "
        f"forward's own input; max_abs_err by conv dtype {worst}; "
        f"free-running SQNR (dB) after each conv: {' '.join(drift)}"
        + (f"; 16-bit 3-pass steps held kernel by kernel, the steps' "
           f"max_abs_err {' '.join(three_pass)}" if three_pass else ""))


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
    which is profiled too when ``profile`` is set).

    Under ``dtype='bfloat16' | 'float16'`` the plain compilation runs the
    same Winograd realization; every step is held against its plain
    version on the same input; the output within ``NET_TOL16`` of
    max(1, max|ref|); the fp32 CUDA forward of the same weights and options
    is printed beside it (its distance, and the two replayed forwards timed
    in turns)."""
    import torch

    import repro_torch
    from repro_torch.core.quant import sqnr_db
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    options = dict(options or {})
    int8 = options.get("dtype") == "int8"
    half = options.get("dtype") in HALF
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
    # The model's plan is the card's whatever the impl: the plain forward
    # of a model-mode cell runs the same steps (check_steps pairs them).
    # A 16-bit plain forward runs the same Winograd realization: the 3-pass
    # pipeline rounds V and M to the 16-bit type, the fused kernel neither.
    plain = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cuda", batch=batch,
        dtype=options.get("dtype", "float32"),
        mode="model" if options.get("mode") == "model" else "cost",
        **({"winograd_fused": options.get("winograd_fused")} if half
           else {})),
        calibration=calibration)

    reset_counts()
    y = cu.run(x)             # captures the forward's graph, then replays it
    torch.cuda.synchronize()
    counts = read_counts()

    want = cu.network_plan(batch).kernel_launches()
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != planned {want}")
    check_replays(lambda: cu.run(x), counts, name)
    ex = cu.executor(batch)
    y_eager = ex.eager(x)
    if not torch.equal(y, y_eager):
        raise AssertionError(
            f"{name}: the replayed forward differs from the eager forward: "
            f"max_abs_err {float((y - y_eager).abs().max())}")
    y_ref = plain.run(x)
    torch.cuda.synchronize()
    scale = float(y_ref.float().abs().max())
    err = float((y.float() - y_ref.float()).abs().max())
    ok = (bool(torch.isfinite(y).all()) and y.shape == y_ref.shape
          and y.dtype == y_ref.dtype)
    fp32 = None
    if half:
        check_steps(cu, plain, x, name)
        tol = NET_TOL16[options["dtype"]] * max(1.0, scale)
        if not (ok and err <= tol):
            raise AssertionError(f"{name}: cuda vs torch max_abs_err {err} > "
                                 f"{tol} (max|ref| {scale}, finite and "
                                 f"shaped: {ok})")
        fp32 = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
            batch=batch, **{k: v for k, v in options.items()
                            if k != "dtype"}))
        y32 = fp32.run(x)
        d32 = float((y.float() - y32).abs().max())
        s32 = float(y32.abs().max())
        # The 16-bit forward and the fp32 one, replayed, in turns.
        h1 = forward_ms(lambda: cu.run(x), reps)
        f1 = forward_ms(lambda: fp32.run(x), reps)
        f2 = forward_ms(lambda: fp32.run(x), reps)
        h2 = forward_ms(lambda: cu.run(x), reps)
        h_ms, fp32_ms = (h1 + h2) / 2, (f1 + f2) / 2
        detail = (f"tol={tol:.3g} vs_fp32 max_abs_err={d32:.4g} "
                  f"(of max|fp32| {s32:.4g}: {d32 / max(s32, 1e-30):.4g}) "
                  f"sqnr_vs_fp32_db={sqnr_db(y32, y.float()):.2f}; in turns "
                  f"ms_per_forward {options['dtype']}={h_ms:.4f} ({h1:.4f} "
                  f"{h2:.4f}) fp32={fp32_ms:.4f} ({f1:.4f} {f2:.4f}) "
                  f"images_per_s {options['dtype']}="
                  f"{batch * 1e3 / h_ms:.1f} fp32={batch * 1e3 / fp32_ms:.1f}"
                  f" {options['dtype']}/fp32={h_ms / fp32_ms:.3f}")
    elif int8:
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

    plain_ms = forward_ms(lambda: plain.run(x), 5)
    log(f"model {name}: out {tuple(y.shape)} max_abs_err={err:.3g} "
        f"max|ref|={scale:.3g} launches={counts} compile_s={compile_s:.2f} "
        f"plain_ms_per_forward={plain_ms:.3f} {detail}".rstrip())
    graph_vs_eager(name, lambda: cu.run(x), lambda: ex.eager(x), reps,
                   per_call=batch, unit="images",
                   want=planned_cuda_launches(cu.network_plan(batch)),
                   detail=profile)
    if profile and not half:
        if fp32 is not None:
            profile_forward(lambda: fp32.run(x), fp32_ms,
                            f"{name} (its fp32 forward)",
                            want=planned_cuda_launches(fp32.network_plan(batch)))
    return counts, cu


def check_replays(call, counts, name) -> None:
    """After the first call of a captured path counted ``counts``,
    ``GRAPH_REPLAYS - 1`` more calls leave the counts at ``GRAPH_REPLAYS``
    times ``counts``.  These are the capture's counts multiplied out
    (``graphs.add_launches``), not launches counted on the card: a replay
    launches nothing through a wrapper.  What a replay launches on the
    card is gated by its profile (``graph_vs_eager``)."""
    import torch

    for _ in range(GRAPH_REPLAYS - 1):
        call()
    torch.cuda.synchronize()
    got = read_counts()
    want = {k: GRAPH_REPLAYS * n for k, n in counts.items()}
    if got != want:
        raise AssertionError(f"{name}: launches after {GRAPH_REPLAYS} replays "
                             f"{got} != {want}")


def graph_vs_eager(name, graph, eager, reps, per_call, unit, want=None,
                   detail=False, profile_reps=5, warmup=3, host_rows=0):
    """Host ms per call of the replayed path (``graph``) and of the eager
    one, timed in turns (eager, graph, graph, eager) in one process, each
    then profiled (device busy time and idle share of its calls; with
    ``want``, each planned port kernel in both traces, at most as
    planned); prints one ``graph vs eager`` line."""
    e1 = forward_ms(eager, reps, warmup)
    g1 = forward_ms(graph, reps, warmup)
    g2 = forward_ms(graph, reps, warmup)
    e2 = forward_ms(eager, reps, warmup)
    g_ms, e_ms = (g1 + g2) / 2, (e1 + e2) / 2
    busy_g, kept_g = profile_forward(graph, g_ms, f"{name} graph",
                                     reps=profile_reps, want=want,
                                     detail=detail)
    busy_e, kept_e = profile_forward(eager, e_ms, f"{name} eager",
                                     reps=profile_reps, want=want,
                                     detail=detail, host_rows=host_rows)

    def lost(kept):
        return ("" if kept is None or kept == 1 else
                f" (a lower bound: the trace kept {kept:.2f} of the port "
                f"kernels' launches)")

    log(f"graph vs eager {name}: ms_per_call graph={g_ms:.4f} ({g1:.4f} "
        f"{g2:.4f}) eager={e_ms:.4f} ({e1:.4f} {e2:.4f}) eager/graph="
        f"{e_ms / g_ms:.2f}; {unit}_per_s graph={per_call * 1e3 / g_ms:.1f} "
        f"eager={per_call * 1e3 / e_ms:.1f}; device busy ms graph={busy_g:.4f}"
        f"{lost(kept_g)} eager={busy_e:.4f}{lost(kept_e)}; idle share graph="
        f"{max(0.0, 1.0 - busy_g / g_ms):.3f} eager="
        f"{max(0.0, 1.0 - busy_e / e_ms):.3f}")
    return dict(graph_ms=g_ms, eager_ms=e_ms, busy_graph=busy_g,
                busy_eager=busy_e)


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


def planned_cuda_launches(netplan):
    """CUDA launches of each port kernel in one forward of ``netplan``, by
    the profiler's name: the plan's count of each kernel, and each split-K
    reduce kernel once for each fp32 im2col, int8 im2col, fp32 GEMM or
    int8 GEMM call that splits."""
    from repro_torch.core.conv_spec import ConvAlgorithm
    from repro_torch.kernels.gemm.ops import call_splits as gemm_splits
    from repro_torch.kernels.gemm.ops import call_splits_16 as gemm_splits16
    from repro_torch.kernels.gemm.ops import call_splits_q8 as gemm_splits_q8
    from repro_torch.kernels.im2col_gemm.ops import (
        call_splits,
        call_splits_16,
        call_splits_q8,
    )

    want = {CUDA_NAMES[k]: n for k, n in netplan.kernel_launches().items()}
    fp32 = [s for s in netplan.steps
            if s.layer.kind == "conv" and s.plan.dtype == "float32"]
    splits = sum(
        call_splits(netplan.batch, *s.out_hw, s.in_layout.phys_c,
                    s.out_layout.phys_c, s.plan.kernel_blocks[0]) > 1
        for s in fp32 if s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM)
    if splits:
        want[SPLITK_REDUCE] = splits
    q8 = sum(
        call_splits_q8(netplan.batch, *s.out_hw, s.in_layout.phys_c,
                       s.out_layout.phys_c, s.plan.kernel_blocks[0]) > 1
        for s in netplan.steps
        if s.layer.kind == "conv" and s.plan.dtype == "int8"
        and s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM)
    if q8:
        want[Q8_SPLITK_REDUCE] = q8
    # A 1x1 conv's GEMM: M = B * OH * OW (the output map; a strided 1x1
    # subsamples its input first), K and N the physical channels.
    gemm = sum(
        gemm_splits(netplan.batch * s.out_hw[0] * s.out_hw[1],
                    s.out_layout.phys_c, s.in_layout.phys_c) > 1
        for s in fp32 if s.plan.algorithm is ConvAlgorithm.DIRECT)
    if gemm:
        want[GEMM_SPLITK_REDUCE] = gemm
    gemm_q8 = sum(
        gemm_splits_q8(netplan.batch * s.out_hw[0] * s.out_hw[1],
                       s.out_layout.phys_c, s.in_layout.phys_c) > 1
        for s in netplan.steps
        if s.layer.kind == "conv" and s.plan.dtype == "int8"
        and s.plan.algorithm is ConvAlgorithm.DIRECT)
    if gemm_q8:
        want[GEMM_Q8_SPLITK_REDUCE] = gemm_q8
    half = [s for s in netplan.steps
            if s.layer.kind == "conv" and s.plan.dtype in HALF]
    im16 = sum(
        call_splits_16(netplan.batch, *s.out_hw, s.in_layout.phys_c,
                       s.out_layout.phys_c, s.plan.kernel_blocks[0]) > 1
        for s in half if s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM)
    if im16:
        want[SPLITK16_REDUCE] = im16
    gemm16 = sum(
        gemm_splits16(netplan.batch * s.out_hw[0] * s.out_hw[1],
                      s.out_layout.phys_c, s.in_layout.phys_c) > 1
        for s in half if s.plan.algorithm is ConvAlgorithm.DIRECT)
    if gemm16:
        want[GEMM16_SPLITK_REDUCE] = gemm16
    return want


def profile_forward(forward, ms_per_forward: float, name: str,
                    reps: int = 5, host_rows: int = 0, want=None,
                    detail: bool = True):
    """Device time of one call of ``forward`` by CUDA kernel
    (torch.profiler), the share of the measured time per call in which the
    device was idle and, with ``host_rows``, the operators that take the
    most host time; returns the device busy ms per call and, with
    ``want``, the share of the planned port kernel launches that the trace
    kept (else None): below 1, the trace lost records and the busy time
    is a lower bound.  With ``want``
    (profiler name -> launches per forward), every port kernel in it must
    appear in the trace, at most as often, and no other port kernel: for
    a CUDA graph's replay, the only evidence on the card of what it
    launches.  ``detail``: the rows by kernel, else the summary line
    alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward()
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
    for us, n, key in rows[:14 if detail else 0]:
        log(f"  profile {us / 1e3:.4f} ms x{n} {key[:90]}")
    host = sorted(((ev.self_cpu_time_total / reps, ev.count // reps, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU), reverse=True)
    for us, n, key in host[:host_rows]:
        log(f"  host {us / 1e3:.4f} ms x{n} {key[:90]}")
    # Each port kernel's launches in forward order, median over the reps.
    kernels = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    kept = None
    if want is not None:
        # The trace may lose kernel records here (86 of 95 launches in one
        # forward's profile), never add them: every planned port kernel
        # appears, at most as often as planned, and no other one.
        seen = {c: sum(c in ev.name for ev in kernels)
                for c in (*CUDA_NAMES.values(), *REDUCE_NAMES)}
        bad = {c: n for c, n in seen.items()
               if not (0 < n <= want[c] * reps if c in want else n == 0)}
        planned = reps * sum(want.values())
        kept = sum(seen[c] for c in want) / planned if planned else 1.0
        if bad:
            raise AssertionError(f"profile {name}: port kernel launches in "
                                 f"{reps} forwards {bad}, the plan's per "
                                 f"forward {want}")
        if detail:
            log(f"  profile {name}: port kernel launches in {reps} forwards "
                f"{ {c: n for c, n in seen.items() if n} }, the plan's per "
                f"forward {want}")
    for cname in (*CUDA_NAMES.values(), *REDUCE_NAMES) if detail else ():
        us = [ev.time_range.elapsed_us() for ev in kernels if cname in ev.name]
        n = len(us) // reps
        if not n:
            continue
        per_call = [statistics.median(us[i::n]) / 1e3 for i in range(n)]
        log(f"  in forward order, {cname} ms: "
            + " ".join(f"{t:.4f}" for t in per_call)
            + f" (share of device busy {sum(us) / reps / 1e3 / busy_ms:.3f})")
    return busy_ms, kept


# ---------------------------------------------------------------------------
# Phase 6b: the cost model (mode="model") and the plan cache


def model_vs_measure(model_cu, measure_cu, batch, name):
    """Per conv layer, the model's pick and its modeled ms beside measure
    mode's pick and, for every candidate measure mode timed, the model's
    price of that call (as measure mode runs it: ``measured_call``) over
    the measured ms.  Returns [(candidate, predicted ms, measured ms)]."""
    from repro_torch.core.codesign import candidate_estimate

    pairs = []
    model_steps = model_cu.network_plan(batch).steps
    for s in measure_cu.network_plan(batch).steps:
        if s.plan is None:
            continue
        m = model_steps[s.index].plan
        cands = []
        for label, ms in s.plan.measured_ms:
            pred = candidate_estimate(s.spec, *s.in_hw, batch, label,
                                      measured_call=True).total_s * 1e3
            pairs.append((label, pred, ms))
            cands.append(f"{label} {pred:.4f}/{ms:.4f}")
        log(f"model vs measure {name} L{s.index} {s.in_hw[0]}x{s.in_hw[1]} "
            f"{s.spec.in_channels}->{s.spec.out_channels}: model chose "
            f"{m.label} ({m.predicted_s * 1e3:.4f} ms modeled in the "
            f"forward), measure chose {s.plan.label}; predicted/measured ms "
            + ", ".join(cands))
    return pairs


def model_fit(pairs) -> None:
    """The model's fit per candidate kernel over every call measure mode
    timed: the median and the worst predicted / measured."""
    by = {}
    for label, pred, ms in pairs:
        by.setdefault(label, []).append(pred / ms)
    for label, ratios in sorted(by.items()):
        worst = max(ratios, key=lambda q: abs(np.log(q)))
        log(f"model fit {label}: predicted/measured over {len(ratios)} calls "
            f"median {statistics.median(ratios):.3f} worst {worst:.3f}")


def modes_in_turns(name, compiled, x, reps):
    """Replayed ms per forward of each mode's compilation, timed in turns
    in one process (each mode, then each again in reverse order)."""
    modes = list(compiled)
    times = {m: [] for m in modes}
    for m in modes + modes[::-1]:
        times[m].append(forward_ms(lambda m=m: compiled[m].run(x), reps))
    ms = {m: statistics.mean(t) for m, t in times.items()}
    faster = min(ms["cost"], ms["measure"])
    log(f"modes {name}: replayed ms per forward "
        + " ".join(f"{m}={ms[m]:.4f} ({' '.join(f'{t:.4f}' for t in times[m])})"
                   for m in modes)
        + f"; model/cost={ms['model'] / ms['cost']:.3f} model/measure="
        f"{ms['model'] / ms['measure']:.3f} model/faster={ms['model'] / faster:.3f}")
    return ms


def plan_cache_check(model, params, x, name) -> None:
    """Measure mode's plans persisted: a cold compile into a fresh cache
    file, a warm one from it (0 tunes, 1 network hit), then ``save`` and
    ``repro_torch.load`` (0 tunes) replaying bit for bit what the warm
    compilation replays, once beside the cache file and once with the
    file gone (the artifact alone carries the plans)."""
    import tempfile

    import torch

    import repro_torch

    with tempfile.TemporaryDirectory() as d:
        opts = repro_torch.ExecutionOptions(
            mode="measure", cache_path=os.path.join(d, "plans.json"))
        t0 = time.perf_counter()
        cold = repro_torch.compile(model, params, opts)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = repro_torch.compile(model, params, opts)
        warm_s = time.perf_counter() - t0
        c, w = cold.plan_report(), warm.plan_report()
        if not (c["tunes"] > 0 and w["tunes"] == 0 and w["network_hits"] == 1
                and [r["algorithm"] for r in c["layers"]]
                == [r["algorithm"] for r in w["layers"]]):
            raise AssertionError(f"{name}: cold tunes {c['tunes']}, warm tunes "
                                 f"{w['tunes']} network_hits {w['network_hits']}")
        y_cold, y_warm = cold.run(x), warm.run(x)
        path = warm.save(os.path.join(d, f"{model.name}.compiled.json"))
        t0 = time.perf_counter()
        loaded = repro_torch.load(path, model, params)
        load_s = time.perf_counter() - t0
        y = loaded.run(x)
        os.remove(opts.cache_path)
        bare = repro_torch.load(path, model, params)
        y_bare = bare.run(x)
        torch.cuda.synchronize()
        l, b = loaded.plan_report(), bare.plan_report()
        if not (l["tunes"] == 0 and l["network_hits"] == 1
                and b["tunes"] == 0 and b["network_hits"] == 1
                and torch.equal(y, y_warm) and torch.equal(y_bare, y_warm)
                and torch.equal(y_cold, y_warm)):
            raise AssertionError(f"{name}: load tunes {l['tunes']} network_hits"
                                 f" {l['network_hits']}, without the cache "
                                 f"tunes {b['tunes']} network_hits "
                                 f"{b['network_hits']}, replays equal "
                                 f"{torch.equal(y, y_warm)} "
                                 f"{torch.equal(y_bare, y_warm)}")
    log(f"plan cache {name} mode=measure: cold compile_s={cold_s:.2f} "
        f"tunes={c['tunes']}; warm compile_s={warm_s:.2f} tunes={w['tunes']} "
        f"network_hits={w['network_hits']}; save -> load compile_s="
        f"{load_s:.2f} tunes={l['tunes']} network_hits={l['network_hits']}; "
        f"load without the cache file tunes={b['tunes']} network_hits="
        f"{b['network_hits']}; replays equal to the warm compilation's and "
        f"the cold one's bit for bit")


# ---------------------------------------------------------------------------
# Phase 8: the LM stack


def unmasked_pairs(s: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs an attention call must compute: keys below
    Sk, at or before the query (causal) and inside its window."""
    q = np.arange(s)
    hi = np.minimum(q, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_errors(got, ref, dname):
    """(max |got - ref|, its gate, the largest per-row relative error)."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    tol = FLASH_TOL[dname] * max(1.0, float(ref.abs().max()))
    row = float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    return err, tol, row


def library_kernels(fn, args) -> str:
    """The CUDA kernels one call of ``fn(*args)`` launches (torch.profiler),
    the six most frequent with their counts: which backend served a
    PyTorch call."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = collections.Counter(ev.name for ev in prof.events()
                                if ev.device_type == DeviceType.CUDA)
    return ", ".join(f"{n[:70]} x{c}" for n, c in names.most_common(6))


def check_flash(hw, cells, saturated=()):
    """Phase 8a: the flash-attention kernel against its plain version at
    each cell's shapes, in bf16 and fp32, timed beside its plain version,
    one library call where PyTorch has one (SDPA; in fp32 with TF32 off,
    its backend's kernels printed), and its bound: bf16 FLOPs over the
    bf16 tensor-core peak; fp32 three TF32 products per fp32 product
    (3xTF32), 3 x FLOPs over the TF32 peak, with the CUDA-core bound
    (FLOPs over the fp32 peak) printed beside.  The cells named in
    ``saturated`` take q scaled by 8, so that the scaled scores (std 8)
    reach the softcap's bend; they are not timed, and the plain version
    without the cap must fail the row gate there.  Returns each timed
    case's numbers by (cell, dtype)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for cell, (b, s, sk, h, kv, hd, causal, window, cap) in cells.items():
            q = torch.randn(b, s, h, hd, generator=g, device="cuda")
            q = (q * 8 if cell in saturated else q).to(dtype)
            k, v = (torch.randn(b, sk, kv, hd, generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            kw = dict(causal=causal, window=window, logit_cap=cap)
            got = flash_attention(q, k, v, **kw)
            ref = flash_attention(q, k, v, impl="torch", **kw)
            torch.cuda.synchronize()
            err, tol, row = flash_errors(got, ref, dname)
            row_tol = FLASH_ROW_RTOL[dname]
            label = (f"flash_attention {cell} {dname} B={b} S={s} Sk={sk} "
                     f"H={h} KV={kv} hd={hd} causal={causal} window={window} "
                     f"cap={cap}")
            if not (bool(torch.isfinite(got).all()) and got.dtype == dtype
                    and err <= tol and row <= row_tol):
                raise AssertionError(
                    f"{label}: kernel disagrees with its plain version: "
                    f"max_abs_err {err} (tol {tol}), row error {row} "
                    f"(tol {row_tol})")
            if cell in saturated:
                nocap = flash_attention(q, k, v, impl="torch",
                                        **dict(kw, logit_cap=0.0))
                _, _, row_nocap = flash_errors(got, nocap, dname)
                if not row_nocap > row_tol:
                    raise AssertionError(f"{label}: the plain version without "
                                         f"the cap passes too ({row_nocap})")
                log(f"kernel {label} (q x 8): max_abs_err={err:.3g} (tol "
                    f"{tol:.3g}) row_err={row:.3g} (tol {row_tol:.3g}); "
                    f"against the plain version without the cap "
                    f"row_err={row_nocap:.3g}: the cap is computed")
                continue
            ms = cuda_ms(lambda q, k, v: flash_attention(q, k, v, **kw),
                         (q, k, v), rounds=3)
            plain_ms = cuda_ms(lambda q, k, v: flash_attention(
                q, k, v, impl="torch", **kw), (q, k, v), rounds=3)
            if cap > 0:
                library_ms, why = None, "no PyTorch call computes the tanh softcap"
            else:
                # No window on these cases: the causal flag or nothing.
                def sdpa(q, k, v):
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        is_causal=causal, enable_gqa=True)

                library_ms = cuda_ms(sdpa, (q, k, v), rounds=3)
                why = "F.scaled_dot_product_attention"
                if dtype == torch.float32:
                    if torch.backends.cuda.matmul.allow_tf32:
                        raise AssertionError("SDPA in fp32 must run with TF32 off")
                    why += (", TF32 off; its kernels: "
                            + library_kernels(sdpa, (q, k, v)))
            pairs = unmasked_pairs(s, sk, causal, window)
            flops = 4 * b * h * hd * pairs
            core_ms = flops / hw.peak_flops_fp32 * 1e3
            t_ops = (flops / hw.peak_flops_bf16 * 1e3 if dtype == torch.bfloat16
                     else 3 * flops / hw.peak_flops_tf32 * 1e3)
            t_bytes = nbytes((q, k, v, got)) / hw.hbm_bandwidth * 1e3
            bound_ms = max(t_ops, t_bytes)
            out[cell, dname] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes")
            log(f"kernel {label}: max_abs_err={err:.3g} (tol {tol:.3g}) "
                f"row_err={row:.3g} (tol {row_tol:.3g}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                + ("-" if library_ms is None else f"{library_ms:.4f}")
                + f" ({why}) bound_ms={bound_ms:.5f} "
                f"({out[cell, dname]['bound_by']}"
                + ("" if dtype == torch.bfloat16 else
                   f"; 3xTF32; fp32 CUDA-core bound {core_ms:.5f}")
                + f") pairs={pairs} "
                f"share_of_bound={bound_ms / ms:.4f} "
                f"tflops={flops / ms * 1e-9:.1f}"
                + ("" if library_ms is None
                   else f" ms/library_ms={ms / library_ms:.3f}"))
    return out


def compare_logits(y, ref, chunk: int = 1024):
    """(relative norm of y - ref, max |y - ref|, max |ref|), in fp32, a
    chunk of positions at a time (the logits reach 8 GB)."""
    diff2 = ref2 = err = scale = 0.0
    for i in range(0, y.shape[1], chunk):
        a, r = y[:, i:i + chunk].float(), ref[:, i:i + chunk].float()
        diff2 += float((a - r).square().sum())
        ref2 += float(r.square().sum())
        err = max(err, float((a - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
    return (diff2 / ref2) ** 0.5, err, scale


def lm_prefill_cell(cfg, seq, name, profile=False, keep=False):
    """Phase 8b: one LM prefill cell at full width, on seeded weights and
    tokens: ``impl='cuda'`` against ``impl='torch'`` in fp32 (within
    ``NET_RTOL`` of max(1, max|ref|)) and, on the same weights, in
    ``cfg.dtype`` (bf16: the kernel's logits no further from the fp32
    forward than the plain version's, in relative norm, within
    ``LM_BF16_SPREAD``); the flash kernel launched once per layer and
    nothing else; ms per forward and tokens/s in ``cfg.dtype``.  Returns
    the launch counts and, with ``keep``, the weights in both dtypes."""
    import torch

    import repro_torch
    from repro_torch.models import transformer as tf

    g = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, g)
    toks = torch.randint(0, cfg.vocab_size, (1, seq), generator=g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plain_opts = repro_torch.ExecutionOptions(impl="torch")
    want = {"flash_attention": cfg.num_layers}
    result, ref32 = {}, None
    for dname in ("float32", cfg.dtype):
        c = dataclasses.replace(cfg, dtype=dname)
        p = params if dname == cfg.dtype else tf.tree_map(lambda t: t.float(), params)
        cu, plain = repro_torch.compile(c, p), repro_torch.compile(c, p, plain_opts)
        reset_counts()
        y = cu.run(toks)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"{name} {dname}: launches {counts} != {want}")
        is_main = dname == cfg.dtype
        if profile and is_main:
            check_replays(lambda: cu.run(toks), counts, f"{name} {dname}")
            y_eager = cu.eager(toks)
            if not torch.equal(y, y_eager):
                rel_e, err_e, _ = compare_logits(y, y_eager)
                raise AssertionError(
                    f"{name} {dname}: the replayed forward differs from the "
                    f"eager forward: rel {rel_e:.3g} max_abs_err {err_e:.3g}")
            del y_eager
        # The plain forward runs eagerly (asked for): a graph of it would
        # hold a second forward's activations and logits in its pool.
        y_ref = plain.eager(toks)
        rel, err, scale = compare_logits(y, y_ref)
        ok = (bool(torch.isfinite(y).all()) and y.shape == y_ref.shape
              == (1, seq, cfg.vocab_size) and y.dtype == tf.torch_dtype(dname))
        if dname == "float32":
            ref32 = y_ref
            tol = NET_RTOL * max(1.0, scale)
            gate = f"max_abs_err <= {tol:.3g}"
            ok = ok and err <= tol
        else:
            # Two bf16 forwards that round at other places land at
            # comparable distances from the fp32 forward of the same
            # weights; the kernel's must not land further than
            # LM_BF16_SPREAD times the plain version's.
            rel_plain = compare_logits(y_ref, ref32)[0]
            rel_cuda = compare_logits(y, ref32)[0]
            gate = (f"vs plain float32: cuda rel {rel_cuda:.3g} <= "
                    f"{LM_BF16_SPREAD} x plain rel {rel_plain:.3g}")
            ok = ok and rel_cuda <= LM_BF16_SPREAD * rel_plain
            ref32 = None
        if not ok:
            raise AssertionError(f"{name} {dname}: cuda vs torch rel {rel:.3g} "
                                 f"max_abs_err {err:.3g} (max|ref| {scale:.3g}; "
                                 f"gate {gate})")
        del y, y_ref
        # Each compilation has run once; the cell's dtype is timed in full
        # and beside its plain forward, and, profiled, the replayed forward
        # beside the eager one.
        if profile and is_main:
            ms = graph_vs_eager(
                f"{name} {dname}", lambda: cu.run(toks), lambda: cu.eager(toks),
                LM_REPS, per_call=seq, unit="tokens",
                want={CUDA_NAMES["flash_attention"]: cfg.num_layers},
                detail=True, profile_reps=3, warmup=1)["graph_ms"]
        else:
            ms = forward_ms(lambda: cu.run(toks), LM_REPS if is_main else 2,
                            warmup=1)
        plain_part = (f"plain_ms_per_forward="
                      f"{forward_ms(lambda: plain.eager(toks), 2, warmup=0):.3f}"
                      if is_main else "")
        log(f"model {name} {dname}: logits (1, {seq}, {cfg.vocab_size}) "
            f"rel={rel:.3g} max_abs_err={err:.3g} max|ref|={scale:.3g} ({gate}) "
            f"launches={counts} init_s={init_s:.2f} ms_per_forward={ms:.3f} "
            f"tokens_per_s={seq * 1e3 / ms:.1f} {plain_part}".rstrip())
        if profile and is_main:
            check_shared_pool(cu, toks, f"{name} {dname}")
        if keep:
            result[dname] = p
        result["launches"] = counts
        del cu, plain, p
        torch.cuda.empty_cache()
    log(f"model {name}: peak device memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return result


def check_shared_pool(cu, toks, name) -> None:
    """A second token shape (the first half of ``toks``) captured into the
    graph pool that the first shape's graph lives in (a ``CompiledLM``'s
    graphs share one): both shapes' replays must equal their eager
    forwards bit for bit, the first one's after the second capture.
    Prints, not gated, the reserved memory the second capture added
    beyond the logits it returned, beside what the same shape's graph
    adds in a pool of its own.  A capture empties the allocator's cache
    first, so every reading follows an ``empty_cache``: what stays
    reserved is live tensors and the graphs' pools."""
    import torch

    from repro_torch.graphs import CapturedCall

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    half = toks[:, :toks.shape[1] // 2].contiguous()
    before = reserved()
    y_half = cu.run(half)
    nbytes = y_half.numel() * y_half.element_size()
    shared = (reserved() - before - nbytes) / 2**30
    for t, y in ((half, y_half), (toks, cu.run(toks))):
        if not torch.equal(y, cu.eager(t)):
            raise AssertionError(f"{name}: with two graphs in one pool, the "
                                 f"replay at {tuple(t.shape)} differs from "
                                 f"its eager forward")
        del y
    before = reserved()
    own = CapturedCall(cu.eager, (half,), f"{name} at {tuple(half.shape)}, "
                       f"a pool of its own")
    private = (reserved() - before) / 2**30
    del own
    log(f"shared pool {name}: a second shape {tuple(half.shape)} captured "
        f"into the first one's pool; both replays equal their eager forwards;"
        f" reserved memory grew {shared:.2f} GiB beyond the returned logits "
        f"(its static logits {nbytes / 2**30:.2f} GiB), against "
        f"{private:.2f} GiB for the same graph in a pool of its own (printed,"
        f" not gated)")


def lm_serving_cell(cfg, params, params32, name):
    """Phase 8c: ``.serve(batch_size=4, capacity=128)`` answers 6 requests
    (8 prompt tokens, 12 new, greedy); its tokens against a greedy
    ``decode_step`` loop on the card (the request in row 0 of a batch of
    4, the other rows fed token 0); then ``prefill_with_cache`` (through
    the kernel) against token-by-token decode, and one decode step from
    each cache."""
    import torch

    import repro_torch
    from repro_torch.models import transformer as tf

    from repro_torch.serving import EagerServingEngine

    batch, capacity, n_req, prompt_len, new = 4, 128, 6, 8, 12
    torch.cuda.reset_peak_memory_stats()
    compiled = repro_torch.compile(cfg, params)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=prompt_len)
               for _ in range(n_req)]
    # The graph engine captures its decode step when it is made: the
    # capture's warm-up loads the decode path's kernels before either run
    # is timed.
    engines = {"eager": EagerServingEngine.from_compiled(
                   compiled, batch_size=batch, capacity=capacity),
               "graph": compiled.serve(batch_size=batch, capacity=capacity)}
    answers, seconds = {}, {}
    for kind, eng in engines.items():
        uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        seconds[kind] = time.perf_counter() - t0
        answers[kind] = [res[u] for u in uids]
    engine, results = engines["graph"], answers["graph"]
    if results != answers["eager"]:
        raise AssertionError(f"{name}: the graph engine's tokens {results} "
                             f"differ from the eager engine's {answers['eager']}")
    dt = seconds["graph"]
    total = sum(len(v) for v in results)

    def greedy(prompt):
        cache = tf.init_cache(cfg, batch, capacity, "cuda")
        toks, out = list(prompt), []
        live = torch.tensor([True] + [False] * (batch - 1), device="cuda")
        with torch.no_grad():
            for pos in range(len(prompt) + new - 1):
                t = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
                t[0, 0] = int(toks[pos])
                logits, cache = tf.decode_step(
                    cfg, params, cache, t,
                    torch.full((batch,), pos, dtype=torch.int64, device="cuda"),
                    live=live)
                if pos >= len(prompt) - 1:
                    out.append(int(logits[0].argmax()))
                    toks.append(out[-1])
        return out

    for i, p in enumerate(prompts):
        want = greedy(p)
        if results[i] != want:
            raise AssertionError(f"{name}: request {i + 1} got {results[i]}, "
                                 f"a greedy decode_step loop gives {want}")
    log(f"serve {name}: {n_req} requests, {total} tokens in {dt:.3f} s "
        f"({total / dt:.1f} tokens/s; the eager engine {seconds['eager']:.3f}"
        f" s, {total / seconds['eager']:.1f} tokens/s) batch={batch} "
        f"capacity={capacity}; tokens equal a greedy decode_step loop and "
        f"the eager engine's; first request {results[0]}")
    # Where a decode step's time goes: one batched step of the engine, its
    # graph's replay beside the same step run eagerly.
    engine.pos[:] = np.arange(batch)
    tokens, live = np.zeros((batch, 1), np.int64), np.ones(batch, bool)
    step_args = (torch.zeros((batch, 1), dtype=torch.int64, device="cuda"),
                 torch.arange(batch, device="cuda"),
                 torch.ones(batch, dtype=torch.bool, device="cuda"))
    graph_vs_eager(f"decode step {name} batch={batch}",
                   lambda: engine._decode(tokens, live),
                   lambda: engine.step(*step_args), 10, per_call=batch,
                   unit="tokens", want={}, detail=True, host_rows=8)

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                         device="cuda")
    nxt = torch.ones((batch, 1), dtype=torch.int64, device="cuda")
    for dname, p in ((cfg.dtype, params), ("float32", params32)):
        c = dataclasses.replace(cfg, dtype=dname)
        reset_counts()
        with torch.no_grad():
            logits_pf, cache_pf = tf.prefill_with_cache(c, p, toks, capacity)
            torch.cuda.synchronize()
            counts = read_counts()
            cache = tf.init_cache(c, batch, capacity, "cuda")
            for t in range(prompt_len):
                logits_dec, cache = tf.decode_step(c, p, cache, toks[:, t:t + 1], t)
            l1, _ = tf.decode_step(c, p, cache_pf, nxt, prompt_len)
            l2, _ = tf.decode_step(c, p, cache, nxt, prompt_len)
        if counts != {"flash_attention": cfg.num_layers}:
            raise AssertionError(f"{name} prefill_with_cache: launches {counts}")
        line = []
        for what, a, ref in (("prefill", logits_pf, logits_dec),
                             ("next step", l1, l2)):
            rel, err, scale = compare_logits(a[:, None], ref[:, None])
            line.append(f"{what} rel={rel:.3g} max_abs_err={err:.3g} "
                        f"max|ref|={scale:.3g}")
            if dname == "float32" and not (
                    bool(torch.isfinite(a).all())
                    and err <= NET_RTOL * max(1.0, scale)):
                raise AssertionError(f"{name} {dname}: {what} logits differ "
                                     f"from token-by-token decode: {line[-1]}")
        log(f"prefill vs decode {name} {dname}: " + "; ".join(line)
            + (" (gated: within 1e-3 of max(1, max|ref|))" if dname == "float32"
               else " (printed, not gated)"))
    log(f"serve {name}: peak device memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (both weight "
        f"copies included)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available()"
              " is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch import configs as lm_configs
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
    # MODEL_20's GEMM and fused Winograd calls sit in a device-bound
    # forward: timed too.
    check_kernels(netplan_of(yolov3.MODEL_20, 1), rng, H100, "yolov3-20 608 b1",
                  timed=("gemm", "winograd_fused"))
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
    # other cell, and its int8 GEMM calls (large M, bytes-bound) are timed.
    summaries[tiny8_cell], _ = check_kernels(
        netplan_of(yolov3.TINY_MODEL, 1, "int8"), rng, H100, tiny8_cell,
        timed=("gemm_q8", "im2col_conv_q8"))
    check_kernels(netplan_of(vgg16.MODEL, 1, "int8"), rng, H100,
                  "vgg16 224 b1 int8")
    check_kernels(netplan_of(yolov3.MODEL_20, 1, "int8"), rng, H100,
                  "yolov3-20 608 b1 int8", timed=("gemm_q8",))
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 4: YOLOv3-tiny end to end; batch 1 is the main path of the
    # GEMM, im2col and fused Winograd kernels.
    launches, cost = {}, {}
    launches[tiny_cell], cost["yolov3-tiny 416 b1"] = run_cell(
        yolov3.TINY_MODEL, 1, rng, profile=True)
    _, cost["yolov3-tiny 416 b4"] = run_cell(yolov3.TINY_MODEL, 4, rng,
                                             reps=SHORT_FORWARD_REPS)

    # Phase 5: MODEL_20 at 608 (stride-2 im2col, shortcut).
    _, cost["yolov3-20 608 b1"] = run_cell(yolov3.MODEL_20, 1, rng,
                                           reps=SHORT_FORWARD_REPS)

    # Phase 6: VGG-16 at 224, batch 1: fused, 3-pass (the main path of the
    # three 3-pass kernels), measure mode; one set of weights.
    params = random_batchnorm(init_cnn(rng, vgg16.MODEL.layers), rng)
    _, cost["vgg16 224 b1"] = run_cell(vgg16.MODEL, 1, rng, params,
                                       profile=True)
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
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 6b: the co-design cost model (mode="model") on the four cells,
    # beside cost mode (phases 4 to 6) and measure mode (VGG-16 from phase
    # 6, the others measured here), with its own generator so that the
    # later phases draw what they drew before; then the plan cache.
    rng_b = np.random.default_rng(SEED)
    cells = {"yolov3-tiny 416 b1": (yolov3.TINY_MODEL, 1, FORWARD_REPS),
             "yolov3-tiny 416 b4": (yolov3.TINY_MODEL, 4, SHORT_FORWARD_REPS),
             "yolov3-20 608 b1": (yolov3.MODEL_20, 1, SHORT_FORWARD_REPS),
             "vgg16 224 b1": (vgg16.MODEL, 1, FORWARD_REPS)}
    pairs = []
    for cell, (model, batch, reps) in cells.items():
        cell_params = (params if model is vgg16.MODEL
                       else random_batchnorm(init_cnn(rng_b, model.layers),
                                             rng_b))
        _, modeled = run_cell(model, batch, rng_b, cell_params,
                              {"mode": "model"}, f"{cell} mode=model",
                              profile=model is vgg16.MODEL, reps=reps)
        for row in modeled.plan_report()["layers"]:
            if row["source"] != "cost_model" or not row["predicted_s"] > 0:
                raise AssertionError(f"model mode: {cell} layer {row['index']}"
                                     f" planned by {row['source']}")
        check_kernels(modeled.network_plan(batch), rng_b, H100,
                      f"{cell} mode=model")
        if model is vgg16.MODEL:
            measure = measured
        else:
            _, measure = run_cell(model, batch, rng_b, cell_params,
                                  {"mode": "measure"}, f"{cell} mode=measure",
                                  reps=reps)
            check_kernels(measure.network_plan(batch), rng_b, H100,
                          f"{cell} mode=measure")
        pairs += model_vs_measure(modeled, measure, batch, cell)
        h, w = model.input_hw
        x = torch.tensor(rng_b.standard_normal(
            (batch, h, w, model.in_channels)).astype(np.float32), device="cuda")
        modes_in_turns(cell, {"cost": cost[cell], "measure": measure,
                              "model": modeled}, x, reps)
    model_fit(pairs)
    h, w = vgg16.MODEL.input_hw
    plan_cache_check(vgg16.MODEL, params, torch.tensor(rng_b.standard_normal(
        (1, h, w, 3)).astype(np.float32), device="cuda"), "vgg16 224 b1")
    del cost, measured
    log(f"phase 6b done at {time.perf_counter() - t_start:.1f} s")

    # Phase 7: int8 (YOLOv3-tiny 416 b1 is the main path of both int8
    # kernels), with the reference acceptance test's weights: seeded, with
    # identity batchnorm.
    int8 = {"dtype": "int8"}
    launches[tiny8_cell], _ = run_cell(
        yolov3.TINY_MODEL, 1, rng, init_cnn(rng, yolov3.TINY_LAYERS), int8,
        tiny8_cell, profile=True)
    vgg8, _ = run_cell(vgg16.MODEL, 1, rng, init_cnn(rng, vgg16.MODEL.layers),
                       int8, "vgg16 224 b1 int8", profile=True)
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
    # The cost model's int8 gate, on its own generator's draws.
    rng_q = np.random.default_rng(SEED)
    run_cell(yolov3.TINY_MODEL, 1, rng_q, init_cnn(rng_q, yolov3.TINY_LAYERS),
             {"dtype": "int8", "mode": "model"}, f"{tiny8_cell} mode=model",
             profile=True)

    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 7b: bf16 and fp16 (YOLOv3-tiny 416 b1 is the main path of the
    # 16-bit GEMM, im2col and fused Winograd kernels, VGG-16 224 b1 with
    # winograd_fused=False that of the three 16-bit 3-pass kernels), on
    # their own generator's draws: every 16-bit kernel call of the four
    # cells against its plain version (timed at YOLOv3-tiny's and VGG-16's
    # shapes), then each cell end to end beside its fp32 forward.
    rng_h = np.random.default_rng(SEED)
    half_cells = {
        "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, {}, FORWARD_REPS, (
            "gemm_16", "im2col_conv_16", "winograd_fused_16")),
        "yolov3-20 608 b1": (yolov3.MODEL_20, {}, SHORT_FORWARD_REPS, ()),
        "vgg16 224 b1": (vgg16.MODEL, {}, FORWARD_REPS, (
            "im2col_conv_16", "winograd_fused_16")),
        vgg3_cell: (vgg16.MODEL, {"winograd_fused": False}, FORWARD_REPS, (
            "input_transform_16", "tuple_multiply_16", "output_transform_16")),
    }
    half_params = {}                    # one set of weights a network
    for model, _, _, _ in half_cells.values():
        if model.name not in half_params:
            half_params[model.name] = random_batchnorm(
                init_cnn(rng_h, model.layers), rng_h)
    for dtype in HALF:
        for cell, (model, opts, reps, timed) in half_cells.items():
            name = f"{cell} {dtype}"
            three_pass = opts.get("winograd_fused") is False
            summary, _ = check_kernels(
                netplan_of(model, 1, dtype, **opts), rng_h, H100, name,
                timed=timed, winograd_only=three_pass)
            counts, _ = run_cell(model, 1, rng_h, half_params[model.name],
                                 {"dtype": dtype, **opts}, name,
                                 profile=True, reps=reps)
            if dtype == "bfloat16" and cell in (tiny_cell, vgg3_cell):
                summaries[name], launches[name] = summary, counts
    # The cost model's 16-bit plans (mode="model", the '_16' constants of
    # hw.H100.kernel_fit), each beside the fp32 model-mode forward.
    for cell in (tiny_cell, "vgg16 224 b1"):
        model, _, reps, _ = half_cells[cell]
        name = f"{cell} bfloat16 mode=model"
        check_kernels(netplan_of(model, 1, "bfloat16", mode="model"), rng_h,
                      H100, name)
        _, modeled = run_cell(model, 1, rng_h, half_params[model.name],
                              {"dtype": "bfloat16", "mode": "model"}, name,
                              profile=True, reps=reps)
        rows = modeled.plan_report()["layers"]
        if any(r["source"] != "cost_model" or not r["predicted_s"] > 0
               for r in rows):
            raise AssertionError(f"{name}: a layer not planned by the model")
        log(f"model plan {name}: "
            + " ".join(f"L{r['index']}:{r['algorithm']}"
                       + (("_fused" if r["winograd_fused"] else "_3pass")
                          if r["algorithm"] == "winograd" else "")
                       for r in rows)
            + f"; modeled conv ms "
            f"{sum(r['predicted_s'] for r in rows) * 1e3:.4f}")
    log(f"phase 7b done at {time.perf_counter() - t_start:.1f} s")

    # Phase 8: the LM stack.  Llama-3.2-1B's prefill is the main path of
    # the flash-attention kernel; Gemma2-27B (full width, 2 of its 46
    # layers: one local, one global) the path of its window and softcap.
    llama = lm_configs.get_config("llama3.2-1b")
    gemma = dataclasses.replace(lm_configs.get_config("gemma2-27b"), num_layers=2)
    llama_cell = "llama3.2-1b prefill S4096 b1"
    gemma_cell = "gemma2-27b (2 layers) prefill S8192 b1"
    saturated = "gemma2-27b attn S8192 softcap saturated"
    flash = check_flash(H100, {
        llama_cell: (1, 4096, 4096, 32, 8, 64, True, 0, 0.0),
        "gemma2-27b local S8192": (1, 8192, 8192, 32, 16, 128, True, 4096, 50.0),
        "gemma2-27b attn S8192": (1, 8192, 8192, 32, 16, 128, True, 0, 50.0),
        saturated: (1, 8192, 8192, 32, 16, 128, True, 0, 50.0),
        "non-causal ragged Sk": (2, 1000, 777, 32, 8, 64, False, 0, 0.0),
    }, saturated=(saturated,))
    log(f"phase 8a done at {time.perf_counter() - t_start:.1f} s")
    llama_run = lm_prefill_cell(llama, 4096, llama_cell, profile=True, keep=True)
    launches[llama_cell] = llama_run["launches"]
    lm_serving_cell(llama, llama_run[llama.dtype], llama_run["float32"],
                    "llama3.2-1b")
    del llama_run
    torch.cuda.empty_cache()
    lm_prefill_cell(gemma, 8192, gemma_cell)
    n = launches[llama_cell]["flash_attention"]
    f = flash[llama_cell, llama.dtype]
    summaries[llama_cell] = {"flash_attention": dict(
        max_abs_err=f["max_abs_err"], ms=n * f["ms"], plain_ms=n * f["plain_ms"],
        library_ms=None if f["library_ms"] is None else n * f["library_ms"],
        bound_ms=n * f["bound_ms"],
        ops_ms=n * f["bound_ms"] if f["bound_by"] == "operations" else 0.0,
        bytes_ms=n * f["bound_ms"] if f["bound_by"] == "bytes" else 0.0)}
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 9: the kernels line, then the last line.
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

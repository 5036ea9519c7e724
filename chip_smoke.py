#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each on its own printed lines:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   and the card's reported properties beside ``repro_torch.hw.H100``;
2. build every CUDA kernel of the port with nvcc (one process per source,
   all at once) and print the build seconds and ptxas' register, spill
   and shared-memory counts, one line of registers and spills for each
   flash instance (body, head dim, and ``lse`` for the instances that
   write the backward's row statistic), and the 16-bit Winograd kernels'
   dynamic shared memory;
3. each kernel against its plain PyTorch version at every shape the model
   cells below give it (YOLOv3-tiny at 416x416, batch 1 and 4; MODEL_20 at
   608x608, batch 1; VGG-16 at 224x224, batch 1 with the fused Winograd
   kernel, and batch 8 with it (its Winograd calls) and with
   ``winograd_fused=False``, where cost mode's rule, the reference
   planner's, sends conv4_2 and conv4_3 to the 3-pass pipeline and the
   other 3x3 convs to im2col (its Winograd calls); the int8 plans of
   YOLOv3-tiny 416,
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
   per 3-pass layer of VGG-16 b8, the fused kernel's time beside the
   3-pass pipeline's;
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
6. VGG-16 at 224x224, three forwards: batch 1 by default (fused
   Winograd), batch 8 with ``winograd_fused=False`` (the 3-pass pipeline
   on conv4_2 and conv4_3: two launches of each 3-pass kernel) and batch
   1 with ``mode='measure'`` (each layer's candidates timed on the card;
   its per-layer choice printed), each the same comparison and each
   profiled; then every kernel call of the measure-mode plan held against
   its plain version, as in phase 3;
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
   generator's draws: YOLOv3-tiny 416 b1, MODEL_20 608 b1, VGG-16 224 b1
   (fused) and b8 (``winograd_fused=False``), in each type: every call of the
   16-bit kernels (GEMM, im2col conv, fused Winograd, the three 3-pass
   kernels) held against its plain version within two units of the last
   place at the largest output (2^-6 of max(1, max|ref|) in bf16, 2^-9 in
   fp16), each Winograd call's distance from the fp32 kernel on the same
   values printed, timed at YOLOv3-tiny's and VGG-16's shapes and
   MODEL_20's GEMM, im2col and fused Winograd calls (ms, plain ms, the
   library call in the
   16-bit type -- ``torch.addmm``, ``F.conv2d``, einsum, and one
   ``torch.bmm`` of [V | V] by [U hi ; U lo] for the tuple multiply, with
   the bmm of V by U's hi part alone beside it -- and the bound: 16-bit
   tensor-core FLOPs over 989 TFLOP/s, the Winograd products counted three
   times (fused) or twice (3-pass) for their split operands, the
   transforms over the fp32 peak, or 2 bytes an operand over 3.35 TB/s;
   the fused calls' lines give their grid and C split, the tuple
   multiply's its work items, the GEMM's and the im2col conv's their
   tile, work items, cluster and K split, the conv's window and ring,
   and both their dynamic shared memory), VGG-16 b8's 16-bit fused time
   beside its 3-pass time per 3-pass layer; then each cell
   end to end: ``impl='cuda'`` against ``impl='torch'`` (the same Winograd
   realization) within 2e-2 (bf16) or 5e-3 (fp16) of max(1, max|ref|), every
   step against its plain step on the cuda forward's own input
   (``check_steps``), the 16-bit kernels' launches equal to the plan's, the
   replay equal to eager, a finite output of the reference's dtype (fp32
   for VGG-16's fc head), its distance from the fp32 forward of the same
   weights printed, the 16-bit and the fp32 replayed forwards timed in
   turns (ms and images/s), and the replayed and eager forwards profiled:
   each 16-bit kernel (and the fused Winograd kernel's reduce where it
   splits C; the GEMM and the im2col conv sum their K splits in their own
   launch) at most as planned, and no other port kernel; then
   YOLOv3-tiny 416 b1 and VGG-16 224 b1 planned by the cost model
   (``mode='model'``, the 16-bit kernels' own fitted constants): every
   kernel call of their plans held in bf16 and fp16, and each cell run in
   bf16 the same way beside the fp32 model-mode forward, its plan and
   modeled conv ms printed;
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
   Llama-3.2-1B prefill at full width (16 layers, B 1, S 4096, bf16),
   through ``lm_prefill_cell`` as every LM cell: the bf16 forward's
   replay with exactly 16 flash launches and its eager forward equal bit
   for bit, timed in turns beside the eager forward and profiled, with
   the kernel's share; a second shape (S 2048) captured into the same
   graph pool, both shapes' replays equal to their eager forwards, with
   the reserved memory the second capture added beside what the same
   graph adds in a pool of its own (printed); the plain forward (run
   eagerly); then the weights cast to fp32 in place and the plain fp32
   forward, from which the kernel's bf16 logits lie at most 1.25 times
   as far as the plain bf16 logits (relative norm); the fp32 forward
   through the kernel within 1e-3 of max(1, max|ref|) of the plain one;
   ``prefill_with_cache`` (the kernel) over the prompt against the
   forward's last logits and one decode step from its cache against the
   plain forward one token longer (fp32 within 1e-3 of max(1, max|ref|);
   bf16 printed); Gemma2-27B at full width cut to 2 layers (local, attn),
   B 1, S 8192: the same forward checks with 2 launches, its replay
   profiled once; Llama-3.2-1B serving (``.serve(batch_size=4,
   capacity=128)``, 6 requests of 8 prompt tokens and 12 new ones,
   greedy; the decode step a CUDA graph captured with the engine): the
   engine's tokens against a greedy ``decode_step`` loop and against the
   same engine with its step run eagerly (``EagerServingEngine``),
   tokens/s of both; one decode step's replay beside the eager step,
   timed in turns and profiled (no port kernel in either trace), and a
   greedy step through the engine's guarded call beside the replay with
   an argmax and its copy; each LM cell prints its peak device memory;
8b. CNN serving (``CompiledCNN.serve()``): YOLOv3-tiny at 416x416 at full
   width, buckets 1, 4 and 8 (one CUDA graph each, captured when the
   engine is made), in fp32, bf16 and int8: every kernel call of each
   bucket's plan whose batch and dtype no earlier phase checks (fp32 b8,
   bf16 and int8 b4 and b8) against its plain version, as phase 3 does;
   13 requests drain as 8 + 4 + 1; the bucket sequence, the stats and every ``health()`` counter (0)
   checked; each bucket's wrapper launches equal to its plan's; each row
   bit for bit the bucket's compiled forward of the same batch
   (``executor(b)``) and within the cells' tolerance of the
   ``impl='torch'`` forward of that batch (fp32 1e-3, bf16 2e-2 of max(1,
   max|ref|), int8 an SQNR of at least 40 dB); the drain profiled, with
   every planned port kernel of the three buckets in the trace, at most
   as planned; the ms of each bucket's step on the host's clock (stack,
   copy in, replay, copy out) beside that bucket's ``compiled.run``
   replay, and the drain's images/s; then, in fp32, a fault run on the
   card: an injected exception one retry recovers, a NaN row that fails
   its one request while its neighbours equal the clean rows, a latency
   fault (``FakeClock``) that expires the next request, and
   ``Backpressure`` at ``max_queue``;
8c. multi-device CNN inference, each stage and shard its own entry of a
   device list (its own stream, CUDA-graph pool and parameter copy), on
   this card repeated: first the tick of an empty pipeline schedule (2
   and 4 stages of one add each, 8 microbatches; ``core/netplan.
   TICK_OVERHEAD_S`` is set from it); then YOLOv3-tiny 416 b8 pipelined
   over 2 stages in fp32, bf16 and int8, VGG-16 224 b8 over 4 stages in
   fp32, and YOLOv3-tiny 416 b8 batch-sharded 2 ways in fp32 and bf16,
   each through ``repro_torch.compile(..., devices=...)`` and held
   against the single-device replay of the same compilation's plan and
   params (fp32 1e-3, bf16 2e-2 of max(1, max|ref|), int8 40 dB), each
   stage's or shard's graph launching its slice of the plan, n_micro (or
   shard) times a call, a held output unchanged by the next call, then
   timed in turns beside the single replay and profiled (only planned
   port kernels); then YOLOv3-tiny 416 served over buckets 1/4/8 with
   ``pipeline_stages=2`` (rows bit-equal to the bucket's pipelined
   forward, ``health()`` counters 0, ms per step beside the bucket's
   ``run``); the same pipeline and shards over two cards where two are
   visible, else a line that says multi-card execution was not run;
8d. static plan verification (``repro_torch/analysis``): every cell
   phases 3 to 8c run, at full width, compiled again with
   ``validate="full"`` (YOLOv3-tiny 416 b1 in fp32, int8 and bf16, in cost
   and model mode, and b4; MODEL_20 608 b1 in fp32, int8 and bf16; VGG-16
   224 b1 in fp32, int8 and bf16, in cost and model mode; VGG-16 224 b8
   with ``winograd_fused=False`` in fp32 and bf16 in cost mode and in fp32
   in model mode): each executor's gate records one forward on the card
   and runs every pass, and its report must be clean; the pipelines of
   phase 8c (YOLOv3-tiny 416 b8 over 2 stages in fp32, bf16 and int8,
   VGG-16 224 b8 over 4) through ``verify_pipeline`` at the kernel rung,
   each stage recorded at microbatch size; then every distinct launch
   recorded there against its library's ``describe`` entry (the
   launcher's own planning function, run without launching): grid,
   cluster, threads, ring stages and dynamic and static shared memory
   equal, the dynamic part within the function's limit and both within
   the device's opt-in shared memory a block, a persistent launch's tile
   map walked again at the card's grid; one line a kernel with the
   descriptor's shared memory beside ``describe``'s, ptxas' and
   ``cudaFuncGetAttributes``' figures; a finding fails the run;
8e. the MoE, recurrent and frontend LM families at full width (phase 8a
   holds the flash kernel at their head dims, 256 with recurrentgemma-9b's
   2048 window and MQA at S 4096, 80 non-causal at hubert-xlarge's S 1000,
   beside SDPA, a masked one for the window): granite-moe-1b-a400m (24
   layers, S 4096), arctic-480b (1 of 35 layers, S 2048, bf16 only),
   recurrentgemma-9b (38 layers, S 4096; fp32 at 3 layers), xlstm-125m (12
   layers, S 4096), hubert-xlarge (48 layers, frames (1, 1000, 512)) and
   internvl2-2b (24 layers, 256 patches before 768 tokens), each on seeded
   weights through the same ``lm_prefill_cell`` as Llama's and Gemma2's
   (replay, profile, the bf16 and fp32 gates, ``prefill_with_cache``
   over the cell's input, an mLSTM in its chunked form), the four
   decoding cells served as Llama is.  On MoE cells each logit gate holds
   on the tokens routed alike in every layer by the two forwards it
   compares, at least ``MOE_MIN_AGREE`` of them, and the routing is gated
   too: in bf16 the kernel's (layer, token) decisions that differ from the
   plain fp32 forward's at most ``LM_BF16_SPREAD`` times the plain bf16
   forward's, in fp32 at most ``MOE_FP32_FLIPS`` of them; the decode step
   after ``prefill_with_cache`` is printed, not gated (the prompt's last
   token may meet a capacity a step's one token does not).  Each cell
   prints its replay ms, its first call's seconds (the capture), busy ms,
   idle share and flash launches, and the phase its seconds;
8f. LM training (``repro_torch.train``): the flash backward kernel
   (``flash_attention_bwd.cu``; ptxas lines a kernel instance) against
   ``attention_bwd_ref`` from the kernel forward's own output and lse, in
   bf16 and fp32 (fp32 against its steps in float64 and, but at the
   saturated softcap, the fp32 plain version), at each trained
   config's attention shape (Llama-3.2-1B's microbatch B 2 S 4096,
   Gemma2-27B local S 8192 and global S 4096 with
   the softcap, and its saturated case with q x 8, recurrentgemma-9b hd 256
   window 2048 MQA, hubert-xlarge hd 80 non-causal S 1000, internvl2-2b hd
   128), per element and per row (``FLASH_BWD_TOL``, ``FLASH_BWD_ROW_RTOL``,
   sized by ``scripts/flash_bwd_replay.py``), two calls bit-equal at
   Llama's microbatch and at recurrentgemma's hd 256 (the head split, in
   both types), timed beside SDPA's backward with its bound and, at those two
   shapes, the plain version; then Llama-3.2-1B at full
   width in bf16 through ``train``: S 4096, a batch of 4 in 2
   microbatches, remat "full", fp32 moments, ``warmup_cosine``, the first
   step's gradients gated per leaf against impl='torch' (within
   ``LM_BF16_SPREAD`` times the plain bf16 gradient's distance from the
   plain fp32 one), ``TRAIN_STEPS`` steps with exact flash launch counts
   (forward, recompute, backward) and a falling loss, ms per step,
   tokens/s, peak memory, one step profiled (idle share; flash forward,
   flash backward, cuBLAS, glue), ``train`` started again from its
   checkpoint (the state restored bit for bit at the saved step), one
   step with int8 moments; then one training step of every other config
   but arctic at full width, cut to one period of its pattern (two
   layers, two periods, where a period is one layer), its gradients
   gated the same way
   (MoE: the routing gated as in phase 8e) and its launches counted;
8g. the distributed side of the LM stack, from phase 8f's Llama-3.2-1B
   state: ``repro_torch.launch.dryrun`` of that step on a 1 x 1 mesh (its
   batch of 4 in 2 microbatches, S 4096, remat "full", fp32 moments),
   traced on fake tensors on the host: its compute, memory and
   collective terms, dominant term, model FLOPs and peak GiB, beside the
   step's measured ms (MFU: model FLOPs over the step's seconds times
   the 989 TFLOP/s bf16 peak; the compute term's and the bound's shares
   of the step) and phase 8f's measured peak; then on one NCCL rank
   (``init_process_group("nccl", world_size=1)``, a ``file://``
   rendezvous; no other backend) ``distributed.zero``'s step against
   ``make_train_step``'s from the same state and batch, params, moments,
   step and loss bit for bit, its flash launches exact, both timed in
   turns; and ``compressed_allreduce_mean`` over every gradient leaf of
   that step, twice, each mean and error bit for bit the local
   ``dequantize(quantize(g + e))``, with the gradient's compression ratio;
9. one JSON line with every kernel's numbers — its launches in the forward
   its ``cell`` names (YOLOv3-tiny 416 b1 for the GEMM, im2col and fused
   Winograd kernels, VGG-16 224 b8 with ``winograd_fused=False`` for the
   three 3-pass kernels, YOLOv3-tiny 416 b1 int8 for the two int8
   kernels, the Llama-3.2-1B prefill for flash attention, YOLOv3-tiny 416
   b1 bfloat16 for the 16-bit GEMM, im2col and fused Winograd kernels,
   VGG-16 224 b8 with ``winograd_fused=False`` in bfloat16 for the three
   16-bit 3-pass kernels, the Llama-3.2-1B training run of phase 8f for
   the flash backward), and its times,
   errors and bounds summed over the calls of that forward — then the
   last line ``{"ok": true, "device": ...}``.

Any failure raises and exits non-zero before the last line is printed.  It
exits 1 at once when no CUDA device is visible, and fails to import the
port when run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
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
# MoE cells.  Two forwards that round apart can route a token near a
# top-k tie to other experts, and its logits then move far, so a logit
# gate holds on the tokens routed alike in every layer, at least this
# share of them (near-uniform routers of random weights leave granite's
# bf16 gate 1,281 of 4,096 tokens).  In fp32 the kernel's forward may
# route at most this share of the (layer, token) decisions otherwise than
# the plain one (granite's fp32 forward reads 0 of its 98,304; the limit,
# 9 of them, leaves room for a few near-ties).
MOE_MIN_AGREE = 1 / 8
MOE_FP32_FLIPS = 1e-4
# The flash backward kernel against attention_bwd_ref from the same (out,
# lse, dout), two gates as the forward's.  Per element, of max(1,
# max|ref|); per row of dq, dk or dv (hd values), of the row's norm
# floored at 1e-2 of the largest row's: a row whose gradient cancels (the
# first causal rows' dq, where p (dp - D) sums to ~0; dp and D are two fp32
# sums of hd products in other orders, so their difference keeps ~1e-7 of
# |dp|) is held at the others' scale, not at its own (in fp32 such a row
# read 2.1e-4 of its norm at a floor of 1e-3, at Llama's microbatch on
# the card).
# bf16: the kernel's tensor cores sum exact products of the bf16 inputs
# in fp32 and it rounds p and ds to bf16 before the dv, dk and dq
# products (as SDPA's backward does), where the plain version keeps them
# in fp32; both round each result once to bf16.  So the two differ by
# the rounding of p and ds, the sums' order and one bf16 rounding each:
# at most 6.5e-3 per element and 5.4e-3 per row in
# scripts/flash_bwd_replay.py (a CPU replay of the kernel's tiles,
# roundings and head split at Llama-3.2-1B's grouping, Gemma2-27B's
# window, softcap and saturated softcap, hd 256 MQA with the split and a
# ragged non-causal case); 1e-2 keeps a margin of about 1.5-2 over it.
# fp32: the forward's gates, against attention_bwd_ref's steps in float64
# (on float64 copies of the same inputs) and against the fp32 plain
# version, which takes D as rowsum(p o dp) over the row sum of p, as
# jax.vjp does, so its causal first row cancels to 0 and what the gate
# reads there is the kernel's own rounding of dp - D; each fp32 line prints
# the fp32 plain version's row errors from float64 beside.  At the
# saturated softcap (q x 8) the scores' exponents reach ~72, which fp32
# rounds to ~8e-6, and rows near one-hot cancel: there the fp32 plain
# version's own dq rows lie 9.63e-5 of the floor from float64 (the
# kernel's 4.14e-5), so it is printed, and the kernel held to float64
# alone.  The kernel's
# arithmetic (dv, dk and dq summed a tile at a time) is replayed on the
# CPU by scripts/flash_bwd_replay.py --fp32.
FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
FLASH_BWD_ROW_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
FLASH_BWD_ROW_FLOOR = 1e-2
# A bf16 training step's gradients against impl='torch' on the same
# weights and batch, per leaf: the relative norm of the kernel's bf16
# gradient from the plain fp32 gradient (the weights cast) at most
# LM_BF16_SPREAD times the plain bf16 gradient's, as the logit gates
# above.  Two bf16 backwards of random weights lie about as far from each
# other as from fp32 (Llama-3.2-1B at full width: 5 % per leaf either
# way, so no fixed bound tighter than bf16's own spread holds).
TRAIN_STEPS = 3           # steps of the Llama-3.2-1B training cell
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
    # No TPU kernel has a backward: the reference trains through plain XLA
    # attention differentiated by jax.value_and_grad.
    "flash_attention_bwd": ("none: the backward of "
                            "src/repro/kernels/flash_attention/kernel.py:69, "
                            "in place of jax.value_and_grad through "
                            "src/repro/models/attention.py:81"),
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
          "output_transform_16": "winograd_3pass_16",
          "flash_attention_bwd": "flash_attention_bwd"}
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
              "output_transform_16": "winograd16_output_transform_kernel",
              # Its three kernels: the row dot, dk/dv, dq.
              "flash_attention_bwd": "flash_bwd_"}
# The second kernels of the fp32, 16-bit and int8 im2col convs and GEMMs,
# launched by the calls that split K.  No name here or in CUDA_NAMES holds
# another as a substring.
SPLITK_REDUCE = "im2col_conv_splitk_reduce_kernel"
Q8_SPLITK_REDUCE = "im2col_conv_q8_splitk_reduce_kernel"
GEMM_SPLITK_REDUCE = "gemm_splitk_reduce_kernel"
GEMM_Q8_SPLITK_REDUCE = "gemm_q8_splitk_reduce_kernel"
# The 16-bit fused Winograd kernel's, launched by the calls that split C.
WINOGRAD16_SPLIT_REDUCE = "winograd16_split_reduce_kernel"
REDUCE_NAMES = (SPLITK_REDUCE, Q8_SPLITK_REDUCE, GEMM_SPLITK_REDUCE,
                GEMM_Q8_SPLITK_REDUCE, WINOGRAD16_SPLIT_REDUCE)


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


def counters():
    """Every kernel wrapper by kernel name: the inference kernels' (those a
    CUDA graph may capture) and the flash backward's."""
    from repro_torch.graphs import launch_counters
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    return {**launch_counters(), "flash_attention_bwd": flash_attention_bwd}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    """Launches per kernel since the last reset, kernels never launched
    left out."""
    return {k: fn.launches for k, fn in counters().items() if fn.launches}


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
    ``F.conv2d`` (cuDNN), einsum, and for the tuple multiply one
    ``torch.bmm`` of [V | V] by [U hi ; U lo] (concatenated along C before
    the timing: the same products and U bytes as the kernel), with the
    ``torch.bmm`` of V by U's hi part alone printed beside it.  The fused
    Winograd label gives its grid and C split, the tuple multiply's its
    work items and their width."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.conv_spec import ConvAlgorithm, apply_activation
    from repro_torch.core.winograd import AT, BT, _const, _tile_input, \
        split_transformed, transform_weights
    from repro_torch.kernels.gemm.ops import TILE_16, gemm16_smem_bytes
    from repro_torch.kernels.gemm.ops import call_splits_16 as gemm_splits16
    from repro_torch.kernels.gemm.ops import matmul16_bias_act
    from repro_torch.kernels.im2col_gemm.ops import call_splits_16, \
        conv16_geometry, im2col_conv16
    from repro_torch.kernels.winograd.ops import (
        FUSED_BLOCKS_16,
        call_splits_16 as fused_splits16,
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
        # As the network plan keeps them: B's rows padded to a multiple of
        # 8 (a view of the first N columns reaches the kernel).
        wm_rows = F.pad(pad_c(wm, 0), (0, -(-o // 8) * 8 - o))
        splits = gemm_splits16(m, o, phys_c)
        tiles = -(-m // TILE_16[0]) * -(-o // TILE_16[1])
        return [dict(
            base, kernel="gemm_16",
            label=(f"{head} gemm_16 {dtype} M={m} K={phys_c} N={o} "
                   f"tile={TILE_16[0]}x{TILE_16[1]}x{TILE_16[2]} "
                   f"items={tiles} grid="
                   f"{tiles * splits if splits > 1 else 'persistent'} "
                   f"cluster={splits} splits={splits} "
                   f"smem={gemm16_smem_bytes(phys_c, splits)}"),
            args=(pad_c(a, 1), wm_rows, bias),
            run=lambda a, wm, bias, o=o, act=act, impl="cuda":
                matmul16_bias_act(a, wm[:, :o], bias, act, impl=impl),
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
        splits = call_splits_16(b, oh, ow, phys_c, o)
        geom = conv16_geometry(phys_c, o, oh, ow, kh, kw,
                               *spec.stride, splits)
        return [dict(
            base, **conv_lib, kernel="im2col_conv_16",
            label=(f"{head} im2col_16 {dtype} {h}x{w}x{phys_c}->{oh}x{ow}x{o}"
                   f" k{kh} s{spec.stride[0]} tile={blocks[0]}x{blocks[2]}"
                   f"x{blocks[1]} {'raster' if geom['raster'] else 'runs'} "
                   f"items={b * geom['tiles_img'] * geom['o_blocks']}"
                   f" grid={b * geom['tiles_img'] * geom['o_blocks'] * splits
                            if splits > 1 else 'persistent'}"
                   f" cluster={splits} splits={splits} window="
                   f"{geom['segs']}x{geom['seg_h']}x{geom['win_w']} stages="
                   f"{geom['stages']} smem={geom['smem']}"),
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
        bt, _, bo = FUSED_BLOCKS_16
        splits = fused_splits16(n_t, phys_c, o)
        grid = -(-n_t // bt) * -(-o // bo) * splits
        return [dict(
            base, **conv_lib, kernel="winograd_fused_16",
            label=(f"{head} winograd_16 {dtype} {shape} blocks={blocks} "
                   f"grid={grid} splits={splits}"),
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
             label=(f"{head} tuple_multiply_16 {dtype} {shape} "
                    f"blocks={blocks} items="
                    f"{64 * -(-n_t // blocks[0]) * -(-o // blocks[2])}"),
             args=(v, u2, u.inv_scale),
             run=lambda v, u2, inv, impl="cuda": tuple_multiply16(
                 v, u2, inv, impl=impl),
             lib_args=(torch.cat([v[..., :c], v[..., :c]], -1).contiguous(),
                       torch.cat([u2[0, :, :c], u2[1, :, :c]], 1).contiguous()),
             library=torch.bmm,
             alt_library=("hi-only bmm", torch.bmm, (
                 v[..., :c].contiguous(), u2[0, :, :c].contiguous())),
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
        alt = ""
        if "alt_library" in case:
            alt_name, alt_fn, alt_args = case["alt_library"]
            alt_ms = cuda_ms(alt_fn, alt_args)
            alt = (f" ({alt_name} {alt_ms:.4f}, ms/that="
                   f"{ms / alt_ms:.3f})")
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
               else f" ms/library_ms={ms / library_ms:.3f}") + alt)
        agg = summary.setdefault(name, dict(
            calls=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
            bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0, cuda_core_bound_ms=0.0,
            alt_library_ms=0.0))
        agg["calls"] += 1
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["library_ms"] = (None if library_ms is None or agg["library_ms"]
                             is None else agg["library_ms"] + library_ms)
        agg["bound_ms"] += bound_ms
        agg["ops_ms" if t_ops >= t_bytes else "bytes_ms"] += bound_ms
        agg["cuda_core_bound_ms"] += cc_bound_ms or 0.0
        if alt:
            agg["alt_library_ms"] += alt_ms
        per_step.setdefault(case["step"], {})[name] = ms
    log(f"kernels {cell}: {n} calls checked in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, agg in summary.items():
        log(f"kernels {cell} {name} over {agg['calls']} calls: "
            f"ms={agg['ms']:.4f} plain_ms={agg['plain_ms']:.4f} library_ms="
            + ("-" if agg["library_ms"] is None else f"{agg['library_ms']:.4f}")
            + f" bound_ms={agg['bound_ms']:.5f}"
            + (f" fp32_cuda_core_bound_ms={agg['cuda_core_bound_ms']:.5f}"
               if agg["cuda_core_bound_ms"] else "")
            + (f" (hi-only bmm {agg['alt_library_ms']:.4f})"
               if agg["alt_library_ms"] else ""))
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


def planned_cuda_launches(netplan, batch=None, start=0, stop=None):
    """CUDA launches of each port kernel in one forward of ``netplan``'s
    ``steps[start:stop]`` at ``batch`` (None: the plan's; a pipeline
    stage runs a slice at microbatch size, a shard the whole plan at its
    share of the batch), by the profiler's name: the plan's count of each
    kernel, and each split-K reduce kernel once for each fp32 or int8
    im2col or GEMM call that splits and each 16-bit fused Winograd call
    that splits C (the 16-bit GEMM and im2col conv sum their splits in the
    same launch; the split counts follow the call's shapes)."""
    from repro_torch.core.conv_spec import ConvAlgorithm
    from repro_torch.kernels.gemm.ops import call_splits as gemm_splits
    from repro_torch.kernels.gemm.ops import call_splits_q8 as gemm_splits_q8
    from repro_torch.kernels.im2col_gemm.ops import call_splits, call_splits_q8
    from repro_torch.kernels.winograd.ops import \
        call_splits_16 as call_splits_w16

    batch = netplan.batch if batch is None else batch
    steps = netplan.steps[start:stop]
    want = {CUDA_NAMES[k]: n
            for k, n in netplan.kernel_launches(start, stop).items()}
    fp32 = [s for s in steps
            if s.layer.kind == "conv" and s.plan.dtype == "float32"]
    splits = sum(
        call_splits(batch, *s.out_hw, s.in_layout.phys_c,
                    s.out_layout.phys_c, s.plan.kernel_blocks[0]) > 1
        for s in fp32 if s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM)
    if splits:
        want[SPLITK_REDUCE] = splits
    q8 = sum(
        call_splits_q8(batch, *s.out_hw, s.in_layout.phys_c,
                       s.out_layout.phys_c, s.plan.kernel_blocks[0]) > 1
        for s in steps
        if s.layer.kind == "conv" and s.plan.dtype == "int8"
        and s.plan.algorithm is ConvAlgorithm.IM2COL_GEMM)
    if q8:
        want[Q8_SPLITK_REDUCE] = q8
    # A 1x1 conv's GEMM: M = B * OH * OW (the output map; a strided 1x1
    # subsamples its input first), K and N the physical channels.
    gemm = sum(
        gemm_splits(batch * s.out_hw[0] * s.out_hw[1],
                    s.out_layout.phys_c, s.in_layout.phys_c) > 1
        for s in fp32 if s.plan.algorithm is ConvAlgorithm.DIRECT)
    if gemm:
        want[GEMM_SPLITK_REDUCE] = gemm
    gemm_q8 = sum(
        gemm_splits_q8(batch * s.out_hw[0] * s.out_hw[1],
                       s.out_layout.phys_c, s.in_layout.phys_c) > 1
        for s in steps
        if s.layer.kind == "conv" and s.plan.dtype == "int8"
        and s.plan.algorithm is ConvAlgorithm.DIRECT)
    if gemm_q8:
        want[GEMM_Q8_SPLITK_REDUCE] = gemm_q8
    half = [s for s in steps
            if s.layer.kind == "conv" and s.plan.dtype in HALF]
    wino16 = sum(
        call_splits_w16(batch * -(-s.out_hw[0] // 6)
                        * -(-s.out_hw[1] // 6), s.in_layout.phys_c,
                        s.out_layout.phys_c) > 1
        for s in half if s.plan.algorithm is ConvAlgorithm.WINOGRAD
        and s.plan.winograd_fused)
    if wino16:
        want[WINOGRAD16_SPLIT_REDUCE] = wino16
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
    alone.  A trace that holds no device record at all (the profiler's
    tracing failed, as it has once on the card), or none of a planned
    port kernel (it lost them, as it has on the card: 7 records of 5
    forwards), is taken again, at most twice; its gate is the same."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                forward()
            torch.cuda.synchronize()
        # The device records in time order.
        kernels = sorted((ev for ev in prof.events()
                          if ev.device_type == DeviceType.CUDA),
                         key=lambda ev: ev.time_range.start)
        lost = [c for c in want or {}
                if not any(c in ev.name for ev in kernels)]
        if kernels and not lost:
            break
        log(f"profile {name}: the trace holds no record of "
            f"{', '.join(lost) if kernels else 'device work'} "
            f"(attempt {attempt + 1})")
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
    # Each port kernel's launches in forward order, median over the reps.
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
    from repro_torch.kernels.flash_attention.ref import attention_mask, unmasked_pairs

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
                # The causal flag, or a boolean mask for a window.
                mask = (attention_mask(s, sk, causal, window, "cuda")
                        if window > 0 else None)

                def sdpa(q, k, v):
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=mask, is_causal=causal and mask is None,
                        enable_gqa=True)

                library_ms = cuda_ms(sdpa, (q, k, v), rounds=3)
                why = ("F.scaled_dot_product_attention"
                       + (", its window as a boolean mask" if window > 0 else ""))
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


def lm_inputs(cfg, seq, g):
    """A cell's model input on the card, S positions in all: audio frames,
    patches before tokens, or tokens."""
    import torch

    if cfg.frontend == "audio_frames":
        return {"frames": torch.randn(1, seq, cfg.frontend_dim, generator=g,
                                      device="cuda")}
    toks = torch.randint(0, cfg.vocab_size, (1, seq - cfg.num_patches),
                         generator=g, device="cuda")
    if cfg.frontend == "vision_patches":
        return {"tokens": toks, "patch_embeds": torch.randn(
            1, cfg.num_patches, cfg.frontend_dim, generator=g, device="cuda")}
    return toks


def flash_want(cfg):
    """The launches of one forward: one flash call an attention layer."""
    n = sum(bt in ("attn", "local") for bt in cfg.pattern_layers)
    return {"flash_attention": n} if n else {}


@contextlib.contextmanager
def recorded_routes():
    """Every MoE layer's expert indices (T, k), in call order, of the
    eager forwards run inside: ``moe.route`` wrapped for the duration."""
    from repro_torch.models import moe

    routes, route = [], moe.route

    def recording(params, tokens, top_k):
        out = route(params, tokens, top_k)
        routes.append(out[3].clone())
        return out

    moe.route = recording
    try:
        yield routes
    finally:
        moe.route = route


def routing_agreement(a, b, seq):
    """(the (layer, token) routing decisions that differ between two
    forwards' routes, the (S,) mask of the tokens routed alike in every
    layer).  A decision is the set of a token's k experts: their order
    changes no output (a token's copies go to k different experts, so no
    other copy's rank in an expert moves), only the load-balance aux."""
    import torch

    same = torch.stack([(x.sort(-1).values == y.sort(-1).values).all(-1)
                        for x, y in zip(a, b)])
    return int((~same).sum()), same.all(0).reshape(-1, seq)[0]


def routed_alike(cfg, seq, label, routes, ref_routes, limit=None):
    """On an MoE cell, the tokens a logit gate holds on: those routed alike
    in every layer by the forward under test and its reference, at least
    ``MOE_MIN_AGREE`` of them, the (layer, token) decisions that differ
    at most ``limit`` (None: not bounded here).  Returns (the mask, a note
    for the cell's line); every token on a dense cell."""
    if not cfg.num_experts:
        return slice(None), ""
    flips, mask = routing_agreement(routes, ref_routes, seq)
    agree = int(mask.sum())
    note = (f"; routing flips cuda vs plain {flips} of {len(routes) * seq} "
            f"(layer, token) decisions"
            + ("" if limit is None else f" (limit {limit:.4g})")
            + f", gated on the {agree} of {seq} tokens that agree in every "
            f"layer (at least {MOE_MIN_AGREE * seq:.0f})")
    if (limit is not None and flips > limit) or agree < MOE_MIN_AGREE * seq:
        raise AssertionError(f"{label}: routing gate fails{note}")
    return mask, note


def to_float32_in_place(tree) -> None:
    """Cast every bf16 leaf of a parameter tree to fp32, one leaf at a
    time (the bf16 copy is freed as its fp32 copy is made, so the peak is
    the fp32 tree plus one leaf)."""
    import torch

    for k in list(tree.keys() if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            to_float32_in_place(tree[k])
        elif tree[k].dtype == torch.bfloat16:
            tree[k] = tree[k].float()


def lm_kernel_forward(cfg, params, inputs, name, main, profile=False):
    """``compile(cfg, params).run(inputs)`` on the card.  The first call
    captures (its seconds) and launches the flash kernel once an attention
    layer and nothing else; ``GRAPH_REPLAYS`` calls multiply the counts.
    ``main`` (the cell's dtype): ``LM_REPS`` replays timed and one
    profiled (busy time, idle share, the planned flash launches only);
    with ``profile``, the replay timed in turns beside the eager forward
    and a second shape captured into the same pool instead; else two
    replays timed.  Then, the graph freed, the eager forward of the same
    weights must equal the replay bit for bit: the MoE routes it records
    are the replay's.  Returns (logits, routes, launches, ms per forward)."""
    import torch

    import repro_torch

    want = flash_want(cfg)
    seq = lm_positions(inputs)
    cu = repro_torch.compile(cfg, params)
    reset_counts()
    t0 = time.perf_counter()
    y = cu.run(inputs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != {want}")
    check_replays(lambda: cu.run(inputs), counts, name)
    kernels = {CUDA_NAMES[k]: n for k, n in want.items()}
    line = ""
    if main and profile:
        ms = graph_vs_eager(name, lambda: cu.run(inputs),
                            lambda: cu.eager(inputs), LM_REPS, per_call=seq,
                            unit="tokens", want=kernels, detail=True,
                            profile_reps=3, warmup=1)["graph_ms"]
        check_shared_pool(cu, inputs, name)
    elif main:
        ms = forward_ms(lambda: cu.run(inputs), LM_REPS, warmup=1)
        busy, _ = profile_forward(lambda: cu.run(inputs), ms, f"{name} graph",
                                  reps=1, want=kernels, detail=True)
        line = (f" device busy {busy:.3f} ms, idle share "
                f"{max(0.0, 1.0 - busy / ms):.3f};")
    else:
        ms = forward_ms(lambda: cu.run(inputs), 2, warmup=1)
    del cu
    gc.collect()
    torch.cuda.empty_cache()
    with recorded_routes() as routes:
        y_eager = repro_torch.compile(cfg, params).eager(inputs)
    if not torch.equal(y, y_eager):
        rel, err, _ = compare_logits(y, y_eager)
        raise AssertionError(f"{name}: the replayed forward differs from the "
                             f"eager forward: rel {rel:.3g} max_abs_err "
                             f"{err:.3g}")
    del y_eager
    log(f"model {name}: first call (capture) {first_s:.2f} s; replay "
        f"ms_per_forward={ms:.3f} tokens_per_s={seq * 1e3 / ms:.1f};{line} "
        f"launches={counts}; equal to the eager forward")
    return y, routes, counts, ms


def lm_plain_forward(cfg, params, inputs, name):
    """The plain forward (``impl='torch'``), run eagerly (a graph of it
    would hold a second forward's activations and logits in its pool),
    its ms printed: (logits, its MoE routes)."""
    import torch

    import repro_torch

    plain = repro_torch.compile(cfg, params, repro_torch.ExecutionOptions(
        impl="torch"))
    t0 = time.perf_counter()
    with recorded_routes() as routes:
        y = plain.eager(inputs)
    torch.cuda.synchronize()
    log(f"model {name}: plain eager forward "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return y, routes


def lm_positions(inputs) -> int:
    """S of a model input: tokens, frames, or patches and tokens."""
    if not isinstance(inputs, dict):
        return inputs.shape[1]
    return sum(v.shape[1] for v in inputs.values())


def lm_prefill_cell(cfg, seq, name, profile=False, fp32_layers=None,
                    serve=False):
    """Phases 8 and 8e: one LM cell at full width (depth as ``cfg``), on
    seeded weights and input, S ``seq``.  In ``cfg.dtype``: the replayed
    kernel forward (``lm_kernel_forward``) and the plain one; with
    ``serve``, ``prefill_with_cache`` against that forward and the
    engines (``lm_serving_cell``).  The weights are then cast to fp32 in
    place, and the kernel's bf16 logits must lie no further from the
    plain fp32 forward of the same weights than ``LM_BF16_SPREAD`` times
    the plain bf16 logits (relative norm).  At ``fp32_layers`` of depth
    (None: all; 0: none) the fp32 forward through the kernel within
    ``NET_RTOL`` of max(1, max|ref|) of the plain one, and, with
    ``serve``, ``prefill_with_cache`` gated against it.  On MoE cells both
    logit gates hold on the tokens routed alike by the two forwards
    compared, after the routing gates of ``routed_alike``: bf16, the
    kernel's flips against the plain fp32 routes at most
    ``LM_BF16_SPREAD`` times the plain bf16 forward's; fp32, at most
    ``MOE_FP32_FLIPS`` of the decisions.  Returns the launches of one
    forward in ``cfg.dtype``."""
    import torch

    from repro_torch.models import transformer as tf

    t_cell = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, g)
    inputs = lm_inputs(cfg, seq, g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = (1, seq, cfg.vocab_size)

    dn = cfg.dtype
    y16, routes16, launches, _ = lm_kernel_forward(
        cfg, params, inputs, f"{name} {dn}", main=True, profile=profile)
    y16_ref, routes16_ref = lm_plain_forward(cfg, params, inputs,
                                             f"{name} {dn}")
    if serve:
        lm_prefill_check(cfg, params, inputs, y16, f"{name} {dn}")
        lm_serving_cell(cfg, params, name)
    to_float32_in_place(params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    y32_ref, routes32 = lm_plain_forward(c32, params, inputs,
                                         f"{name} float32")
    agree, note = routed_alike(cfg, seq, f"{name} {dn}", routes16,
                               routes16_ref)
    if cfg.num_experts:
        # Each bf16 forward's flips against the plain fp32 routes: the
        # kernel's at most LM_BF16_SPREAD times the plain forward's.
        flips = routing_agreement(routes16, routes32, seq)[0]
        plain_flips = routing_agreement(routes16_ref, routes32, seq)[0]
        note += (f"; flips against plain float32: cuda {flips} <= "
                 f"{LM_BF16_SPREAD} x plain {plain_flips}")
        if flips > LM_BF16_SPREAD * plain_flips:
            raise AssertionError(f"{name} {dn}: routing gate fails{note}")
    rel16, err16, scale16 = compare_logits(y16, y16_ref)
    rel_plain = compare_logits(y16_ref[:, agree], y32_ref[:, agree])[0]
    rel_cuda = compare_logits(y16[:, agree], y32_ref[:, agree])[0]
    gate = (f"vs plain float32: cuda rel {rel_cuda:.3g} <= {LM_BF16_SPREAD} "
            f"x plain rel {rel_plain:.3g}")
    if cfg.num_experts:
        note += (f"; over all tokens (not gated) cuda rel "
                 f"{compare_logits(y16, y32_ref)[0]:.3g}, plain rel "
                 f"{compare_logits(y16_ref, y32_ref)[0]:.3g}")
    log(f"model {name} {dn}: logits {shape} cuda vs plain rel={rel16:.3g} "
        f"max_abs_err={err16:.3g} max|ref|={scale16:.3g} ({gate}){note}; "
        f"init_s={init_s:.2f}")
    if not (bool(torch.isfinite(y16).all()) and y16.shape == shape
            and y16.dtype == tf.torch_dtype(dn)
            and rel_cuda <= LM_BF16_SPREAD * rel_plain):
        raise AssertionError(f"{name} {dn}: {gate} fails, or the logits are "
                             f"not finite {dn} of shape {shape}")
    del y16, y16_ref

    layers = cfg.num_layers if fp32_layers is None else fp32_layers
    if layers:
        full = layers == cfg.num_layers
        c = dataclasses.replace(c32, num_layers=layers)
        p = params if full else dict(params, layers=params["layers"][:layers])
        label = f"{name} float32" + ("" if full else f" ({layers} layers)")
        y, routes, _, _ = lm_kernel_forward(c, p, inputs, label, main=False)
        ref, ref_routes = ((y32_ref, routes32) if full
                           else lm_plain_forward(c, p, inputs, label))
        agree, note = routed_alike(c, seq, label, routes, ref_routes,
                                   MOE_FP32_FLIPS * len(routes) * seq)
        rel, err, scale = compare_logits(y[:, agree], ref[:, agree])
        tol = NET_RTOL * max(1.0, scale)
        log(f"model {label}: logits {tuple(y.shape)} cuda vs plain "
            f"rel={rel:.3g} max_abs_err={err:.3g} max|ref|={scale:.3g} "
            f"(max_abs_err <= {tol:.3g}){note}")
        if not (bool(torch.isfinite(y).all()) and y.shape == shape
                and y.dtype == torch.float32 and err <= tol):
            raise AssertionError(f"{label}: max_abs_err {err:.3g} > {tol:.3g},"
                                 f" or the logits are not finite float32 of "
                                 f"shape {shape}")
        del ref
        if serve:
            lm_prefill_check(c, p, inputs, y, label)
        del y, p
    del params, y32_ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"model {name}: peak device memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; cell "
        f"{time.perf_counter() - t_cell:.1f} s")
    return launches


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


def lm_prefill_check(cfg, params, inputs, y, name) -> None:
    """``prefill_with_cache`` through the kernel over the cell's input (an
    mLSTM layer in its chunked form, a recurrent layer returning its
    state), capacity S + 128 so that every window fits, launching the
    flash kernel once an attention layer: its last logits against the
    kernel forward's ``y``; then one ``decode_step`` from its cache
    against the plain forward one token longer.  Gated in fp32 (within
    ``NET_RTOL`` of max(1, max|ref|)), printed in 16 bits; the decode
    step is printed, not gated, on MoE cells, where the prompt's last
    token may meet a capacity that a step's one token does not."""
    import torch

    import repro_torch
    from repro_torch.models import transformer as tf

    seq = lm_positions(inputs)
    reset_counts()
    with torch.no_grad():
        last, cache = tf.prefill_with_cache(cfg, params, inputs, seq + 128)
        torch.cuda.synchronize()
        counts = read_counts()
        nxt = torch.ones((1, 1), dtype=torch.int64, device="cuda")
        step, _ = tf.decode_step(cfg, params, cache, nxt, seq)
    if counts != flash_want(cfg):
        raise AssertionError(f"{name} prefill_with_cache: launches {counts}")
    if isinstance(inputs, dict):
        ext = dict(inputs, tokens=torch.cat([inputs["tokens"], nxt], dim=1))
    else:
        ext = torch.cat([inputs, nxt], dim=1)
    plain = repro_torch.compile(cfg, params, repro_torch.ExecutionOptions(
        impl="torch"))
    ref_step = plain.eager(ext)[:, -1]
    fp32 = cfg.dtype == "float32"
    line, ok = [], True
    for what, a, ref, gated in (
            ("prefill vs the kernel forward", last, y[:, -1], fp32),
            ("next step vs the plain forward", step, ref_step,
             fp32 and not cfg.num_experts)):
        rel, err, scale = compare_logits(a[:, None], ref[:, None])
        tol = NET_RTOL * max(1.0, scale)
        line.append(f"{what} rel={rel:.3g} max_abs_err={err:.3g} max|ref|="
                    f"{scale:.3g} (tol {tol:.3g}"
                    f"{'' if gated else ', printed, not gated'})")
        ok = ok and bool(torch.isfinite(a).all()) and (err <= tol or not gated)
    log(f"prefill {name}: launches {counts}; " + "; ".join(line))
    if not ok:
        raise AssertionError(f"prefill {name}: " + "; ".join(line))
    del cache, plain


def lm_serving_cell(cfg, params, name):
    """``.serve(batch_size=4, capacity=128)`` answers 6 requests (8 prompt
    tokens, 12 new, greedy) through the engine's captured decode step:
    its tokens equal to the same engine with its step run eagerly
    (``EagerServingEngine``) and to a greedy ``decode_step`` loop on the
    card (the requests 4 at a time in rows of their own, at one position,
    the rows of a short chunk fed token 0 and not live); one decode step's
    replay beside the eager step, timed in turns and profiled (no port
    kernel in either trace); a greedy step through the engine's guarded
    call beside the replay with an argmax and its copy."""
    import torch

    import repro_torch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import EagerServingEngine

    batch, capacity, n_req, prompt_len, new = 4, 128, 6, 8, 12
    compiled = repro_torch.compile(cfg, params)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=prompt_len)
               for _ in range(n_req)]
    # The graph engine captures its decode step when it is made: the
    # capture's warm-up loads the decode path's kernels before either run
    # is timed.
    t0 = time.perf_counter()
    graph_engine = compiled.serve(batch_size=batch, capacity=capacity)
    capture_s = time.perf_counter() - t0
    engines = {"eager": EagerServingEngine.from_compiled(
                   compiled, batch_size=batch, capacity=capacity),
               "graph": graph_engine}
    answers, seconds = {}, {}
    for kind, eng in engines.items():
        uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        seconds[kind] = time.perf_counter() - t0
        answers[kind] = [res[u] for u in uids]
    results = answers["graph"]
    if results != answers["eager"]:
        raise AssertionError(f"{name}: the graph engine's tokens {results} "
                             f"differ from the eager engine's {answers['eager']}")
    dt = seconds["graph"]
    total = sum(len(v) for v in results)

    def greedy(chunk):
        cache = tf.init_cache(cfg, batch, capacity, "cuda")
        toks = np.zeros((batch, prompt_len + new), np.int64)
        toks[:len(chunk), :prompt_len] = chunk
        live = torch.arange(batch, device="cuda") < len(chunk)
        with torch.no_grad():
            for pos in range(prompt_len + new - 1):
                logits, cache = tf.decode_step(
                    cfg, params, cache,
                    torch.from_numpy(toks[:, pos:pos + 1]).to("cuda"),
                    torch.full((batch,), pos, dtype=torch.int64, device="cuda"),
                    live=live)
                if pos >= prompt_len - 1:
                    toks[:len(chunk), pos + 1] = (
                        logits.argmax(dim=-1).cpu().numpy()[:len(chunk)])
        return [list(map(int, row[prompt_len:])) for row in toks[:len(chunk)]]

    want = [out for i in range(0, n_req, batch)
            for out in greedy(prompts[i:i + batch])]
    for i, (got, w) in enumerate(zip(results, want)):
        if got != w:
            raise AssertionError(f"{name}: request {i + 1} got {got}, a "
                                 f"greedy decode_step loop gives {w}")
    log(f"serve {name}: {n_req} requests, {total} tokens in {dt:.3f} s "
        f"({total / dt:.1f} tokens/s; the eager engine {seconds['eager']:.3f}"
        f" s, {total / seconds['eager']:.1f} tokens/s; decode step captured "
        f"in {capture_s:.2f} s) batch={batch} capacity={capacity}; tokens "
        f"equal a greedy decode_step loop and the eager engine's; first "
        f"request {results[0]}")
    # Where a decode step's time goes: one batched step of the engine, its
    # graph's replay beside the same step run eagerly.
    engine = graph_engine
    engine.pos[:] = np.arange(batch)
    tokens, live = np.zeros((batch, 1), np.int64), np.ones(batch, bool)
    step_args = (torch.zeros((batch, 1), dtype=torch.int64, device="cuda"),
                 torch.arange(batch, device="cuda"),
                 torch.ones(batch, dtype=torch.bool, device="cuda"))
    graph_vs_eager(f"decode step {name} batch={batch}",
                   lambda: engine._decode(tokens, live),
                   lambda: engine.step(*step_args), 10, per_call=batch,
                   unit="tokens", want={}, detail=True, host_rows=8)
    # A greedy step through the guarded call (replay, one copy of the
    # graph's greedy tokens and finiteness flags, the check) beside the
    # replay with an argmax after it and its copy.
    steps = {
        "bare": lambda: engine._decode(tokens, live).argmax(dim=-1).tolist(),
        "guarded": lambda: engine._guarded_decode(tokens, live)[0][1].tolist(),
    }
    reps = {}
    for kind in ("bare", "guarded", "bare", "guarded"):
        reps.setdefault(kind, []).append(forward_ms(steps[kind], 20))
    bare, guarded = min(reps["bare"]), min(reps["guarded"])
    log(f"decode step {name} batch={batch} on the host's clock: replay, "
        f"argmax and copy {bare:.4f} ms, through the guarded call "
        f"{guarded:.4f} ms ({guarded - bare:+.4f} ms; best of two runs of "
        f"20)")
    del engines, engine, graph_engine, compiled
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8e: the MoE, recurrent and frontend LM families


def family_phase(lm_configs) -> None:
    """Phase 8e: the six MoE, recurrent and frontend configs through
    ``lm_prefill_cell``, one at a time, each freed before the next."""
    cells = [
        ("granite-moe-1b-a400m", {}, 4096, None, True),
        # Its 128 experts are 26.8 GB a layer in bf16 (53.6 in fp32).
        ("arctic-480b", {"num_layers": 1}, 2048, 0, False),
        ("recurrentgemma-9b", {}, 4096, 3, True),
        ("xlstm-125m", {}, 4096, None, True),
        ("hubert-xlarge", {}, 1000, None, False),
        ("internvl2-2b", {}, 1024, None, True),
    ]
    for arch, cut, seq, fp32_layers, serve in cells:
        cfg = dataclasses.replace(lm_configs.get_config(arch), **cut)
        name = (f"{arch}" + (f" ({cfg.num_layers} layers)" if cut else "")
                + f" S{seq} b1")
        lm_prefill_cell(cfg, seq, name, fp32_layers=fp32_layers,
                        serve=serve and cfg.supports_decode)


# ---------------------------------------------------------------------------
# Phase 8f: LM training


def flash_bwd_errors(got, ref, dname):
    """(max |got - ref|, its gate, the largest per-row relative error with
    the row floor) of one gradient."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    tol = FLASH_BWD_TOL[dname] * max(1.0, float(ref.abs().max()))
    norm = ref.norm(dim=-1)
    row = float(((got - ref).norm(dim=-1)
                 / norm.clamp_min(FLASH_BWD_ROW_FLOOR * float(norm.max()))).max())
    return err, tol, row


def flash_bwd_rows(grads, refs) -> str:
    """The fp32 per-row errors (with the row floor) of dq, dk and dv."""
    return " ".join(f"{n} {flash_bwd_errors(x, r, 'float32')[2]:.3g}"
                    for n, x, r in zip(("dq", "dk", "dv"), grads, refs))


def flash_bwd_ptxas() -> list:
    """One line per backward kernel instance of the build log: kernel, head
    dim and type, ptxas' registers and spill bytes, and for the dk/dv and
    dq kernels the dynamic shared memory their launch asks for (the
    library's repro_flash_attention_bwd_smem)."""
    import ctypes

    from repro_torch.kernels import _build

    smem = _build.load("flash_attention_bwd", "repro_flash_attention_bwd_smem",
                       [ctypes.c_int] * 3)
    lines, head, spill = [], None, ""
    for line in _build.build_logs.get("flash_attention_bwd", "").splitlines():
        if "Compiling entry function" in line:
            # The two bodies' kernels are in namespaces flash_bwd_fp32 and
            # flash_bwd_bf16, templated on the head dim.
            m = re.search(
                r"flash_bwd_(fp32|bf16)\d+flash_bwd_(dkdv|dq)_kernelILi(\d+)E", line)
            d = re.search(r"flash_bwd_dot_kernelI(f|13__nv_bfloat16)", line)
            r = re.search(r"flash_bwd_reduce_kernelI(f|13__nv_bfloat16)", line)
            kind = d or r
            head = (f"flash_bwd {m.group(2)} hd {m.group(3)} {m.group(1)}" if m
                    else f"flash_bwd {'dot' if d else 'reduce'} "
                    f"{'fp32' if kind.group(1) == 'f' else 'bf16'}"
                    if kind else None)
            shared = ""
            if m:
                n = smem(int(m.group(3)), int(m.group(1) == "bf16"),
                         int(m.group(2) == "dq"))
                shared = f", {n} bytes dynamic shared memory"
        elif head and "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        elif head and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{head}: {regs} registers, {spill}{shared}")
            head = None
    return lines


def check_flash_bwd(hw, cells, saturated=(), plain_timed=(), bit_equal=()):
    """Phase 8f's kernel check: the flash backward kernel against its plain
    version (attention_bwd_ref) at each trained config's attention shape,
    in bf16 and fp32, from the kernel forward's own (out, lse) and one
    seeded dout: dq, dk and dv per element and per row
    (``FLASH_BWD_TOL``, ``FLASH_BWD_ROW_RTOL``), the forward's lse
    against ``attention_ref_lse``'s, finite.  Timed (cold operands)
    beside the plain version and SDPA's backward where one PyTorch call
    computes the function (no softcap); the bound is the backward's five
    products of 2 hd FLOPs per valid pair and head (s, dp, dv, dk, dq)
    over the bf16 tensor-core peak, or in fp32 three TF32 products each
    (3xTF32) over the TF32 peak with the CUDA-core bound beside, or the
    bytes of q, k, v, o, dout, lse read and dq, dk, dv written, whichever
    is larger.  ``saturated`` cells take q x 8 (the softcap's bend: ds
    shrinks by 1 - tanh^2) and are not timed; the plain version is timed
    at the ``plain_timed`` cells only.  At the ``bit_equal`` cells a second
    call on the same inputs must give the same bits (no atomics; the head
    split sums its groups in a fixed order).  Returns each timed
    case's numbers by (cell, dtype)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref,
        attention_ref_lse,
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ops import bwd_head_split
    from repro_torch.kernels.flash_attention.ref import attention_mask, unmasked_pairs

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for cell, (b, s, sk, h, kv, hd, causal, window, cap) in cells.items():
            q = torch.randn(b, s, h, hd, generator=g, device="cuda")
            q = (q * 8 if cell in saturated else q).to(dtype)
            k, v = (torch.randn(b, sk, kv, hd, generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            do = torch.randn(b, s, h, hd, generator=g, device="cuda").to(dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = flash_attention(*leaves, causal, window, cap)
            lse = o.grad_fn.saved_tensors[4]        # the forward's, (B, H, S)
            grads = torch.autograd.grad(o, leaves, do)
            o = o.detach()
            del leaves
            args = (q, k, v, o, do, lse)
            plain_text, plain_errs = "", []
            if dtype == torch.float32:
                # Held to the plain steps in float64 and to the fp32 plain
                # version, both gated, but at a saturated cell, where the
                # fp32 plain version is printed (FLASH_BWD_ROW_FLOOR's note).
                refs = attention_bwd_ref(*(a.double() for a in args), causal,
                                         window, cap)
                plain = attention_bwd_ref(*args, causal, window, cap)
                errs32 = [flash_bwd_errors(x, r, dname)
                          for x, r in zip(grads, plain)]
                plain_errs = [] if cell in saturated else errs32
                plain_text = (f"; against the fp32 plain version"
                              f"{' (printed, not gated)' if cell in saturated else ''}"
                              f": max_abs_err {max(e for e, _, _ in errs32):.3g} "
                              f"row_err {flash_bwd_rows(grads, plain)}; the fp32 "
                              f"plain version's row_err from float64 "
                              f"{flash_bwd_rows(plain, refs)}")
                del plain
            else:
                refs = attention_bwd_ref(*args, causal, window, cap)
            lse_err = float((lse - attention_ref_lse(q, k, v, causal, window,
                                                     cap)[1]).abs().max())
            torch.cuda.synchronize()
            label = (f"flash_attention_bwd {cell} {dname} B={b} S={s} Sk={sk} "
                     f"H={h} KV={kv} hd={hd} causal={causal} window={window} "
                     f"cap={cap}")
            errs = [flash_bwd_errors(x, r, dname) for x, r in zip(grads, refs)]
            row_tol = FLASH_BWD_ROW_RTOL[dname]
            ok = (all(bool(torch.isfinite(x).all()) and x.dtype == dtype
                      for x in grads) and lse_err <= 1e-4 * max(1.0, float(lse.abs().max()))
                  and all(e <= t and r <= row_tol
                          for e, t, r in errs + plain_errs))
            text = " ".join(f"{n}: max_abs_err={e:.3g} (tol {t:.3g}) row_err="
                            f"{r:.3g} (tol {row_tol:.3g})"
                            for n, (e, t, r) in zip(("dq", "dk", "dv"), errs))
            text += plain_text
            if not ok:
                raise AssertionError(f"{label}: kernel disagrees with its plain "
                                     f"version: {text}; lse err {lse_err:.3g}")
            max_err = max(e for e, _, _ in errs)
            split = bwd_head_split(b, kv, sk, h // kv, hd,
                                   torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
            text += f"; head split {split}"
            if cell in bit_equal:
                again = flash_attention_bwd(q, k, v, o, do, lse, causal,
                                            window, cap)
                if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                    raise AssertionError(f"{label}: two backward calls on the "
                                         f"same inputs differ (split {split})")
                text += ", two calls bit-equal"
                del again
            del grads, refs
            if cell in saturated:
                log(f"kernel {label} (q x 8): {text}; lse err {lse_err:.3g}")
                continue
            ms = cuda_ms(lambda *a: flash_attention_bwd(*a, causal, window, cap),
                         args, rounds=3)
            plain_ms = (cuda_ms(lambda *a: attention_bwd_ref(
                *a, causal, window, cap), args, rounds=1)
                if cell in plain_timed else None)
            if cap > 0:
                library_ms, why = None, "no PyTorch call computes the tanh softcap"
            else:
                mask = (attention_mask(s, sk, causal, window, "cuda")
                        if window > 0 else None)
                ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (q, k, v))
                y = F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask, is_causal=causal and mask is None,
                    enable_gqa=True)
                dy = do.transpose(1, 2)
                library_ms = cuda_ms(lambda dy: torch.autograd.grad(
                    y, (ql, kl, vl), dy, retain_graph=True), (dy,), rounds=3)
                why = ("the backward of F.scaled_dot_product_attention"
                       + (", its window as a boolean mask" if window > 0 else ""))
                if dtype == torch.float32:
                    why += ", TF32 off"
                del y, ql, kl, vl
            pairs = unmasked_pairs(s, sk, causal, window)
            flops = 10 * b * h * hd * pairs
            core_ms = flops / hw.peak_flops_fp32 * 1e3
            t_ops = (flops / hw.peak_flops_bf16 * 1e3 if dtype == torch.bfloat16
                     else 3 * flops / hw.peak_flops_tf32 * 1e3)
            t_bytes = (nbytes(args) + nbytes((q, k, v))) / hw.hbm_bandwidth * 1e3
            bound_ms = max(t_ops, t_bytes)
            out[cell, dname] = dict(
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes")
            log(f"kernel {label}: {text}; lse err {lse_err:.3g}; ms={ms:.4f} "
                + ("" if plain_ms is None else f"plain_ms={plain_ms:.4f} ")
                + "library_ms="
                + ("-" if library_ms is None else f"{library_ms:.4f}")
                + f" ({why}) bound_ms={bound_ms:.5f} ({out[cell, dname]['bound_by']}"
                + ("" if dtype == torch.bfloat16 else
                   f"; 3xTF32; fp32 CUDA-core bound {core_ms:.5f}")
                + f") pairs={pairs} share_of_bound={bound_ms / ms:.4f} "
                f"tflops={flops / ms * 1e-9:.1f}"
                + ("" if library_ms is None
                   else f" ms/library_ms={ms / library_ms:.3f}"))
    return out


@contextlib.contextmanager
def following_routes(routes):
    """Every MoE layer routes its tokens to the experts ``routes`` holds for
    it (by its router's storage), its gate weights its own probabilities
    at those experts, renormalized: ``moe.route`` wrapped for the
    duration, so forwards that round apart route alike."""
    from repro_torch.models import moe

    route = moe.route

    def following(params, tokens, top_k):
        logits, probs, _, _ = route(params, tokens, top_k)
        idx = routes[params["router"].data_ptr()]
        w = probs.gather(-1, idx)
        return logits, probs, w / w.sum(-1, keepdim=True).clamp_min(1e-9), idx

    moe.route = following
    try:
        yield
    finally:
        moe.route = route


def grad_spread_gate(cfg, params, batch, name):
    """The first step's gradients (``value_and_grad`` of ``loss_fn``)
    through the kernels against impl='torch' on the same weights and
    batch: per leaf, the kernel's bf16 gradient within ``LM_BF16_SPREAD``
    times the plain bf16 gradient's relative distance from the plain fp32
    gradient of the weights cast.  MoE configs: the routing first, as
    phase 8e gates it (``routed_alike``: the two bf16 forwards route at
    least ``MOE_MIN_AGREE`` of the tokens alike in every layer; the
    kernel's flips against the fp32 routes at most ``LM_BF16_SPREAD``
    times the plain forward's); then the three gradients with every token
    routed alike, each forward following the fp32 forward's routes
    (``following_routes``): a token sent to other experts moves the
    experts' and the router's gradients by far more than rounding (the
    router's leaf read 1.32-1.55 x the plain distance on the card at
    granite-moe's two layers, with the flips left in or with the flipped
    tokens masked out of the loss).  Frees what it makes; returns the
    worst leaf's ratio."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import value_and_grad

    seq = next(iter(batch.values())).shape[1]
    seq += cfg.num_patches if cfg.frontend == "vision_patches" else 0
    p32 = tree_lib.tree_map(lambda t: t.float(), params)
    sides = (("cuda", cfg, params), ("torch", cfg, params),
             ("torch", dataclasses.replace(cfg, dtype="float32"), p32))
    note, follow = "", contextlib.nullcontext()
    if cfg.num_experts:
        routes = []
        with torch.no_grad():
            for impl, c, p in sides:
                with recorded_routes() as r:
                    tf.forward_hidden(c, p, batch, impl)
                routes.append(r)
        r_cu, r_pl, r_32 = routes
        _, note = routed_alike(cfg, seq, name, r_cu, r_pl)
        flips = routing_agreement(r_cu, r_32, seq)[0]
        plain_flips = routing_agreement(r_pl, r_32, seq)[0]
        note += (f"; flips against plain float32: cuda {flips} <= "
                 f"{LM_BF16_SPREAD} x plain {plain_flips}; gradients with "
                 f"every forward on the fp32 routes")
        if flips > LM_BF16_SPREAD * plain_flips:
            raise AssertionError(f"{name}: routing gate fails{note}")
        # The routers are fp32 in every copy of the weights: one storage
        # each, in layer order.
        follow = following_routes({
            layer["moe"]["router"].data_ptr(): idx
            for layer, idx in zip(params["layers"], r_32)})
    with follow:
        (loss_cu, _), g_cu = value_and_grad(sides[0][1], sides[0][2], batch, "cuda")
        (loss_pl, _), g_pl = value_and_grad(sides[1][1], sides[1][2], batch, "torch")
        (loss_32, _), g_32 = value_and_grad(sides[2][1], sides[2][2], batch, "torch")
    del p32, sides
    worst, bad, n = (0.0, ""), [], 0
    for (path, a), b, c in zip(tree_lib.leaves_with_paths(g_cu),
                               tree_lib.leaves(g_pl), tree_lib.leaves(g_32)):
        ref = float(c.norm())
        if ref == 0.0:
            if float(a.float().norm()) or float(b.float().norm()):
                bad.append(f"{path}: nonzero where fp32 is 0")
            continue
        r_cu_ = float((a.float() - c).norm()) / ref
        r_pl_ = float((b.float() - c).norm()) / ref
        ratio = r_cu_ / max(r_pl_, 1e-30)
        n += 1
        if ratio > worst[0]:
            worst = (ratio, f"{path} (cuda {r_cu_:.3g}, plain {r_pl_:.3g})")
        if not (torch.isfinite(a).all() and r_cu_ <= LM_BF16_SPREAD * r_pl_):
            bad.append(f"{path}: cuda rel {r_cu_:.3g} > {LM_BF16_SPREAD} x "
                       f"plain rel {r_pl_:.3g}")
        if r_cu_ > 0.5:
            bad.append(f"{path}: cuda rel {r_cu_:.3g} from fp32")
    cu_pl = max(float((a.float() - b.float()).norm()) / max(float(b.float().norm()), 1e-30)
                for a, b in zip(tree_lib.leaves(g_cu), tree_lib.leaves(g_pl)))
    log(f"train {name}: first-step gradients, {n} leaves: each within "
        f"{LM_BF16_SPREAD} x the plain bf16 gradient's distance from plain "
        f"fp32 (worst ratio {worst[0]:.3f} at {worst[1]}); largest leaf "
        f"distance cuda vs plain bf16 {cu_pl:.3g}; loss cuda {float(loss_cu):.5f}"
        f" plain {float(loss_pl):.5f} fp32 {float(loss_32):.5f}{note}")
    if bad or not torch.isfinite(loss_cu):
        raise AssertionError(f"train {name}: gradient gate fails: {bad[:5]}")
    del g_cu, g_pl, g_32
    gc.collect()
    torch.cuda.empty_cache()
    return worst[0]


def step_breakdown(step, ms_per_step, name):
    """One profiled call of ``step``: device busy ms and idle share, and
    the busy time split into the flash kernels (forward, backward), cuBLAS
    products and the rest (PyTorch's elementwise, reductions, copies:
    the eager glue)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    groups = {"flash forward": 0.0, "flash backward": 0.0, "cuBLAS": 0.0,
              "eager glue": 0.0}
    for ms, _, key in rows:
        if "flash_attention" in key:
            groups["flash forward"] += ms
        elif "flash_bwd_" in key:
            groups["flash backward"] += ms
        elif any(t in key for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
            groups["cuBLAS"] += ms
        else:
            groups["eager glue"] += ms
    busy = sum(groups.values())
    log(f"profile {name}: device busy {busy:.2f} ms of {ms_per_step:.2f} ms per "
        f"step, idle share {max(0.0, 1.0 - busy / ms_per_step):.3f}; "
        + ", ".join(f"{k} {v:.2f} ms ({v / busy:.3f})" for k, v in groups.items())
        + f" of busy; {sum(r[1] for r in rows)} kernel launches")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        log(f"  profile {ms:.3f} ms x{n} {key[:90]}")
    return busy


def train_llama(lm_configs, flash_bwd_ms):
    """Llama-3.2-1B at full width in bf16 through ``train``: S 4096 (the
    train_4k cell's length), a batch of 4 in 2 microbatches, remat
    "full", fp32 moments, warmup_cosine; the first step's gradients gated
    on its first row (``grad_spread_gate``); ``TRAIN_STEPS`` steps with
    the launch counts exact (per microbatch each attention layer's
    forward, its recompute, and one backward), the loss finite and
    falling, ms per step, tokens/s and peak memory; one step profiled;
    then ``train`` started again from its checkpoint (the state restored
    bit for bit at the saved step) and one step with int8 moments.
    Returns (the cell's name, the backward kernel's summary for the
    kernels line, its launches, the restored state on the host with the
    cell's config, shape, optimizer, microbatches, ms per step and peak
    GiB)."""
    import shutil
    import tempfile

    import torch

    from repro_torch import optim
    from repro_torch import tree as tree_lib
    from repro_torch.configs import SHAPES, ShapeSpec
    from repro_torch.data import batch_for
    from repro_torch.models import transformer as tf
    from repro_torch.train import TrainRunConfig, train
    from repro_torch.train.step import make_train_step

    cfg = lm_configs.get_config("llama3.2-1b")
    seq, batch, accum = SHAPES["train_4k"].seq_len, 4, 2
    shape = ShapeSpec("train_4k b4", seq, batch, "train")
    name = f"llama3.2-1b train S{seq} b{batch} accum {accum}"
    opt = optim.AdamWConfig(lr=optim.warmup_cosine(3e-4, 2, 10))
    out = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # The first step's weights and batch, as train draws them.
        params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
        first = {k: v[:1] for k, v in batch_for(cfg, shape, 0, seed=SEED,
                                                 device="cuda").items()}
        grad_spread_gate(cfg, params, first, f"{name} (step 0, row 0)")
        del params, first
        gc.collect()
        torch.cuda.empty_cache()

        run = TrainRunConfig(steps=TRAIN_STEPS, checkpoint_every=10 ** 6,
                             log_every=1, seed=SEED, out_dir=out, grad_accum=accum)
        torch.cuda.reset_peak_memory_stats()
        state = {}
        reset_counts()
        t0 = time.perf_counter()
        last = train(cfg, shape, opt, run, device="cuda", state=state)
        total_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_attn = cfg.num_layers
        want = {"flash_attention": TRAIN_STEPS * accum * 2 * n_attn,
                "flash_attention_bwd": TRAIN_STEPS * accum * n_attn}
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs]
        step_s = [r["sec"] for r in recs[1:]]
        ms = 1e3 * statistics.median(step_s)
        log(f"train {name}: {TRAIN_STEPS} steps in {total_s:.1f} s (init, "
            f"steps, checkpoint); loss {' '.join(f'{x:.4f}' for x in losses)}; "
            f"ms per step {ms:.1f} (median of steps 1-{TRAIN_STEPS - 1}; step 0 "
            f"{1e3 * recs[0]['sec']:.1f}); tokens/s {batch * seq * 1e3 / ms:.0f}; "
            f"peak device memory allocated {peak:.2f} GiB; launches {counts} "
            f"(want {want}); last {last}")
        if not (counts == want and all(np.isfinite(losses))
                and losses[-1] < losses[0] and len(recs) == TRAIN_STEPS):
            raise AssertionError(f"train {name}: launches {counts} != {want}, or "
                                 f"the loss is not finite and falling: {losses}")

        # One more step, profiled (its result dropped).
        step = make_train_step(cfg, opt, accum, "cuda")
        b3 = batch_for(cfg, shape, TRAIN_STEPS, seed=SEED, device="cuda")
        step(state["params"], state["opt_state"], b3)     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state["params"], state["opt_state"], b3)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        step_breakdown(lambda: step(state["params"], state["opt_state"], b3),
                       step_ms, f"{name} one step")
        del b3

        # Restart from the checkpoint the run wrote at its last step.
        again = {}
        t0 = time.perf_counter()
        rest = train(cfg, shape, opt, run, device="cuda", state=again)
        resume_s = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tree_lib.leaves([state["params"], state["opt_state"]]),
            tree_lib.leaves([again["params"], again["opt_state"]])))
        log(f"train {name}: restarted from its checkpoint in {resume_s:.1f} s: "
            f"start step {again['start_step']} (saved at {TRAIN_STEPS}), params "
            f"and moments bit-equal to the saved ones: {same}; {rest}")
        if not (same and again["start_step"] == TRAIN_STEPS):
            raise AssertionError(f"train {name}: resume is not at step "
                                 f"{TRAIN_STEPS} with the saved state")
        # Phase 8g starts from this state: held on the host meanwhile.
        trained = dict(params=tree_lib.tree_map(lambda t: t.cpu(), again["params"]),
                       opt_state=tree_lib.tree_map(lambda t: t.cpu(),
                                                   again["opt_state"]),
                       cfg=cfg, shape=shape, opt=opt, accum=accum, ms=ms,
                       peak_gib=peak)
        del state, again
        gc.collect()
        torch.cuda.empty_cache()

        int8 = optim.AdamWConfig(lr=opt.lr, moment_dtype="int8")
        st8 = {}
        m8 = train(cfg, shape, int8, dataclasses.replace(
            run, steps=1, out_dir=os.path.join(out, "int8")), device="cuda",
            state=st8)
        moment = st8["opt_state"].m["layers"][0]["mixer"]["wq"]
        log(f"train {name} int8 moments: one step {m8}; moment "
            f"{type(moment).__name__} {tuple(moment.q.shape)} {moment.q.dtype}")
        if not (np.isfinite(m8["loss"]) and isinstance(moment, optim.QTensor)):
            raise AssertionError(f"train {name} int8: loss {m8}")
        del st8
    finally:
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    n = counts["flash_attention_bwd"]
    f = flash_bwd_ms
    summary = {"flash_attention_bwd": dict(
        max_abs_err=f["max_abs_err"], ms=n * f["ms"], plain_ms=n * f["plain_ms"],
        library_ms=None if f["library_ms"] is None else n * f["library_ms"],
        bound_ms=n * f["bound_ms"],
        ops_ms=n * f["bound_ms"] if f["bound_by"] == "operations" else 0.0,
        bytes_ms=n * f["bound_ms"] if f["bound_by"] == "bytes" else 0.0)}
    return name, summary, counts, trained


def train_families(lm_configs):
    """One training step of every other config but arctic (its one layer's
    experts alone need 107 GB of fp32 moments) at full width, cut to one
    period of its pattern where a period is longer than one layer, else
    to two layers (two periods), on one row: the first step's gradients
    gated against impl='torch' (``grad_spread_gate``), then
    ``make_train_step``'s step through the kernels, its loss finite and
    its launch counts exact (one backward an attention layer; one
    forward, and a second where the layer's period is checkpointed: two
    periods or more, as the reference stacks and rematerializes them)."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import batch_for
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import make_train_step

    seqs = {"qwen1.5-0.5b": 4096, "granite-34b": 4096, "gemma2-27b": 4096,
            "granite-moe-1b-a400m": 4096, "recurrentgemma-9b": 4096,
            # No attention: its three backwards through the 1,024 sLSTM
            # steps hold no kernel, so a shorter row keeps the time.
            "xlstm-125m": 1024, "hubert-xlarge": 1000, "internvl2-2b": 1024}
    opt = optim.AdamWConfig(lr=optim.constant(1e-4))
    for arch, seq in seqs.items():
        t0 = time.perf_counter()
        base = lm_configs.get_config(arch)
        cfg = dataclasses.replace(base, num_layers=max(2, len(base.layer_pattern)))
        name = f"{arch} ({cfg.num_layers} layers) train S{seq} b1"
        params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
        batch = batch_for(cfg, ShapeSpec("t", seq, 1, "train"), 0, seed=SEED,
                          device="cuda")
        ratio = grad_spread_gate(cfg, params, batch, name)
        # A layer inside a checkpointed period runs its forward twice.
        n_periods, pat, _ = tf._period_split(cfg)
        attn = ("attn", "local")
        n_attn = sum(t in attn for t in cfg.pattern_layers)
        again = (n_periods * sum(t in attn for t in pat)
                 if cfg.remat != "none" else 0)
        want = ({"flash_attention": n_attn + again,
                 "flash_attention_bwd": n_attn} if n_attn else {})
        reset_counts()
        _, st, m = make_train_step(cfg, opt, 1, "cuda")(
            params, optim.init(opt, params), batch)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"train {name}: one step {({k: round(float(v), 5) for k, v in m.items()})}"
            f"; launches {counts} (want {want}); worst gradient ratio "
            f"{ratio:.3f}; {time.perf_counter() - t0:.1f} s")
        if counts != want or not torch.isfinite(m["loss"]) or int(st.step) != 1:
            raise AssertionError(f"train {name}: launches {counts} != {want} or "
                                 f"loss {m}")
        del params, batch, st
        gc.collect()
        torch.cuda.empty_cache()


def train_phase(lm_configs):
    """Phase 8f: the flash backward kernel at each trained config's
    attention shape, Llama-3.2-1B trained at full width, and one step of
    every other config but arctic.  Returns (the Llama cell's name, the
    backward kernel's summary, the cell's launches, the trained Llama
    state on the host with its cell's figures, for phase 8g)."""
    from repro_torch.hw import H100

    for line in flash_bwd_ptxas():
        log(f"  ptxas {line}")
    llama = "llama3.2-1b train microbatch S4096 b2"
    flash = check_flash_bwd(H100, {
        # Llama-3.2-1B's microbatch of the training cell.
        llama: (2, 4096, 4096, 32, 8, 64, True, 0, 0.0),
        # Its local layers' window bites beyond S 4096.
        "gemma2-27b local S8192": (1, 8192, 8192, 32, 16, 128, True, 4096, 50.0),
        "gemma2-27b attn S4096": (1, 4096, 4096, 32, 16, 128, True, 0, 50.0),
        "gemma2-27b attn S4096 softcap saturated": (1, 4096, 4096, 32, 16, 128,
                                                    True, 0, 50.0),
        "recurrentgemma-9b local S4096": (1, 4096, 4096, 16, 1, 256, True,
                                          2048, 0.0),
        "hubert-xlarge S1000": (1, 1000, 1000, 16, 16, 80, False, 0, 0.0),
        "internvl2-2b S1024": (1, 1024, 1024, 16, 8, 128, True, 0, 0.0),
    }, saturated=("gemma2-27b attn S4096 softcap saturated",),
        plain_timed=(llama, "recurrentgemma-9b local S4096"),
        bit_equal=(llama, "recurrentgemma-9b local S4096"))
    name, summary, counts, trained = train_llama(lm_configs, flash[llama, "bfloat16"])
    train_families(lm_configs)
    return name, summary, counts, trained


# ---------------------------------------------------------------------------
# Phase 8g: the dry run, the ZeRO step and the compressed all-reduce


def dryrun_vs_measured(trained) -> None:
    """``repro_torch.launch.dryrun`` of phase 8f's Llama step on a 1 x 1
    mesh (its batch, microbatches, remat and moments), traced on fake
    tensors on the host: its three terms, dominant term, model FLOPs and
    peak beside the step phase 8f measured (MFU = model FLOPs over the
    step's seconds times the bf16 peak; the compute term's and the
    bound's share of the step) and the measured peak."""
    from repro_torch.distributed.context import MeshShape
    from repro_torch.hw import H100
    from repro_torch.launch import dryrun

    cfg, shape = trained["cfg"], trained["shape"]
    t0 = time.perf_counter()
    r = dryrun.build_cell(
        cfg.name, "train_4k", overrides={"grad_accum": trained["accum"],
                                         "moment_dtype": trained["opt"].moment_dtype},
        mesh=MeshShape(("data", "model"), (1, 1)), shape=shape, cfg=cfg)
    trace_s = time.perf_counter() - t0
    if r.get("skipped") or "error" in r:
        raise AssertionError(f"dry run of {cfg.name}: {r}")
    rl, step_s = r["roofline"], trained["ms"] / 1e3
    bound_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    mfu = rl["model_flops"] / (step_s * H100.peak_flops_bf16)
    log(f"dryrun {cfg.name} train S{shape.seq_len} b{shape.global_batch} accum "
        f"{trained['accum']} on 1x1: {dryrun.summary(r)}; traced in {trace_s:.1f} s")
    log(f"dryrun vs measured: step {trained['ms']:.1f} ms (phase 8f); model FLOPs "
        f"{rl['model_flops']:.6g}, MFU {mfu:.4f} (bf16 peak "
        f"{H100.peak_flops_bf16:.4g}); traced FLOPs {rl['hlo_flops_global']:.6g} "
        f"(attention at every pair {r['attention']['hlo_flops_global_dense_attention']:.6g});"
        f" compute term {rl['compute_s'] * 1e3:.2f} ms = {rl['compute_s'] / step_s:.4f} "
        f"of the step, bound {bound_s * 1e3:.2f} ms ({rl['dominant']}) = "
        f"{bound_s / step_s:.4f} of the step, roofline_frac {rl['roofline_frac']:.4f};"
        f" peak dry run {r['memory']['total_per_device_gib']:.2f} GiB (arguments "
        f"{r['memory']['argument_bytes'] / 2 ** 30:.2f}, temporaries "
        f"{r['memory']['temp_bytes'] / 2 ** 30:.2f}) vs measured "
        f"{trained['peak_gib']:.2f} GiB")
    if not (rl["compute_s"] > 0 and rl["memory_s"] > 0 and 0 < mfu < 1):
        raise AssertionError(f"dry run of {cfg.name}: terms {rl}")


def zero_and_compression(trained) -> None:
    """On one NCCL rank (a ``file://`` rendezvous in a temporary
    directory): ``distributed.zero``'s step from phase 8f's state against
    ``make_train_step``'s on the same batch, params and moments bit for
    bit, its flash launches exact, both timed in turns (zero, plain,
    plain, zero); then ``compressed_allreduce_mean`` over every gradient
    leaf of that step, twice (the second call on the first's error), each
    mean bit for bit the local ``dequantize(quantize(g + e))``, and the
    gradient's compression ratio.  No other backend: a failed NCCL group
    fails the phase."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.data import batch_for
    from repro_torch.distributed import compression, zero
    from repro_torch.train.step import accumulated_grads, make_train_step

    cfg, shape, opt, accum = (trained[k] for k in ("cfg", "shape", "opt", "accum"))
    name = f"{cfg.name} train S{shape.seq_len} b{shape.global_batch} accum {accum}"
    rdv = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rdv}/rendezvous",
                            world_size=1, rank=0)
    try:
        params = tree_lib.tree_map(lambda t: t.cuda(), trained["params"])
        full = tree_lib.tree_map(lambda t: t.cuda(), trained["opt_state"])
        batch = batch_for(cfg, shape, TRAIN_STEPS, seed=SEED, device="cuda")
        plain = make_train_step(cfg, opt, accum, "cuda")
        zstep = zero.make_zero_train_step(cfg, opt, grad_accum=accum, impl="cuda")
        shard = zero.shard_opt_state(full, params)
        ref_p, ref_o, ref_m = plain(params, full, batch)
        reset_counts()
        got_p, got_o, got_m = zstep(params, shard, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {"flash_attention": accum * 2 * cfg.num_layers,
                "flash_attention_bwd": accum * cfg.num_layers}
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tree_lib.leaves([ref_p, ref_o]), tree_lib.leaves([got_p, got_o])))
        loss_same = float(ref_m["loss"]) == float(got_m["loss"])
        del ref_p, ref_o, got_p, got_o
        gc.collect()
        times = {"zero": [], "plain": []}
        for which in ("zero", "plain", "plain", "zero"):
            fn, st = (zstep, shard) if which == "zero" else (plain, full)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(params, st, batch)
            torch.cuda.synchronize()
            times[which].append(1e3 * (time.perf_counter() - t0))
            del out
        zms, pms = (statistics.median(times[k]) for k in ("zero", "plain"))
        log(f"zero {name} on 1 NCCL rank: params, moments and step bit-equal to "
            f"make_train_step's: {same}; loss {float(got_m['loss']):.6f} (equal: "
            f"{loss_same}); launches {counts} (want {want}); ms per step zero "
            f"{zms:.1f} plain {pms:.1f} ({times}); overhead {zms / pms - 1:+.4f}")
        if not (same and loss_same and counts == want):
            raise AssertionError(f"zero {name}: not bit-equal to the unsharded "
                                 f"step or launches {counts} != {want}")
        del shard, full
        gc.collect()
        torch.cuda.empty_cache()

        _, grads = accumulated_grads(cfg, params, batch, accum, "cuda")
        t0 = time.perf_counter()
        n_leaves, fp32_bytes, wire_bytes, bad = 0, 0, 0, []
        for path, g in tree_lib.leaves_with_paths(grads):
            err = torch.zeros(g.shape, dtype=torch.float32, device="cuda")
            for _ in range(2):
                mean, new_err = compression.compressed_allreduce_mean(g, err)
                q, sc = compression.quantize_int8(g.float() + err)
                local = compression.dequantize_int8(q, sc, g.shape)
                if not (torch.equal(mean, local)
                        and torch.equal(new_err, g.float() + err - local)):
                    bad.append(path)
                err = new_err
            n_leaves += 1
            fp32_bytes += 4 * g.numel()
            wire_bytes += q.numel() + 4 * sc.numel()
        torch.cuda.synchronize()
        log(f"compression {name}: compressed_allreduce_mean over {n_leaves} "
            f"gradient leaves ({fp32_bytes / 2 ** 30:.2f} GiB in fp32), twice each: "
            f"every mean and error bit-equal to the local round trip: {not bad}; "
            f"compression ratio {fp32_bytes / wire_bytes:.4f} "
            f"(compression_ratio((1024, 1024)) "
            f"{compression.compression_ratio((1024, 1024)):.4f}); "
            f"{time.perf_counter() - t0:.1f} s")
        if bad:
            raise AssertionError(f"compression {name}: not bit-equal at {bad[:5]}")
        del grads, params, batch
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8b: CNN serving


SERVE_BUCKETS = (1, 4, 8)
SERVE_REQUESTS = 13        # drains as 8 + 4 + 1
SERVE_REPS = 10            # timed drains


def serve_cell(model, dtype, rng, name, checked=()):
    """``CompiledCNN.serve()`` over ``SERVE_BUCKETS``: first every kernel
    call of each bucket's plan, but those of the batches in ``checked``
    (held one by one by an earlier phase at this model and dtype), against
    its plain version; then one drain of ``SERVE_REQUESTS`` images with the
    counts at zero, checked (the bucket sequence, the stats, the health
    counters, each bucket's launches, each row against the bucket's
    executor and against ``impl='torch'``), then profiled and timed per
    bucket beside the bucket's ``run``.  Returns the compiled model, the
    images, the drain's results and their uids."""
    import torch

    import repro_torch
    from repro_torch.core.quant import sqnr_db
    from repro_torch.hw import H100
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    int8 = dtype == "int8"
    # int8 as the int8 cells: identity batchnorm, calibrated on the input.
    params = init_cnn(rng, model.layers)
    if not int8:
        params = random_batchnorm(params, rng)
    h, w = model.input_hw
    images = rng.standard_normal(
        (SERVE_REQUESTS, h, w, model.in_channels)).astype(np.float32)
    calibration = (torch.tensor(images[:SERVE_BUCKETS[-1]], device="cuda")
                   if int8 else None)
    opts = repro_torch.ExecutionOptions(dtype=dtype, buckets=SERVE_BUCKETS)
    cu = repro_torch.compile(model, params, opts, calibration=calibration)
    plain = repro_torch.compile(model, params, dataclasses.replace(
        opts, impl="torch"), calibration=calibration)
    t0 = time.perf_counter()
    engine = cu.serve()
    build_s = time.perf_counter() - t0
    if any(cu.executor(b).graph is None for b in SERVE_BUCKETS):
        raise AssertionError(f"{name}: a bucket's graph was not captured "
                             f"when the engine was made")
    # The plans differ by batch (algorithms, tiles, splits): each bucket's
    # kernel calls at the shapes its plan gives them, on draws of their own.
    rng_k = np.random.default_rng(SEED)
    for b in SERVE_BUCKETS:
        if b not in checked:
            check_kernels(cu.network_plan(b), rng_k, H100, f"{name} b{b}")

    reset_counts()
    uids = [engine.submit(img) for img in images]
    results, served = {}, []
    while engine.queue:
        before = dict(engine.stats["batches"])
        results.update(engine.step())
        served += [b for b, n in engine.stats["batches"].items()
                   if n != before[b]]
    counts = read_counts()
    stats = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in engine.stats.items()}
    want = {}
    for b in served:
        for k, n in cu.network_plan(b).kernel_launches().items():
            want[k] = want.get(k, 0) + n
    health = engine.health()
    zero = ("evictions", "rejections", "retries", "request_failures",
            "failed_batches", "faults_injected")
    if served != [8, 4, 1] or engine.stats != {
            "batches": {1: 1, 4: 1, 8: 1}, "padded_slots": 0,
            "requests": SERVE_REQUESTS}:
        raise AssertionError(f"{name}: buckets {served}, stats "
                             f"{engine.stats}")
    if any(health[k] for k in zero) or health["ladder"] != ["primary"]:
        raise AssertionError(f"{name}: health {health}")
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != the three "
                             f"buckets' plans {want}")
    # Each row: the bucket's executor on the same batch bit for bit, and
    # the plain forward of that batch within the cells' tolerance.
    gaps, start = [], 0
    for b in served:
        x = torch.tensor(images[start:start + b], device="cuda").to(
            getattr(torch, opts.input_dtype))
        rows = torch.stack([results[u] for u in uids[start:start + b]])
        y = cu.executor(b)(x).cpu()
        ref = plain.run(x).float().cpu()
        if not (rows.dtype == y.dtype and torch.equal(rows, y)):
            raise AssertionError(f"{name}: bucket {b}'s rows differ from "
                                 f"its executor's forward")
        scale = max(1.0, float(ref.abs().max()))
        err = float((rows.float() - ref).abs().max())
        ok = bool(torch.isfinite(rows).all())
        if int8:
            gaps.append(sqnr_db(ref, rows.float()))
            ok = ok and gaps[-1] >= INT8_VS_PLAIN_DB
        else:
            gaps.append(err / scale)
            ok = ok and err <= (NET_TOL16[dtype] if dtype in HALF
                                else NET_RTOL) * scale
        if not ok:
            raise AssertionError(f"{name}: bucket {b} against impl='torch':"
                                 f" max_abs_err {err} (max|ref| {scale})")
        start += b

    def drain():
        for img in images:
            engine.submit(img)
        engine.run()

    step_ms = {b: [] for b in SERVE_BUCKETS}
    t0 = time.perf_counter()
    for _ in range(SERVE_REPS):
        for img in images:
            engine.submit(img)
        while engine.queue:
            pending = len(engine.queue)
            t1 = time.perf_counter()
            engine.step()
            step_ms[engine.pick_bucket(pending)].append(
                (time.perf_counter() - t1) * 1e3)
    drain_ms = (time.perf_counter() - t0) * 1e3 / SERVE_REPS
    planned = {}
    for b in SERVE_BUCKETS:
        for k, n in planned_cuda_launches(cu.network_plan(b)).items():
            planned[k] = planned.get(k, 0) + n
    busy, kept = profile_forward(drain, drain_ms, f"{name} drain",
                                 want=planned, detail=False)
    replay = {}
    for b in SERVE_BUCKETS:
        x = torch.tensor(images[:b], device="cuda")
        replay[b] = forward_ms(lambda: cu.run(x), SERVE_REPS)
    log(f"serve {name}: buckets {served} stats {stats} health "
        f"counters 0; launches={counts}; rows equal to executor(b), vs "
        f"impl='torch' "
        + (f"min sqnr_db={min(gaps):.2f}" if int8
           else f"max_abs_err/max(1,max|ref|)={max(gaps):.3g}")
        + f"; build (plan and capture of {len(SERVE_BUCKETS)} graphs) "
        f"{build_s:.2f} s; ms per step on the host's clock (stack, copy in,"
        f" replay, copy out), median of {SERVE_REPS}: "
        + ", ".join(f"b{b} {statistics.median(step_ms[b]):.4f} (run "
                    f"{replay[b]:.4f})" for b in SERVE_BUCKETS)
        + f"; drain of {SERVE_REQUESTS} {drain_ms:.4f} ms, "
        f"{SERVE_REQUESTS * 1e3 / drain_ms:.1f} images/s; device busy "
        f"{busy:.4f} ms a drain, idle share "
        f"{max(0.0, 1.0 - busy / drain_ms):.3f}"
        + ("" if kept in (None, 1.0) else f" (the trace kept {kept:.2f})"))
    return cu, images, results, uids


def serve_faults(cu, images, clean, uids, name) -> None:
    """Faults on the card, on ``cu``'s buckets: an exception one retry
    recovers, a NaN row that fails its one request while its neighbours
    equal the clean rows (``clean``, by uid of the clean drain of
    ``images``), a latency spike on a ``FakeClock`` that expires the next
    request, and ``Backpressure`` at ``max_queue``."""
    import torch

    import repro_torch
    from repro_torch.serving import (
        Backpressure,
        DeadlineExceeded,
        FakeClock,
        FaultPlan,
        FaultSpec,
        RequestFailed,
    )

    plan = FaultPlan([FaultSpec("exception", step=1, times=1),
                      FaultSpec("nan", step=2, rows=(1,), times=2)])
    engine = cu.serve(faults=plan)
    got = {}
    for img in images[:8]:
        engine.submit(img)
    got.update(engine.step())                     # bucket 8, retried once
    for img in images[8:12]:
        engine.submit(img)
    got.update(engine.step())                     # bucket 4, row 1 NaN
    h = engine.health()
    want = [clean[u] for u in uids[:12]]
    rows = [got[u] for u in sorted(got)]
    failed = [i for i, r in enumerate(rows) if isinstance(r, RequestFailed)]
    if (failed != [9] or h["retries"] != 2 or h["faults_injected"] != 3
            or h["request_failures"] != 1 or h["failed_batches"] != 0
            or not all(torch.equal(r, want[i]) for i, r in enumerate(rows)
                       if i != 9)):
        raise AssertionError(f"{name} faults: failed rows {failed}, health "
                             f"{h}")
    clock = FakeClock()
    late = cu.serve(buckets=(1,), clock=clock, faults=FaultPlan(
        [FaultSpec("latency", latency_s=10.0)]))
    # images[12] rode bucket 1 in the clean drain.
    u1 = late.submit(images[12], deadline_s=5.0)
    u2 = late.submit(images[11], deadline_s=5.0)
    res = late.run()
    if not (torch.equal(res[u1], clean[uids[12]])
            and isinstance(res[u2], DeadlineExceeded)
            and late.health()["evictions"] == 1):
        raise AssertionError(f"{name} latency fault: {res}")
    bounded = repro_torch.compile(cu.model, cu.params, dataclasses.replace(
        cu.options, max_queue=2)).serve(buckets=(1,))
    bounded.submit(images[0])
    bounded.submit(images[1])
    try:
        bounded.submit(images[2])
    except Backpressure as e:
        rejected = e
    else:
        raise AssertionError(f"{name}: a third request at max_queue=2 was "
                             f"admitted")
    bounded.run()
    log(f"serve faults {name}: injected exception retried (bucket 8 rows "
        f"equal the clean rows), NaN row 1 of bucket 4 failed alone "
        f"({h['request_failures']} request failure, {h['retries']} retries,"
        f" {h['faults_injected']} faults), latency 10 s on a FakeClock "
        f"expired the next request (deadline 5 s), {rejected}")


# ---------------------------------------------------------------------------
# Phase 8c: multi-device CNN inference (pipeline stages, batch shards)

# Microbatches and stages of the empty schedule whose tick is timed (the
# YOLOv3-tiny b8 cells' scale), its timed forwards a round, and the rounds
# whose median sets ``core/netplan.TICK_OVERHEAD_S``.
TICK_MICRO, TICK_STAGES, TICK_REPS, TICK_ROUNDS = 8, 2, 50, 7


def pipeline_tick_ms(device, n_stages=TICK_STAGES, n_micro=TICK_MICRO):
    """Host ms per tick of the pipeline schedule (distributed/pipeline.py)
    on stages that do no work: ``n_stages`` ``DeviceCall``s on ``device``,
    each a CUDA graph of one add on a (1, 256) microbatch, driven by
    ``pipeline_forward`` over ``n_micro`` microbatches; a forward's time
    (ending in a synchronize) over its n_micro + n_stages - 1 ticks.  One
    stage's run costs a graph replay, the stream waits and the boundary
    copy; ``core/netplan.TICK_OVERHEAD_S`` is set from this."""
    import torch

    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.graphs import DeviceCall

    stages = [DeviceCall(lambda t: t + 1, device, f"empty stage {s}")
              for s in range(n_stages)]
    x = torch.zeros((n_micro, 256), device=device)
    for st in stages:
        st.capture(x[:1])
    y = pipeline_forward(stages, x, n_micro)
    if not torch.equal(y, x + n_stages):
        raise AssertionError("the empty pipeline did not add 1 a stage")
    ms = forward_ms(lambda: pipeline_forward(stages, x, n_micro), TICK_REPS)
    return ms / (n_micro + n_stages - 1)


def check_microbatch(model, netplan, mb, name, checks):
    """Every kernel call of ``netplan`` at batch ``mb`` (the batch a stage
    or shard runs the full batch's plan at) against its plain version, on
    the draws of ``checks``' generator, unless its set holds (network,
    dtype, plan batch, mb): the fused Winograd and im2col calls take their
    split counts from the call's shapes, so a plan run at another batch
    makes calls of its own."""
    from repro_torch.hw import H100

    rng, checked = checks
    key = (model.name, netplan.dtype, netplan.batch, mb)
    if key not in checked:
        checked.add(key)
        check_kernels(dataclasses.replace(netplan, batch=mb), rng, H100,
                      f"{name} mb{mb}")


def multi_device_cell(model, batch, dtype, rng, name, devices, stages=0, *,
                      checks):
    """``repro_torch.compile(..., devices=devices)`` with ``pipeline_stages
    = stages`` (0: batch-sharded over ``devices``) run once with the counts
    at zero and held against the single-device replay of the same
    compilation's plan and prepared params (a ``NetworkExecutor`` of its
    own, one graph): fp32 within ``NET_RTOL`` and bf16 within
    ``NET_TOL16`` of max(1, max|ref|), int8 at ``INT8_VS_PLAIN_DB``.
    First every kernel call of the plan at the stages' (shards') batch
    against its plain version (``check_microbatch``, ``checks``).  Each
    stage's (shard's) graph must launch what its slice of the plan
    launches, and the call n_micro (shards) times that; a second input
    must give the single replay's second output while the first output,
    held, stays as it was.  Then both forwards timed in turns (single,
    multi, multi, single) and the multi-device one profiled: only the
    planned port kernels, at most as planned at the stages' and shards'
    batch."""
    import torch

    import repro_torch
    from repro_torch.core.netplan import NetworkExecutor
    from repro_torch.core.quant import sqnr_db
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    int8 = dtype == "int8"
    params = init_cnn(rng, model.layers)
    if not int8:
        params = random_batchnorm(params, rng)
    h, w = model.input_hw
    x, x2 = (torch.tensor(rng.standard_normal(
        (batch, h, w, model.in_channels)).astype(np.float32), device="cuda")
        for _ in range(2))
    t0 = time.perf_counter()
    cu = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        batch=batch, dtype=dtype, pipeline_stages=stages,
        shard_batch=not stages), calibration=x if int8 else None,
        devices=devices)
    compile_s = time.perf_counter() - t0
    netplan = cu.network_plan(batch)
    single = NetworkExecutor(netplan, cu.params, calibration=cu.calibration)
    if stages:
        ex = cu.pipeline_executor(batch)
        parts, per = ex.stages, ex.n_micro
        bounds, mb = ex.pipeplan.stage_bounds, batch // ex.n_micro
    else:
        ex = cu.executor(batch)
        parts, per = ex.shards, len(ex.shards)
        bounds, mb = [(0, None)] * len(parts), batch // max(1, len(parts))
        if len(parts) != len(devices):
            raise AssertionError(f"{name}: {len(parts)} shards over "
                                 f"{len(devices)} devices")
    check_microbatch(model, netplan, mb, name, checks)
    reset_counts()
    y = cu.run(x)               # captures every part's graph, then replays
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: per * n for k, n in netplan.kernel_launches().items()}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != {want}")
    for i, (part, (a, z)) in enumerate(zip(parts, bounds)):
        if part.graph.launches != netplan.kernel_launches(a, z):
            raise AssertionError(f"{name}: part {i} launches "
                                 f"{part.graph.launches}, its slice's plan "
                                 f"{netplan.kernel_launches(a, z)}")
    held = y.clone()
    y2 = cu.run(x2)
    ref, ref2 = single(x), single(x2)
    torch.cuda.synchronize()
    gaps = []
    for got, want_y in ((y, ref), (y2, ref2)):
        scale = max(1.0, float(want_y.float().abs().max()))
        err = float((got.float() - want_y.float()).abs().max())
        ok = (got.shape == want_y.shape and got.dtype == want_y.dtype
              and bool(torch.isfinite(got.float()).all()))
        if int8:
            gaps.append(sqnr_db(want_y, got))
            ok = ok and gaps[-1] >= INT8_VS_PLAIN_DB
        else:
            gaps.append(err / scale)
            ok = ok and err <= (NET_TOL16[dtype] if dtype in HALF
                                else NET_RTOL) * scale
        if not ok:
            raise AssertionError(f"{name}: against the single replay "
                                 f"max_abs_err {err} (max|ref| {scale})")
    if not torch.equal(y, held) or torch.equal(y, y2):
        raise AssertionError(f"{name}: a held output changed, or two inputs "
                             f"gave one output")
    s1 = forward_ms(lambda: single(x), SHORT_FORWARD_REPS)
    m1 = forward_ms(lambda: cu.run(x), SHORT_FORWARD_REPS)
    m2 = forward_ms(lambda: cu.run(x), SHORT_FORWARD_REPS)
    s2 = forward_ms(lambda: single(x), SHORT_FORWARD_REPS)
    multi_ms, single_ms = (m1 + m2) / 2, (s1 + s2) / 2
    planned = {}            # a stage runs n_micro times a call, a shard once
    for a, z in bounds:
        for k, n in planned_cuda_launches(netplan, mb, a, z).items():
            planned[k] = planned.get(k, 0) + (per if stages else 1) * n
    busy, kept = profile_forward(lambda: cu.run(x), multi_ms, name,
                                 want=planned, detail=False)
    what = (f"{len(parts)} stages {list(map(list, bounds))} n_micro {per}"
            if stages else f"{len(parts)} shards of {mb}")
    log(f"multi-device {name}: {what} on {[str(d) for d in devices]}; "
        f"launches={counts}; vs the single replay "
        + (f"min sqnr_db={min(gaps):.2f}" if int8
           else f"max_abs_err/max(1,max|ref|)={max(gaps):.3g}")
        + f"; compile_s={compile_s:.2f}; in turns ms_per_forward "
        f"multi={multi_ms:.4f} ({m1:.4f} {m2:.4f}) single={single_ms:.4f} "
        f"({s1:.4f} {s2:.4f}) multi/single={multi_ms / single_ms:.3f}; "
        f"device busy {busy:.4f} ms"
        + ("" if kept in (None, 1.0) else f" (the trace kept {kept:.2f})"))
    return cu


def pipelined_serve_cell(model, rng, name, devices, checks):
    """``CompiledCNN.serve()`` with ``pipeline_stages=2`` over
    ``SERVE_BUCKETS``, in fp32: each bucket its own pipeline, captured when
    the engine is made (bucket 1 at one microbatch); every kernel call of
    each bucket's plan at its microbatch against its plain version
    (``check_microbatch``, ``checks``); one drain of
    ``SERVE_REQUESTS`` images with the counts at zero (the bucket
    sequence, the stats, every ``health()`` counter 0, the launches each
    bucket's pipeline makes), each row bit for bit its bucket's pipelined
    forward of the same batch; then the ms of each bucket's step on the
    host's clock beside that bucket's pipelined ``run``."""
    import torch

    import repro_torch
    from repro_torch.distributed.pipeline import PipelineExecutor
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    h, w = model.input_hw
    images = rng.standard_normal(
        (SERVE_REQUESTS, h, w, model.in_channels)).astype(np.float32)
    cu = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        buckets=SERVE_BUCKETS, pipeline_stages=2), devices=devices)
    t0 = time.perf_counter()
    engine = cu.serve()
    build_s = time.perf_counter() - t0
    pipes = {b: cu.pipeline_executor(b) for b in SERVE_BUCKETS}
    if (any(not isinstance(engine._executors[b], PipelineExecutor)
            or engine._executors[b] is not pipes[b]
            or any(st.graph is None for st in pipes[b].stages)
            for b in SERVE_BUCKETS) or pipes[1].n_micro != 1):
        raise AssertionError(f"{name}: the buckets are not pipelines "
                             f"captured when the engine was made")
    for b in SERVE_BUCKETS:
        check_microbatch(model, cu.network_plan(b), b // pipes[b].n_micro,
                         f"{name} b{b}", checks)
    reset_counts()
    uids = [engine.submit(img) for img in images]
    results, served = {}, []
    while engine.queue:
        before = dict(engine.stats["batches"])
        results.update(engine.step())
        served += [b for b, n in engine.stats["batches"].items()
                   if n != before[b]]
    counts = read_counts()
    want = {}
    for b in served:
        for k, n in cu.network_plan(b).kernel_launches().items():
            want[k] = want.get(k, 0) + pipes[b].n_micro * n
    health = engine.health()
    zero = ("evictions", "rejections", "retries", "request_failures",
            "failed_batches", "faults_injected")
    if served != [8, 4, 1] or any(health[k] for k in zero):
        raise AssertionError(f"{name}: buckets {served}, health {health}")
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != {want}")
    start = 0
    for b in served:
        x = torch.tensor(images[start:start + b], device="cuda")
        rows = torch.stack([results[u] for u in uids[start:start + b]])
        if not torch.equal(rows, pipes[b](x).cpu()):
            raise AssertionError(f"{name}: bucket {b}'s rows differ from its "
                                 f"pipelined forward")
        start += b
    step_ms = {b: [] for b in SERVE_BUCKETS}
    for _ in range(SERVE_REPS):
        for img in images:
            engine.submit(img)
        while engine.queue:
            pending = len(engine.queue)
            t1 = time.perf_counter()
            engine.step()
            step_ms[engine.pick_bucket(pending)].append(
                (time.perf_counter() - t1) * 1e3)
    xs = {b: torch.tensor(images[:b], device="cuda") for b in SERVE_BUCKETS}
    run_ms = {b: forward_ms(lambda: cu.run(xs[b]), SERVE_REPS)
              for b in SERVE_BUCKETS}
    log(f"serve {name}: buckets {served} health counters 0; launches="
        f"{counts}; rows equal to the bucket's pipelined forward; n_micro "
        + ", ".join(f"b{b} {pipes[b].n_micro} stages "
                    f"{list(map(list, pipes[b].pipeplan.stage_bounds))}"
                    for b in SERVE_BUCKETS)
        + f"; build {build_s:.2f} s; ms per step on the host's clock, median"
        f" of {SERVE_REPS}: "
        + ", ".join(f"b{b} {statistics.median(step_ms[b]):.4f} (run "
                    f"{run_ms[b]:.4f})" for b in SERVE_BUCKETS))


def multi_device_phase() -> None:
    """Phase 8c: multi-device CNN inference, each stage and shard its own
    entry of a device list, on its own generator's draws: on this card
    repeated (its own stream, graph pool and copy of the parameters), and
    over distinct cards where there are several; first the tick of an
    empty schedule.  Each plan's kernel calls are held one by one at the
    batch its stages or shards run it at, where no earlier phase holds
    them."""
    import torch

    from repro_torch.configs import vgg16, yolov3
    from repro_torch.core.netplan import TICK_OVERHEAD_S

    torch.cuda.empty_cache()
    rng_p = np.random.default_rng(SEED)
    card = torch.device("cuda", 0)
    ticks = sorted(pipeline_tick_ms(card) for _ in range(TICK_ROUNDS))
    tick4 = pipeline_tick_ms(card, n_stages=4)
    log(f"pipeline tick (empty stages, {TICK_MICRO} microbatches, "
        f"{TICK_ROUNDS} rounds of {TICK_REPS} forwards): median "
        f"{statistics.median(ticks):.4f} ms at {TICK_STAGES} stages (min "
        f"{ticks[0]:.4f}, max {ticks[-1]:.4f}), {tick4:.4f} ms at 4; "
        f"TICK_OVERHEAD_S = {TICK_OVERHEAD_S:g} s")
    # Each (network, dtype, plan batch, batch) whose kernel calls an earlier
    # phase held one by one: YOLOv3-tiny 416's buckets in the three types
    # (phases 3, 7b and 8b), VGG-16 224 b1 (phase 3).
    tiny, tiny_b8 = yolov3.TINY_MODEL, "yolov3-tiny 416 b8"
    checks = (np.random.default_rng(SEED),
              {(tiny.name, d, b, b) for d in ("float32", "bfloat16", "int8")
               for b in SERVE_BUCKETS} | {(vgg16.MODEL.name, "float32", 1, 1)})
    for dtype in ("float32", "bfloat16", "int8"):
        multi_device_cell(tiny, 8, dtype, rng_p, f"{tiny_b8} {dtype} "
                          f"pipeline 2", [card] * 2, stages=2, checks=checks)
    multi_device_cell(vgg16.MODEL, 8, "float32", rng_p,
                      "vgg16 224 b8 float32 pipeline 4", [card] * 4, stages=4,
                      checks=checks)
    for dtype in ("float32", "bfloat16"):
        multi_device_cell(tiny, 8, dtype, rng_p, f"{tiny_b8} {dtype} shards 2",
                          [card] * 2, checks=checks)
    pipelined_serve_cell(tiny, rng_p, f"yolov3-tiny 416 float32 buckets "
                         f"{SERVE_BUCKETS} pipeline 2", [card] * 2, checks)
    if torch.cuda.device_count() > 1:
        pair = [torch.device("cuda", i) for i in range(2)]
        multi_device_cell(tiny, 8, "float32", rng_p, f"{tiny_b8} float32 "
                          f"pipeline 2 over two cards", pair, stages=2,
                          checks=checks)
        multi_device_cell(tiny, 8, "float32", rng_p, f"{tiny_b8} float32 "
                          f"shards 2 over two cards", pair, checks=checks)
    else:
        log("multi-card execution not run: one visible card (the stages "
            "and shards above share it)")


# ---------------------------------------------------------------------------
# Phase 8d: static plan verification


def ptxas_usage(library: str, function: str) -> str:
    """ptxas' register and shared-memory line(s) of ``function``'s
    instances in ``library``'s build log (phase 2's)."""
    from repro_torch.kernels import _build

    entry, found = "", set()
    for line in _build.build_logs.get(library, "").splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "Used" in line and "registers" in line and function in entry:
            found.add(line.split(":", 1)[1].strip())
    return "; ".join(sorted(found)) or "not in this run's build log"


def flash_ptxas() -> list:
    """One line per flash kernel instance of phase 2's build log: its body
    and head dim, whether it writes the backward's lse (the instances the
    serving calls take do not), ptxas' registers and spill bytes."""
    from repro_torch.kernels import _build

    lines, head = [], None
    for line in _build.build_logs.get("flash_attention", "").splitlines():
        m = re.search(r"flash_(bf16|fp32)\w*_kernelILi(\d+)ELb([01])E", line)
        if "Compiling entry function" in line:
            head = (f"flash {m.group(1)} hd {m.group(2)}"
                    + (" lse" if m.group(3) == "1" else "") if m else None)
        elif head and "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        elif head and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{head}: {regs} registers, {spill}")
            head = None
    return lines


def verify_phase() -> None:
    """Phase 8d: every cell of phases 3 to 8c compiled with
    ``validate="full"`` at full width (its pipelines gated at the kernel
    rung), each gate's report clean; then every distinct launch the gates
    recorded against its library's ``describe`` entry.  A finding
    raises."""
    import torch

    import repro_torch
    from repro_torch.analysis import VerifyReport, record_launches
    from repro_torch.analysis.passes import describe_pass
    from repro_torch.configs import vgg16, yolov3
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    rng = np.random.default_rng(SEED)
    tiny, m20, vgg = yolov3.TINY_MODEL, yolov3.MODEL_20, vgg16.MODEL
    params = {m.name: random_batchnorm(init_cnn(rng, m.layers), rng)
              for m in (tiny, m20, vgg)}
    card = torch.device("cuda", 0)
    three = {"winograd_fused": False}
    cells = (
        [(f"yolov3-tiny 416 b1 {d} mode={mode}", tiny, 1, dict(
            dtype=d, mode=mode), None)
         for d in ("float32", "int8", "bfloat16")
         for mode in ("cost", "model")]
        + [("yolov3-tiny 416 b4 float32", tiny, 4, {}, None)]
        + [(f"yolov3-20 608 b1 {d}", m20, 1, dict(dtype=d), None)
           for d in ("float32", "int8", "bfloat16")]
        + [(f"vgg16 224 b1 {d} mode={mode}", vgg, 1, dict(
            dtype=d, mode=mode), None)
           for d in ("float32", "int8", "bfloat16")
           for mode in ("cost", "model")]
        + [(f"vgg16 224 b8 winograd_fused=False {d} mode={mode}", vgg, 8,
            dict(dtype=d, mode=mode, **three), None)
           for d, mode in (("float32", "cost"), ("bfloat16", "cost"),
                           ("float32", "model"))]
        + [(f"yolov3-tiny 416 b8 {d} pipeline 2", tiny, 8, dict(
            dtype=d, pipeline_stages=2), [card] * 2)
           for d in ("float32", "bfloat16", "int8")]
        + [("vgg16 224 b8 float32 pipeline 4", vgg, 8,
            dict(pipeline_stages=4), [card] * 4)])
    recorded = []
    for name, model, batch, opts, devices in cells:
        t0 = time.perf_counter()
        with record_launches() as launches:
            compiled = repro_torch.compile(
                model, params[model.name], repro_torch.ExecutionOptions(
                    batch=batch, validate="full", **opts), devices=devices)
        if not compiled.reports:
            raise AssertionError(f"verify {name}: no gate ran")
        for key, report in compiled.reports.items():
            rows = report.kernels
            log(f"verify {name} {key}: {report.summary()}; passes "
                f"{','.join(report.passes_run)}; launches {len(rows)}, "
                f"splits {sum(r['splits'] > 1 for r in rows)}, smem at most "
                f"{max(r['smem_bytes'] for r in rows)} B, traffic "
                f"{sum(r['traffic_bytes'] for r in rows)} B "
                f"({time.perf_counter() - t0:.2f} s)")
            if not report.clean:
                raise AssertionError(f"verify {name} {key}:\n"
                                     + report.summary())
        recorded += launches
        del compiled
        torch.cuda.empty_cache()
    report = VerifyReport(level="kernel",
                          network={"name": "launch descriptors vs describe"})
    rows = describe_pass(report, recorded)
    by_function = {}
    for row in rows:
        by_function.setdefault((row["descriptor"]["library"],
                                row["function"]), []).append(row)
    for (library, function), group in sorted(by_function.items()):
        card_row = group[0]["card"]
        smem = sorted({r["descriptor"]["dynamic_smem_bytes"]
                       + r["descriptor"]["static_smem_bytes"] for r in group})
        log(f"describe {function}: {len(group)} distinct launches equal "
            f"their descriptors; descriptor smem {smem[0]}-{smem[-1]} B; "
            f"cudaFuncGetAttributes static {card_row['static_smem_bytes']} B"
            f", {card_row['registers']} registers, local "
            f"{card_row['local_bytes']} B, dynamic limit "
            f"{max(r['card']['max_dynamic_smem_bytes'] for r in group)} B "
            f"(device opt-in {card_row['smem_optin_bytes']} B); ptxas "
            f"{ptxas_usage(library, function)}")
    log(f"describe: {len(rows)} distinct launches of "
        f"{len(by_function)} kernels on {card_row['sm_count']} SMs, "
        f"{len(report.findings)} finding(s)")
    if not report.clean:
        raise AssertionError(report.summary())


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
    from repro_torch.core import smem_model
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
    for line in flash_ptxas():
        log(f"  ptxas {line}")
    # ptxas counts static shared memory only; the 16-bit Winograd kernels'
    # is dynamic, as the model and its tests read it from their sources.
    log(f"  shared memory (dynamic) winograd16_fused_kernel "
        f"{smem_model.FUSED16_SMEM_BYTES} bytes; "
        "winograd16_tuple_multiply_kernel " + ", ".join(
            f"N={n} {smem_model.tuple16_smem_bytes(n)} bytes "
            f"({smem_model.tuple16_resident(n)} a SM)" for n in (64, 128, 256)))

    # Phase 3: each kernel against its plain version at every shape the
    # model cells give it; timed at YOLOv3-tiny b1's shapes and at
    # VGG-16's Winograd layers.
    rng = np.random.default_rng(SEED)
    # Cost mode's rule (the reference planner's) sends VGG-16's conv4_2 and
    # conv4_3 to the 3-pass pipeline at batch 8 under winograd_fused=False,
    # and every 3x3 conv to im2col at batch 1.
    tiny_cell, vgg3_cell = "yolov3-tiny 416 b1", "vgg16 224 b8 winograd_fused=False"
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
    check_kernels(netplan_of(vgg16.MODEL, 1), rng, H100, "vgg16 224 b1",
                  timed=("winograd_fused",))
    _, fused_steps = check_kernels(
        netplan_of(vgg16.MODEL, 8), rng, H100, "vgg16 224 b8",
        timed=("winograd_fused",), winograd_only=True)
    summaries[vgg3_cell], three_steps = check_kernels(
        netplan_of(vgg16.MODEL, 8, winograd_fused=False), rng, H100, vgg3_cell,
        timed=("input_transform", "tuple_multiply", "output_transform"),
        winograd_only=True)
    for i, parts in sorted(three_steps.items()):
        fused, total = fused_steps[i]["winograd_fused"], sum(parts.values())
        log(f"vgg16 224 b8 L{i}: fused {fused:.4f} ms, "
            f"3-pass {total:.4f} ms ("
            + " + ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f"), 3-pass / fused {total / fused:.2f}")
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

    # Phase 6: VGG-16 at 224: fused at batch 1, 3-pass at batch 8 (the main
    # path of the three 3-pass kernels), measure mode at batch 1; one set
    # of weights.
    params = random_batchnorm(init_cnn(rng, vgg16.MODEL.layers), rng)
    _, cost["vgg16 224 b1"] = run_cell(vgg16.MODEL, 1, rng, params,
                                       profile=True)
    launches[vgg3_cell], _ = run_cell(
        vgg16.MODEL, 8, rng, params, {"winograd_fused": False}, vgg3_cell,
        profile=True)
    want = {k: 2 for k in ("input_transform", "tuple_multiply",
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
    # 16-bit GEMM, im2col and fused Winograd kernels, VGG-16 224 b8 with
    # winograd_fused=False that of the three 16-bit 3-pass kernels), on
    # their own generator's draws: every 16-bit kernel call of the four
    # cells against its plain version (timed at YOLOv3-tiny's and VGG-16's
    # shapes), then each cell end to end beside its fp32 forward.
    rng_h = np.random.default_rng(SEED)
    half_cells = {
        "yolov3-tiny 416 b1": (yolov3.TINY_MODEL, 1, {}, FORWARD_REPS, (
            "gemm_16", "im2col_conv_16", "winograd_fused_16")),
        "yolov3-20 608 b1": (yolov3.MODEL_20, 1, {}, SHORT_FORWARD_REPS, (
            "gemm_16", "im2col_conv_16", "winograd_fused_16")),
        "vgg16 224 b1": (vgg16.MODEL, 1, {}, FORWARD_REPS, (
            "im2col_conv_16", "winograd_fused_16")),
        vgg3_cell: (vgg16.MODEL, 8, {"winograd_fused": False},
                    SHORT_FORWARD_REPS, ("input_transform_16",
                                         "tuple_multiply_16",
                                         "output_transform_16")),
    }
    half_params = {}                    # one set of weights a network
    for model, _, _, _, _ in half_cells.values():
        if model.name not in half_params:
            half_params[model.name] = random_batchnorm(
                init_cnn(rng_h, model.layers), rng_h)
    for dtype in HALF:
        steps16 = {}
        for cell, (model, batch, opts, reps, timed) in half_cells.items():
            name = f"{cell} {dtype}"
            three_pass = opts.get("winograd_fused") is False
            summary, steps16[cell] = check_kernels(
                netplan_of(model, batch, dtype, **opts), rng_h, H100, name,
                timed=timed, winograd_only=three_pass)
            counts, _ = run_cell(model, batch, rng_h, half_params[model.name],
                                 {"dtype": dtype, **opts}, name,
                                 profile=True, reps=reps)
            if three_pass and any(counts.get(k) != 2 for k in timed):
                raise AssertionError(f"{name}: launches {counts}, want 2 of "
                                     f"each of {timed}")
            if dtype == "bfloat16" and cell in (tiny_cell, vgg3_cell):
                summaries[name], launches[name] = summary, counts
        # VGG-16 b8's 3-pass layers, the fused kernel's time beside the
        # 3-pass pipeline's (the calls' T, C, O, grid and splits are in
        # their kernel lines above).
        _, fused16 = check_kernels(
            netplan_of(vgg16.MODEL, 8, dtype), rng_h, H100,
            f"vgg16 224 b8 {dtype}", timed=("winograd_fused_16",),
            winograd_only=True)
        for i, parts in sorted(steps16[vgg3_cell].items()):
            fused, total = fused16[i]["winograd_fused_16"], sum(parts.values())
            log(f"vgg16 224 b8 {dtype} L{i}: fused {fused:.4f} ms, 3-pass "
                f"{total:.4f} ms ("
                + " + ".join(f"{k} {v:.4f}" for k, v in parts.items())
                + f"), 3-pass / fused {total / fused:.2f}")
    # The cost model's 16-bit plans (mode="model", the '_16' constants of
    # hw.H100.kernel_fit), every kernel call held in both types, each cell
    # run in bf16 beside the fp32 model-mode forward.
    for cell in (tiny_cell, "vgg16 224 b1"):
        model, _, _, reps, _ = half_cells[cell]
        name = f"{cell} bfloat16 mode=model"
        for dtype in HALF:
            check_kernels(netplan_of(model, 1, dtype, mode="model"), rng_h,
                          H100, f"{cell} {dtype} mode=model")
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
        # Phase 8e's head dims: recurrentgemma-9b's local layers (MQA, hd
        # 256, window 2048) and hubert-xlarge's (hd 80, non-causal).
        "recurrentgemma-9b local S4096": (1, 4096, 4096, 16, 1, 256, True,
                                          2048, 0.0),
        "hubert-xlarge S1000": (1, 1000, 1000, 16, 16, 80, False, 0, 0.0),
    }, saturated=(saturated,))
    log(f"phase 8a done at {time.perf_counter() - t_start:.1f} s")
    launches[llama_cell] = lm_prefill_cell(llama, 4096, llama_cell,
                                           profile=True, serve=True)
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

    # Phase 8b: CNN serving through the bucket ladder, on its own
    # generator's draws, in the three types; then faults on the fp32 one.
    # The batches of YOLOv3-tiny 416 whose kernel calls phases 3 and 7b
    # held against their plain versions, by dtype.
    rng_s = np.random.default_rng(SEED)
    checked = {"float32": (1, 4), "bfloat16": (1,), "int8": (1,)}
    for dtype in ("float32", "bfloat16", "int8"):
        name = f"yolov3-tiny 416 {dtype} buckets {SERVE_BUCKETS}"
        served = serve_cell(yolov3.TINY_MODEL, dtype, rng_s, name,
                            checked[dtype])
        if dtype == "float32":
            fp32_served = (*served, name)
        del served
    serve_faults(*fp32_served)
    del fp32_served
    log(f"phase 8b done at {time.perf_counter() - t_start:.1f} s")

    # Phase 8c: multi-device CNN inference.
    t8c = time.perf_counter()
    multi_device_phase()
    log(f"phase 8c done at {time.perf_counter() - t_start:.1f} s "
        f"(its own {time.perf_counter() - t8c:.1f} s)")

    # Phase 8d: static plan verification of every cell above.
    t8d = time.perf_counter()
    verify_phase()
    log(f"phase 8d done at {time.perf_counter() - t_start:.1f} s "
        f"(its own {time.perf_counter() - t8d:.1f} s)")

    # Phase 8e: the MoE, recurrent and frontend LM families.
    t8e = time.perf_counter()
    family_phase(lm_configs)
    log(f"phase 8e done at {time.perf_counter() - t_start:.1f} s "
        f"(its own {time.perf_counter() - t8e:.1f} s)")

    # Phase 8f: LM training.
    t8f = time.perf_counter()
    train_cell, summaries[train_cell], launches[train_cell], trained = train_phase(
        lm_configs)
    log(f"phase 8f done at {time.perf_counter() - t_start:.1f} s "
        f"(its own {time.perf_counter() - t8f:.1f} s)")

    # Phase 8g: the dry run and roofline of phase 8f's step, the ZeRO step
    # and the compressed all-reduce on one NCCL rank.
    t8g = time.perf_counter()
    dryrun_vs_measured(trained)
    zero_and_compression(trained)
    del trained
    log(f"phase 8g done at {time.perf_counter() - t_start:.1f} s "
        f"(its own {time.perf_counter() - t8g:.1f} s)")

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

#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each on its own printed line:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   and the card's reported properties beside ``repro_torch.hw.H100``;
2. build every CUDA kernel of the port with nvcc (one process per source,
   all at once) and print the build seconds and ptxas' register counts;
3. each kernel against its plain PyTorch version at every shape the three
   model cells below give it (YOLOv3-tiny at 416x416, batch 1 and 4;
   MODEL_20 at 608x608, batch 1): the max-abs error of every call; and at
   the shapes of YOLOv3-tiny at batch 1, the kernel's, the plain
   version's and one library call's median time over CUDA events (L2
   flushed before each call, as a forward finds it cold), and the least
   time the card could take (bytes over 3.35 TB/s or FLOPs over the 67
   TFLOP/s fp32 peak, whichever is larger), both counted for the conv's
   logical operands, before the channel padding the kernels take;
4. YOLOv3-tiny at 416x416, batch 1 and 4, through ``repro_torch.compile``
   with ``impl='cuda'``, held against ``impl='torch'`` on the card; each
   kernel's launch count in one forward must equal the plan's count of
   steps of its algorithm; ms per forward and images/s; a profiler
   breakdown of the batch-1 forward by CUDA kernel, with the device's idle
   share of the forward;
5. the first 20 layers of Darknet-53 (MODEL_20) at 608x608, batch 1: the
   same comparison (stride-2 im2col, shortcut);
6. one JSON line with every kernel's numbers — its launches in the batch-1
   YOLOv3-tiny forward, and its times, errors and bounds summed over the
   calls of that forward — then the last line ``{"ok": true, "device": ...}``.

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
REPS = 25                 # timed repetitions per kernel measurement
FORWARD_REPS = 20         # timed forwards per model cell
KERNEL_TOL = {"gemm": 1e-4, "im2col_conv": 1e-4, "winograd_fused": 5e-4}
# Whole-network tolerance, relative to max|ref|: both impls run fp32 on the
# same card with the same plans and layouts; they differ only in the order
# of the sums inside each kernel, which compounds over the network's depth.
NET_RTOL = 1e-3

REPLACES = {
    "gemm": "src/repro/kernels/gemm/kernel.py:140",
    "im2col_conv": "src/repro/kernels/im2col_gemm/kernel.py:162",
    "winograd_fused": "src/repro/kernels/winograd/kernel.py:143",
}


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` calls, each
    bracketed by CUDA events, after three warm-up calls.

    Before each timed call a write of twice the L2 size evicts the 50 MB
    L2, because in a forward a layer finds its weights and input cold: a
    call repeated on the same operands would run from L2 instead.
    """
    import torch

    from repro_torch.hw import H100

    flush = torch.empty(2 * H100.l2_bytes // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def launch_counts():
    from repro_torch.kernels.gemm.ops import matmul_bias_act
    from repro_torch.kernels.im2col_gemm.ops import im2col_conv
    from repro_torch.kernels.winograd.ops import fused_winograd

    return {"gemm": matmul_bias_act, "im2col_conv": im2col_conv,
            "winograd_fused": fused_winograd}


def reset_counts() -> None:
    for fn in launch_counts().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in launch_counts().items()}


# ---------------------------------------------------------------------------
# Phase 3: kernel calls at the main path's shapes


def kernel_cases(netplan, rng, cell):
    """One case per conv step of ``netplan``: the kernel's name, a label,
    and closures for the kernel, its plain version and one library call on
    the same seeded inputs, plus the work the call must do.

    Inputs are made at the conv's logical in-channels and zero-padded to
    the step's physical layout, as the path hands them to the kernel; the
    library call and the bound see the logical operands: the function the
    layer computes, not the padding the kernel takes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.conv_spec import ConvAlgorithm, apply_activation
    from repro_torch.core.winograd import _tile_input, transform_weights
    from repro_torch.kernels.gemm.ops import matmul_bias_act
    from repro_torch.kernels.im2col_gemm.ops import im2col_conv
    from repro_torch.kernels.winograd.ops import fused_winograd

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device="cuda")

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
        spec, act, blocks = s.spec, s.layer.activation, s.plan.kernel_blocks
        (h, w), (oh, ow) = s.in_hw, s.out_hw
        c, phys_c, o = spec.in_channels, s.in_layout.phys_c, spec.out_channels
        kh, kw = spec.kh, spec.kw
        bias = t(o)
        algo = s.plan.algorithm
        head = f"{cell} L{s.index}"
        if algo is ConvAlgorithm.DIRECT:
            m = b * oh * ow
            a, wm = t(m, c), t(c, o)
            ap, wmp = pad_c(a, 1), pad_c(wm, 0)
            label = f"{head} gemm M={m} K={phys_c} N={o}"
            cases.append(dict(
                kernel="gemm", label=label,
                run=lambda a=ap, wm=wmp, bias=bias, act=act, impl="cuda":
                    matmul_bias_act(a, wm, bias, act, impl=impl),
                library=lambda a=a, wm=wm, bias=bias, act=act:
                    apply_activation(torch.addmm(bias, a, wm), act),
                flops=2 * m * c * o,
                bytes=4 * (m * c + c * o + o + m * o),
            ))
            continue
        # Both convs: the logical NHWC input and HWIO weights, read once,
        # and the output written once.
        x, wt = t(b, h, w, c), t(kh, kw, c, o)
        xp, wtp = pad_c(x, 3), pad_c(wt, 2)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        conv_bytes = 4 * (b * h * w * c + kh * kw * c * o + o + b * oh * ow * o)
        library = (lambda x=x, w_oihw=w_oihw, spec=spec, bias=bias, act=act:
                   apply_activation(F.conv2d(
                       x.permute(0, 3, 1, 2), w_oihw, bias, spec.stride,
                       spec.padding), act).permute(0, 2, 3, 1))
        if algo is ConvAlgorithm.IM2COL_GEMM:
            label = (f"{head} im2col {h}x{w}x{phys_c}->{oh}x{ow}x{o} "
                     f"k{kh} s{spec.stride[0]} blocks={blocks}")
            cases.append(dict(
                kernel="im2col_conv", label=label,
                run=lambda x=xp, wt=wtp, spec=spec, blocks=blocks, bias=bias,
                act=act, impl="cuda":
                    im2col_conv(x, wt, spec, blocks, bias, act, impl=impl),
                library=library,
                flops=2 * b * oh * ow * o * kh * kw * c,
                bytes=conv_bytes,
            ))
        else:
            tiles, _, _ = _tile_input(F.pad(xp, (0, 0, 1, 1, 1, 1)), oh, ow)
            tiles = tiles.reshape(-1, 8, 8, phys_c).contiguous()
            u = transform_weights(wtp).contiguous()
            n_t = tiles.shape[0]
            label = (f"{head} winograd T={n_t} C={phys_c} O={o} "
                     f"blocks={blocks}")
            cases.append(dict(
                kernel="winograd_fused", label=label,
                run=lambda tiles=tiles, u=u, blocks=blocks, bias=bias,
                act=act, impl="cuda":
                    fused_winograd(tiles, u, blocks, bias, act, impl=impl),
                library=library,
                # F(6,3) at the logical C: 64 per-position products +
                # B^T d B (2048 per tile-channel) + A^T M A (1344 per
                # tile-out), the reference's count.
                flops=2 * n_t * 64 * c * o + n_t * c * 2048 + n_t * o * 1344,
                bytes=conv_bytes,
            ))
    return cases


def check_kernels(netplan, rng, hw, cell, timed):
    """Phase 3: every kernel call of one forward held against its plain
    version; with ``timed``, also timed, and summed per kernel."""
    summary = {}
    import torch

    for case in kernel_cases(netplan, rng, cell):
        name = case["kernel"]
        got = case["run"]()
        ref = case["run"](impl="torch")
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
        if not timed:
            log(f"kernel {case['label']}: max_abs_err={err:.3g} (tol {tol:.3g})")
            continue
        ms = cuda_ms(case["run"])
        plain_ms = cuda_ms(lambda: case["run"](impl="torch"))
        library_ms = cuda_ms(case["library"])
        t_ops = case["flops"] / hw.peak_flops_fp32 * 1e3
        t_bytes = case["bytes"] / hw.hbm_bandwidth * 1e3
        bound_ms = max(t_ops, t_bytes)
        log(f"kernel {case['label']}: max_abs_err={err:.3g} (tol {tol:.3g})"
            f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f}"
            f" bound_ms={bound_ms:.5f} ({'operations' if t_ops >= t_bytes else 'bytes'})")
        agg = summary.setdefault(name, dict(
            calls=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
            bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0))
        agg["calls"] += 1
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["library_ms"] += library_ms
        agg["bound_ms"] += bound_ms
        agg["ops_ms" if t_ops >= t_bytes else "bytes_ms"] += bound_ms
    return summary


# ---------------------------------------------------------------------------
# Phases 4 and 5: whole networks


def run_cell(model, batch, rng, profile=False):
    """Compile ``model`` both ways, drive the cuda one once with counts at
    zero, compare, and time.  Returns the launch counts of that forward."""
    import torch

    import repro_torch
    from repro_torch.core.conv_spec import ConvAlgorithm
    from repro_torch.models.cnn import init_cnn, random_batchnorm

    # Seeded weights with random batchnorm statistics, so folding is
    # exercised.
    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    h, w = model.input_hw
    x = torch.tensor(
        rng.standard_normal((batch, h, w, model.in_channels)).astype(np.float32),
        device="cuda")
    cu = repro_torch.compile(model, params,
                             repro_torch.ExecutionOptions(batch=batch))
    plain = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", device="cuda", batch=batch))

    reset_counts()
    y = cu.run(x)
    torch.cuda.synchronize()
    counts = read_counts()

    planned = cu.network_plan(batch).algorithm_counts()
    want = {
        "gemm": planned.get(ConvAlgorithm.DIRECT, 0),
        "im2col_conv": planned.get(ConvAlgorithm.IM2COL_GEMM, 0),
        "winograd_fused": planned.get(ConvAlgorithm.WINOGRAD, 0),
    }
    if counts != want:
        raise AssertionError(f"{model.name} b{batch}: launches {counts} != "
                             f"planned steps {want}")
    y_ref = plain.run(x)
    torch.cuda.synchronize()
    scale = float(y_ref.abs().max())
    err = float((y - y_ref).abs().max())
    if not (bool(torch.isfinite(y).all()) and y.shape == y_ref.shape
            and err <= NET_RTOL * max(scale, 1.0)
            and torch.allclose(y, y_ref, rtol=NET_RTOL,
                               atol=NET_RTOL * max(scale, 1.0))):
        raise AssertionError(f"{model.name} b{batch}: cuda vs torch max_abs_err"
                             f" {err} (max|ref| {scale})")

    for _ in range(3):
        cu.run(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FORWARD_REPS):
        cu.run(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FORWARD_REPS
    plain_ms = cuda_ms(lambda: plain.run(x), reps=5)
    log(f"model {model.name} {h}x{w} b{batch}: out {tuple(y.shape)} "
        f"max_abs_err={err:.3g} max|ref|={scale:.3g} launches={counts} "
        f"ms_per_forward={ms:.3f} images_per_s={batch * 1e3 / ms:.1f} "
        f"plain_ms_per_forward={plain_ms:.3f}")
    if profile:
        profile_forward(cu, x, ms)
    return counts


def profile_forward(compiled, x, ms_per_forward: float, reps: int = 5) -> None:
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
    log(f"profile b{x.shape[0]}: device busy {busy_ms:.4f} ms per forward in "
        f"{sum(r[1] for r in rows)} kernel launches; idle share "
        f"{max(0.0, 1.0 - busy_ms / ms_per_forward):.3f} of {ms_per_forward:.3f} ms")
    for us, n, key in rows[:12]:
        log(f"  profile {us / 1e3:.4f} ms x{n} {key[:90]}")
    # Each port kernel's launches in forward order, median over the reps.
    kernels = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    for name in ("winograd_fused_kernel", "im2col_conv_kernel",
                 "gemm_bias_act_kernel"):
        us = [ev.time_range.elapsed_us() for ev in kernels if name in ev.name]
        n = len(us) // reps
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
    from repro_torch.configs import yolov3
    from repro_torch.core.netplan import plan_network
    from repro_torch.core.planner import Planner
    from repro_torch.hw import H100, check_device
    from repro_torch.kernels import _build

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
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # Phase 3: each kernel against its plain version at every shape the
    # three model cells give it; timed at the main path's (tiny, batch 1).
    rng = np.random.default_rng(SEED)
    summary = None
    for model, batch in ((yolov3.TINY_MODEL, 1), (yolov3.TINY_MODEL, 4),
                         (yolov3.MODEL_20, 1)):
        netplan = plan_network(model.layers, *model.input_hw, Planner(),
                               in_channels=model.in_channels, batch=batch)
        got = check_kernels(netplan, rng, H100, f"{model.name} b{batch}",
                            timed=summary is None)
        summary = got if summary is None else summary

    # Phase 4: YOLOv3-tiny end to end; batch 1 is the main path whose
    # launch counts the kernels line reports.
    launches = run_cell(yolov3.TINY_MODEL, 1, rng, profile=True)
    run_cell(yolov3.TINY_MODEL, 4, rng)

    # Phase 5: MODEL_20 at 608 (stride-2 im2col, shortcut).
    run_cell(yolov3.MODEL_20, 1, rng)

    # Phase 6: the kernels line, then the last line.
    kernels = []
    for name, agg in summary.items():
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/" + _build.SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": agg["max_abs_err"],
            "ms": agg["ms"],
            "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": ("operations" if agg["ops_ms"] >= agg["bytes_ms"]
                         else "bytes"),
            "library_ms": agg["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Dry run of every (arch x shape x mesh) cell on the H100: the port of
``repro/launch/dryrun.py``.  No card and no memory are needed.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single --table
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \\
        --shape train_4k --mesh multi --overrides '{"remat":"dots"}' --tag rematdots

Per cell this traces the cell's step (``make_train_step``'s pieces,
``make_prefill_step`` or ``make_serve_step``) on fake tensors of the
cell's full global shapes (``FakeTensorMode``), prices it with
``roofline.analysis`` and writes ``<out>/<arch>__<shape>__<mesh>[__tag].json``
with the reference's keys.  The figures:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the trace (its
  matrix products; elementwise work counts 0).  Attention goes through a
  shape-only stand-in for the flash kernels' calls (``FlashStandIn``),
  which allocates what the kernel wrappers allocate and adds the kernels'
  work at the valid (query, key) pairs of their mask: 4 hd FLOPs a pair
  and query head forward, 10 hd backward, as ``PERF.md``'s flash bounds
  count them.  The reference counts XLA's dense S^2; both are written.
  Under remat the recomputed forward is traced, so it counts again.
- Per device: the global step's FLOPs and bytes over the chips, the
  optimizer update's bytes over each leaf's moment shards only (a
  replicated leaf is updated on every chip).
- Bytes: the unfused sum of the inputs and outputs of every aten op that
  is not a view or an allocation, plus the flash kernels' operands read
  once and results written once: an upper bound, as XLA's "bytes
  accessed" is.
- Memory per device: arguments (params, optimizer state, batch, decode
  cache), each over its spec's shard count (``distributed/sharding.py``);
  temporaries, the peak of the fake storages made during the step and
  alive together, over the chips (the ideal split).  The arguments' own
  storages are not temporaries, also where a view of one (a weight's
  transpose, a microbatch) is kept for the backward.
- Collectives: from the rules, not from a trace (``collectives``), each a
  ``CollectiveOp`` priced by the reference's ring model on the slowest
  link its group crosses.
- No scan correction: the port's layers are a plain list, so the trace
  sees every layer (``scan_correction_periods`` is 0).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.configs.base import SHAPES, ShapeSpec, cell_is_runnable
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import MeshShape, largest_divisible_subset
from repro_torch.kernels.flash_attention.ops import (
    bwd_head_split,
    bwd_workspace_shape,
)
from repro_torch.kernels.flash_attention.ref import unmasked_pairs
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw, constant
from repro_torch.optim.quantized_state import QTensor
from repro_torch.roofline import analysis as ra
from repro_torch.train import step as step_lib

RESULTS_DIR = os.path.join("build", "dryrun_torch")


def _moment_dtype(cfg) -> str:
    """Memory plan for >5B-param archs: bf16 Adam moments (the
    reference's: int8's flat blocks defeat SPMD sharding there)."""
    return "bfloat16" if cfg.param_count() > 5e9 else "float32"


# ---------------------------------------------------------------------------
# Tracing


class StepTrace(TorchDispatchMode):
    """Bytes moved by every aten op and the fake storages alive: a storage
    counts from the first op that returns a tensor on it until every such
    tensor is gone, except the storages of ``held`` (the step's arguments,
    counted apart).  ``phase`` names the part of the step that ``bytes``
    is summed into (``add_bytes`` adds a stand-in's operands there)."""

    _SKIP = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh")

    def __init__(self, held=()):
        super().__init__()
        self._held = {t.untyped_storage()._cdata for t in held}
        self.phase = "model"
        self.bytes: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}

    def add_bytes(self, n: float) -> None:
        self.bytes[self.phase] = self.bytes.get(self.phase, 0.0) + n

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [0, st.nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view and func.__name__.split(".")[0] not in self._SKIP:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.add_bytes(sum(t.nbytes for t in ins + outs))
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class AttentionWork:
    """The flash kernels' work as the stand-in counts it."""

    flops: float = 0.0          # at the valid pairs
    dense_flops: float = 0.0    # at every (query, key) pair: XLA's count
    calls: int = 0


class FlashStandIn:
    """A shape-only stand-in for ``flash_attention`` (forward and, under
    grad, the backward kernel's call): outputs of the wrappers' shapes and
    dtypes, the wrappers' allocations (o and lse; dq, dk, dv, the row dot
    and the head split's fp32 partials), the kernels' FLOPs into ``work``
    and their operand bytes into ``trace``."""

    def __init__(self, work: AttentionWork, trace: StepTrace):
        self.work, self.trace = work, trace
        stand_in = self

        class Function(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal, window, logit_cap):
                out, lse = stand_in.forward(q, k, v, causal, window, True)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.args = (causal, window)
                return out

            @staticmethod
            def backward(ctx, dout):
                q, k, v, out, lse = ctx.saved_tensors
                return (*stand_in.backward(q, k, v, out, dout, lse, *ctx.args),
                        None, None, None)

        self.function = Function

    def _count(self, q, k, causal, window, per_pair):
        b, s, h, hd = q.shape
        sk = k.shape[1]
        self.work.flops += per_pair * hd * b * h * unmasked_pairs(s, sk, causal, window)
        self.work.dense_flops += per_pair * hd * b * h * s * sk
        self.work.calls += 1

    def forward(self, q, k, v, causal, window, with_lse):
        b, s, h, _ = q.shape
        out = torch.empty_like(q)
        lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if with_lse else None)
        self._count(q, k, causal, window, 4)
        self.trace.add_bytes(sum(t.nbytes for t in (q, k, v, out))
                             + (lse.nbytes if with_lse else 0))
        return out, lse

    def backward(self, q, k, v, out, dout, lse, causal, window):
        b, s, h, hd = q.shape
        sk, kv = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        rowdot = torch.empty_like(lse)
        split = bwd_head_split(b, kv, sk, h // kv, hd)
        ws = (torch.empty(bwd_workspace_shape(split, b, sk, kv, hd),
                          dtype=torch.float32, device=q.device)
              if split > 1 else None)
        self._count(q, k, causal, window, 10)
        self.trace.add_bytes(sum(t.nbytes for t in (q, k, v, out, dout, lse,
                                                     dq, dk, dv)))
        del rowdot, ws
        return dq, dk, dv

    def __call__(self, q, k, v, causal=True, window=0, logit_cap=0.0,
                 impl="cuda"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return self.function.apply(q, k, v, causal, window, logit_cap)
        return self.forward(q, k, v, causal, window, False)[0]

    @contextlib.contextmanager
    def installed(self):
        """The models' attention calls this stand-in for the duration."""
        real = attn_lib.flash_attention
        attn_lib.flash_attention = self
        try:
            yield
        finally:
            attn_lib.flash_attention = real


@dataclasses.dataclass
class Traced:
    flops: float                 # FlopCounterMode's, plus attention's at valid pairs
    dense_flops: float           # the same with attention at every pair
    attention: AttentionWork
    bytes: Dict[str, float]      # by phase: "model", "update"
    peak_temp_bytes: int
    output: object


def trace(fake, fn, *args) -> Traced:
    """``fn(*args)`` on fake tensors, counted (``FlopCounterMode``,
    ``StepTrace``, ``FlashStandIn``).  ``fn`` may set ``trace.phase``: it
    receives the ``StepTrace`` as its first argument."""
    from torch.utils.flop_counter import FlopCounterMode

    work = AttentionWork()
    steps = StepTrace(t for t in tree_lib.leaves(list(args))
                      if isinstance(t, torch.Tensor))
    with fake, FlopCounterMode(display=False) as counter, \
            FlashStandIn(work, steps).installed(), steps:
        out = fn(steps, *args)
    flops = float(counter.get_total_flops())
    return Traced(flops + work.flops, flops + work.dense_flops, work,
                  dict(steps.bytes), steps.peak, out)


# ---------------------------------------------------------------------------
# Collectives from the rules


def _dp_axes(mesh: MeshShape, mode: str) -> Tuple[str, ...]:
    if mode == "dp_only":
        return tuple(mesh.axis_names)
    if mode == "dp_seq":
        return tuple(a for a in mesh.axis_names if a != "model")
    return tuple(a for a in shd.DP if a in mesh.sizes)


def _dtype_bytes(name: str) -> int:
    return 2 if name in ("bfloat16", "float16") else 4


def collectives(cfg, shape: ShapeSpec, mesh: MeshShape, mode: str,
                grad_accum: int, params, psh, moment_specs
                ) -> List[Tuple[ra.CollectiveOp, Tuple[str, ...]]]:
    """(op, the mesh axes of its group) of every collective one step of
    the cell needs under the rules, per device:

    - default mode, on ``model`` (tensor parallel): per mixer block and per
      MLP or MoE block, one all-reduce of the local activation in the
      forward (again in a rematerialized forward) and one in the
      backward (the column- and row-parallel pairs); the vocab-parallel
      embedding's forward all-reduce; the vocab-parallel head's three
      fp32 row all-reduces (max, sum, gold logit) forward and its
      activation all-reduce backward, or, without a loss, an all-gather of
      the logits it returns;
    - MoE, on the DP axes: the all-to-all of ``expert_in`` in and out of
      the experts, forward (again under remat) and backward;
    - dp_seq, on ``model`` (context parallel): each attention layer's K
      and V all-gathered forward and their gradients reduce-scattered
      backward;
    - gradients (train), once a step: a ZeRO leaf's reduce-scatter over
      its moment's DP axes and the all-gather of its updated slice; a
      leaf whose moments are not DP-sharded, an all-reduce over the DP
      axes.
    Each per microbatch where it is per token."""
    sizes = mesh.sizes
    train = shape.kind == "train"
    act = _dtype_bytes(cfg.dtype)
    tp_axes = ("model",) if (mode == "default" and sizes.get("model", 1) > 1) else ()
    tp = sizes.get("model", 1)
    dp_axes = _dp_axes(mesh, mode)
    rows_global = shape.global_batch // (grad_accum if train else 1)
    kept = largest_divisible_subset(rows_global, dp_axes, sizes)
    dp = math.prod(sizes[a] for a in kept)
    rows = rows_global // dp
    seq = 1 if shape.kind == "decode" else shape.seq_len
    if mode == "dp_seq" and seq % tp == 0:
        seq //= tp
    micro = grad_accum if train else 1
    remat = train and cfg.remat != "none"
    n_periods, pat, _ = tf._period_split(cfg)
    in_period = n_periods * len(pat)
    ops: List[Tuple[ra.CollectiveOp, Tuple[str, ...]]] = []

    def add(kind, nbytes, axes, count=1):
        g = math.prod(sizes[a] for a in axes)
        if g > 1:
            ops.extend([(ra.CollectiveOp(kind, int(nbytes), g), axes)] * count)

    x_bytes = rows * seq * cfg.d_model * act
    for i, bt in enumerate(cfg.pattern_layers):
        fwd = 1 + (remat and i < in_period)
        bwd = 1 if train else 0
        blocks = 1 + ("moe" in params["layers"][i] or "mlp" in params["layers"][i])
        add("all-reduce", x_bytes, tp_axes, micro * blocks * (fwd + bwd))
        if "moe" in params["layers"][i]:
            tokens = rows_global * (1 if shape.kind == "decode" else shape.seq_len)
            cap = moe_lib.capacity(tokens, cfg.top_k, cfg.capacity_factor,
                                   cfg.num_experts)
            moe_axes = tuple(a for a in dp_axes if a in kept)
            add("all-to-all", cfg.num_experts * cap * cfg.d_model * act / dp,
                moe_axes, micro * 2 * (fwd + bwd))
        if mode == "dp_seq" and bt in ("attn", "local"):
            kv = 2 * rows * shape.seq_len * cfg.num_kv_heads * cfg.resolved_head_dim * act
            add("all-gather", kv, ("model",), micro * fwd)
            add("reduce-scatter", kv / tp, ("model",), micro * bwd)
    if "embed" in params:
        add("all-reduce", x_bytes, tp_axes, micro)
    head_rows = rows * (seq if train else 1)
    if train:
        add("all-reduce", head_rows * 4, tp_axes, micro * 3)
        add("all-reduce", x_bytes, tp_axes, micro)
    else:
        add("all-gather", head_rows * cfg.vocab_size * act, tp_axes)
    if train:
        for p, spec, mspec in zip(tree_lib.leaves(params),
                                          tree_lib.leaves(psh),
                                          tree_lib.leaves(moment_specs)):
            local = p.numel() * p.element_size() / shd.shard_count(spec, mesh)
            held = {a for e in spec for a in shd._axes(e)}
            zaxes = tuple(a for e in mspec for a in shd._axes(e)
                          if a in dp_axes and a not in held)
            if zaxes:
                z = math.prod(sizes[a] for a in zaxes)
                add("reduce-scatter", local / z, zaxes)
                add("all-gather", local, zaxes)
            else:
                add("all-reduce", local, tuple(a for a in dp_axes if a not in held))
    return ops


# ---------------------------------------------------------------------------
# Cells


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _spec_bytes(leaves_specs, mesh: MeshShape) -> float:
    return sum(_nbytes(t) / shd.shard_count(s, mesh) for t, s in leaves_specs)


def build_cell(arch: str, shape_name: str, multi_pod: bool = False,
               overrides: Optional[dict] = None, *,
               mesh: Optional[MeshShape] = None,
               shape: Optional[ShapeSpec] = None,
               cfg=None) -> dict:
    """One cell's figures.  ``overrides``: the reference's (``grad_accum``,
    ``moment_dtype``, ``sharding_mode``, and any config field); ``mesh``,
    ``shape`` and ``cfg`` replace the production mesh, the named shape and
    the arch's config (the card's one-device check runs a 1 x 1 mesh at
    its own batch; the tests a smoke config)."""
    overrides = dict(overrides or {})
    shape = SHAPES[shape_name] if shape is None else shape
    cfg = configs.get_config(arch) if cfg is None else cfg
    run_overrides = dict(overrides)
    grad_accum = int(run_overrides.pop("grad_accum", 1))
    moment_dtype = run_overrides.pop("moment_dtype", _moment_dtype(cfg))
    mode = run_overrides.pop("sharding_mode", "default")
    if run_overrides:
        cfg = dataclasses.replace(cfg, **run_overrides)
    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": reason}
    mesh = production_mesh_shape(multi_pod) if mesh is None else mesh
    chips = mesh.size
    opt_cfg = AdamWConfig(lr=constant(1e-4), moment_dtype=moment_dtype)

    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.monotonic()
    fake = FakeTensorMode()
    with fake:
        params = tf.init_params(cfg, torch.Generator())
        batch = {k: torch.zeros(s, dtype=dt) for k, (s, dt)
                 in configs.input_specs(cfg, shape).items()}
    if mode in ("dp_only", "dp_seq"):
        # Params replicated; the batch over the largest divisible subset of
        # the DP axes, dp_seq's sequence dim over 'model' too; ZeRO moments
        # over every axis (the reference's dryrun.py:89-129).
        psh = tree_lib.tree_map(lambda _: (), params)
        dp_axes = tuple(mesh.axis_names)
        bsh = shd.batch_specs(batch, mesh, dp_axes=_dp_axes(mesh, mode))
        tp = mesh.sizes.get("model")
        if mode == "dp_seq" and tp:
            bsh = {k: ((s[0] if s else None, "model") + (None,) * (t.ndim - 2)
                       if t.ndim >= 2 and t.shape[1] % tp == 0 else s)
                   for (k, s), t in zip(bsh.items(), batch.values())}
    else:
        psh = shd.param_specs(params, mesh)
        dp_axes = shd.DP
        bsh = shd.batch_specs(batch, mesh)
    args = (_spec_bytes(zip(tree_lib.leaves(params), tree_lib.leaves(psh)), mesh)
            + _spec_bytes(((batch[k], bsh[k]) for k in batch), mesh))

    update_share = 1.0
    mspecs = psh
    if shape.kind == "train":
        with fake:
            opt = adamw.init(opt_cfg, params)
        osh = shd.opt_state_specs(opt, params, mesh, dp_axes=dp_axes, psh=psh)
        for name in ("m", "v"):
            # A QTensor moment's specs are its payload's and its scales'.
            args += _spec_bytes(zip(tree_lib.leaves(getattr(opt, name)),
                                    tree_lib.leaves(getattr(osh, name))), mesh)
        mspecs = tree_lib.tree_map(lambda p, s: s.q if isinstance(s, QTensor) else s,
                                   params, osh.m)
        # The update's share on one chip: each leaf over its moments' shards.
        numels = [p.numel() for p in tree_lib.leaves(params)]
        update_share = sum(n / shd.shard_count(m, mesh) for n, m in zip(
            numels, tree_lib.leaves(mspecs))) / sum(numels)

        def fn(steps, params, opt, batch):
            steps.phase = "model"
            metrics, grads = step_lib.accumulated_grads(cfg, params, batch,
                                                        grad_accum, "cuda")
            steps.phase = "update"
            return adamw.update(opt_cfg, grads, opt, params)

        traced = trace(fake, fn, params, opt, batch)
    elif shape.kind == "prefill":
        step = step_lib.make_prefill_step(cfg, "cuda")

        def fn(steps, params, batch):
            with torch.no_grad():
                return step(params, batch)

        traced = trace(fake, fn, params, batch)
    else:
        with fake:
            cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len)
            pos = torch.zeros((), dtype=torch.int32)
        csh = shd.cache_specs(cache, mesh)
        args += _spec_bytes(zip(tree_lib.leaves(cache), tree_lib.leaves(csh)), mesh)
        step = step_lib.make_serve_step(cfg)

        def fn(steps, params, cache, tokens, pos):
            with torch.no_grad():
                return step(params, cache, tokens, pos)

        traced = trace(fake, fn, params, cache, batch["tokens"], pos)
    trace_s = time.monotonic() - t0

    model_bytes = traced.bytes.get("model", 0.0)
    update_bytes = traced.bytes.get("update", 0.0)
    ops = collectives(cfg, shape, mesh, mode, grad_accum, params, psh, mspecs)
    coll = ra.price([op for op, _ in ops], [ra.link_bandwidth(
        mesh.shape, [mesh.axis_names.index(a) for a in axes]) for _, axes in ops])
    temp = traced.peak_temp_bytes / chips
    stats = ra.CellStats(
        flops_per_device=traced.flops / chips,
        bytes_per_device=model_bytes / chips + update_bytes * update_share,
        collective_wire_bytes=coll.collective_wire_bytes,
        collective_counts=coll.collective_counts,
        arg_bytes=args, temp_bytes=temp, out_bytes=0.0,
        collective_time_s=coll.collective_time_s)
    report = ra.roofline(stats, chips, ra.model_flops_for(cfg, shape),
                         dtype=cfg.dtype)
    dense = ra.roofline(dataclasses.replace(stats, flops_per_device=traced.dense_flops / chips),
                        chips, report.model_flops, dtype=cfg.dtype)
    mesh_name = "x".join(str(n) for n in mesh.shape)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "skipped": False,
        "lower_s": round(trace_s, 2),
        "compile_s": 0.0,
        "moment_dtype": moment_dtype if shape.kind == "train" else None,
        "overrides": overrides,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "grad_accum": grad_accum,
        "sharding_mode": mode,
        "memory": {
            "argument_bytes": int(args),
            "output_bytes": 0,
            "temp_bytes": int(temp),
            "total_per_device_gib": round((args + temp) / 2 ** 30, 3),
        },
        "attention": {
            "calls": traced.attention.calls,
            "flops_valid_pairs": traced.attention.flops,
            "flops_dense": traced.attention.dense_flops,
            "hlo_flops_global_dense_attention": traced.dense_flops,
            "compute_s_dense_attention": dense.compute_s,
        },
        "scan_correction_periods": 0,
        "roofline": report.as_dict(),
    }



def run_cell(arch, shape_name, mesh_kind, overrides, tag, out_dir,
             skip_existing=False) -> Optional[dict]:
    """One cell into ``<out_dir>/<arch>__<shape>__<single|multi>[__tag].json``
    (an error is written there too, with its traceback)."""
    multi = mesh_kind == "multi"
    name = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
    if tag:
        name += f"__{tag}"
    out_path = os.path.join(out_dir, name + ".json")
    if skip_existing and os.path.exists(out_path):
        print(f"[skip existing] {name}")
        return None
    print(f"[cell] {name} ...", flush=True)
    t0 = time.monotonic()
    try:
        result = build_cell(arch, shape_name, multi, overrides)
    except Exception as e:  # a cell that fails is recorded, the sweep goes on
        result = {"arch": arch, "shape": shape_name, "skipped": False,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()}
    result["wall_s"] = round(time.monotonic() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[done] {name}: {summary(result)} ({result['wall_s']}s)", flush=True)
    return result


def summary(result: dict) -> str:
    """One line of a cell's result: its terms, dominant bound, fraction,
    model FLOPs, GiB per device and collective counts."""
    if result.get("skipped"):
        return "SKIP: " + result["reason"]
    if "error" in result:
        return "ERROR: " + result["error"]
    rl, att = result["roofline"], result["attention"]
    return (f"ok trace={result['lower_s']}s compute_s={rl['compute_s']:.6g} "
            f"memory_s={rl['memory_s']:.6g} collective_s={rl['collective_s']:.6g} "
            f"dominant={rl['dominant']} frac={rl['roofline_frac']:.3f} "
            f"model_flops={rl['model_flops']:.6g} flops_global={rl['hlo_flops_global']:.6g} "
            f"(attention at every pair {att['hlo_flops_global_dense_attention']:.6g}) "
            f"gib_per_device={result['memory']['total_per_device_gib']} "
            f"collectives={rl['collective_counts']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dry run of the port's LM cells "
                                             "on the H100 (no card needed).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="then print the roofline table of --out's cells of --tag")
    args = ap.parse_args(argv)

    overrides = json.loads(args.overrides)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in configs.ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    for arch, shape_name in cells:
        for mk in meshes:
            run_cell(arch, shape_name, mk, overrides, args.tag, args.out,
                     skip_existing=args.skip_existing)
    if args.table:
        from repro_torch.roofline import table

        print("\n".join(table.rows(table.load_cells(args.out, args.tag),
                                   markdown=True)))


if __name__ == "__main__":
    main()

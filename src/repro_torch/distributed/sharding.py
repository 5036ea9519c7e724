"""Partition rules: the port of ``repro/distributed/sharding.py``.
Param-path regex -> spec, plus ZeRO sharding of optimizer state across
the DP axes.

Megatron-style TP on the 'model' axis:
  - column-parallel up-projections (wq/wk/wv, w_gate, w_up) shard the output
    feature dim; row-parallel down-projections (wo, w_down) shard the input
    dim -> one all-reduce per block.
  - vocab-parallel embeddings/head shard the vocab dim.
  - MoE expert banks shard experts over the DP axes (EP) x features over
    'model' (TP).
Optimizer moments additionally shard over ('pod','data') where divisible
(ZeRO): see ``zero_spec``.

Everything here is a pure function of shapes, paths and a ``MeshShape``:
a spec is a tuple with one entry a dim, each None, an axis name or a
tuple of names (the reference's ``PartitionSpec``).  The port's layers
are a plain list (``layers/<i>/mixer/wq``), where the reference stacks
them by period (``period/0:attn/mixer/wq``) with a scan dim in front,
which its rules leave unsharded: the rules match path suffixes, so they
give the same specs here without that dim.  ``placements`` turns a spec
into ``DTensor`` placements on a ``DeviceMesh`` for real execution.
"""
from __future__ import annotations

import math
import re
from typing import Sequence, Tuple

from repro_torch import tree as tree_lib
from repro_torch.distributed.context import (
    MeshShape,
    Spec,
    largest_divisible_subset,
)

DP = ("pod", "data")
TP = "model"

# (regex over the flattened param path, spec builder).  Paths look like
# 'layers/0/mixer/wq' or 'layers/1/mlp/w_down'.
_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"embed/table$",            (TP, None)),        # vocab-parallel
    (r"head$",                   (None, TP)),
    (r"frontend_proj$",          (None, TP)),
    (r"mixer/w[qkv]$",           (None, TP)),        # column-parallel
    (r"mixer/b[qkv]$",           (TP,)),
    (r"mixer/wo$",               (TP, None)),        # row-parallel
    (r"(mlp|dense_mlp)/w_(gate|up)$", (None, TP)),
    (r"(mlp|dense_mlp)/b_up$",   (TP,)),
    (r"(mlp|dense_mlp)/w_down$", (TP, None)),
    (r"(mlp|dense_mlp)/b_down$", (None,)),
    (r"moe/router$",             (None, None)),
    (r"moe/w_(gate|up)$",        (DP, None, TP)),    # EP x TP
    (r"moe/w_down$",             (DP, TP, None)),
    (r"mixer/w_(y|gate)$",       (None, TP)),        # rglru branches
    (r"mixer/w_out$",            (TP, None)),
    (r"mixer/conv_w$",           (None, TP)),
    (r"mixer/conv_b$",           (TP,)),
    (r"mixer/w_[ax]$",           (None, TP)),
    (r"mixer/b_[ax]$",           (TP,)),
    (r"mixer/lam$",              (TP,)),
    (r"mixer/w_up$",             (None, TP)),        # mlstm up (d, 2d)
    (r"mixer/w_down$",           (TP, None)),
    (r"mixer/w_[if]$",           (None, None)),      # tiny per-head gates
    (r"mixer/b_[if]$",           (None,)),
    (r"mixer/w_in$",             (None, TP)),        # slstm
    (r"mixer/b_in$",             (TP,)),
    (r"mixer/r$",                (None, None, None)),
    (r"mixer/out_norm$",         (None,)),
    (r"(norm1|norm2|post_norm1|post_norm2|final_norm)$", (None,)),
)


def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def spec_for_path(path_str: str) -> Spec:
    """The spec of one param: its rule's."""
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            return tuple(spec)
    return ()  # replicate by default (scalars, unmatched leaves)


def _filter_axes(spec: Spec, mesh: MeshShape) -> Spec:
    names = set(mesh.axis_names)

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        kept = tuple(a for a in entry if a in names)
        return kept if len(kept) > 1 else (kept[0] if kept else None)

    return tuple(fix(e) for e in spec)


def shard_count(spec: Spec, mesh: MeshShape) -> int:
    """Devices a tensor of ``spec`` is split over (1: replicated)."""
    sizes = mesh.sizes
    return math.prod(sizes[a] for e in spec for a in _axes(e))


def _divisible(shape, spec: Spec, mesh: MeshShape) -> bool:
    sizes = mesh.sizes
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        if dim % math.prod(sizes[a] for a in _axes(entry)) != 0:
            return False
    return True


def param_spec(path: str, shape, mesh: MeshShape) -> Spec:
    """One param's spec: its rule's, absent axes dropped, replicated
    where the rule does not divide its shape."""
    spec = _filter_axes(spec_for_path(path), mesh)
    return spec if _divisible(shape, spec, mesh) else ()


def param_specs(params, mesh: MeshShape):
    """The spec of every param, as the params' tree."""
    return tree_lib.map_with_paths(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh), params)


def zero_spec(shape, spec: Spec, mesh: MeshShape, dp_axes=DP) -> Spec:
    """Add ZeRO: shard the first free, divisible dim of an optimizer-moment
    tensor over the DP axes (on top of its param's TP sharding)."""
    sizes = mesh.sizes
    dp = tuple(a for a in dp_axes if a in sizes)
    if not dp:
        return spec
    dp_size = math.prod(sizes[a] for a in dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # Already DP-sharded somewhere (e.g. MoE expert banks)?  Nothing to add.
    used = {a for e in entries for a in _axes(e)}
    if used & set(dp):
        return spec
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        if entry is None and dim % dp_size == 0:
            entries[i] = dp if len(dp) > 1 else dp[0]
            return tuple(entries)
        if entry is not None:
            axes = _axes(entry)
            tp_size = math.prod(sizes[a] for a in axes)
            if dim % (tp_size * dp_size) == 0:
                entries[i] = tuple(dp) + axes
                return tuple(entries)
    return spec  # nothing divisible: leave as the param spec


def moment_spec(shape, p_spec: Spec, mesh: MeshShape, dp_axes=DP) -> Spec:
    """A float moment's spec: its param's plus ZeRO (``zero_spec``), or
    the param's where that does not divide the shape."""
    spec = zero_spec(tuple(shape), p_spec, mesh, dp_axes=dp_axes)
    return spec if _divisible(tuple(shape), spec, mesh) else p_spec


def opt_state_specs(opt_state, params, mesh: MeshShape, dp_axes=DP, psh=None):
    """Specs of an ``AdamWState``: step replicated; moments = param spec +
    ZeRO over ``dp_axes``.

    int8 QTensor moments are always (-1, 256)-blocked, so their block dim
    shards across DP x TP uniformly: a ``QTensor`` of (payload spec,
    scales spec)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.quantized_state import QTensor

    psh = param_specs(params, mesh) if psh is None else psh
    sizes = mesh.sizes
    all_ax = tuple(a for a in ("pod", "data", "model") if a in sizes)
    total = math.prod(sizes[a] for a in all_ax)

    def build(m_leaf, p_spec):
        if isinstance(m_leaf, QTensor):
            nblocks = m_leaf.q.shape[0]
            ax = all_ax if (total and nblocks % total == 0) else ()
            entry = ax if len(ax) > 1 else (ax[0] if ax else None)
            return QTensor((entry, None), (entry,), m_leaf.shape)
        return moment_spec(m_leaf.shape, p_spec, mesh, dp_axes)

    # A spec is a tuple, a tree leaf of repro_torch.tree; the params' tree
    # leads, so a QTensor moment is passed whole.
    return AdamWState(
        step=(),
        m=tree_lib.tree_map(lambda _, m, s: build(m, s), params, opt_state.m, psh),
        v=tree_lib.tree_map(lambda _, v, s: build(v, s), params, opt_state.v, psh))


def batch_specs(batch, mesh: MeshShape, dp_axes=DP):
    """Inputs shard their leading (batch) dim over the largest subset of
    ``dp_axes`` that divides it."""
    sizes = mesh.sizes
    dp = tuple(a for a in dp_axes if a in sizes)

    def one(leaf):
        if leaf.ndim < 1 or not dp:
            return ()
        kept = largest_divisible_subset(leaf.shape[0], dp, sizes)
        if not kept:
            return ()
        entry = kept if len(kept) > 1 else kept[0]
        return (entry,) + (None,) * (leaf.ndim - 1)

    return tree_lib.tree_map(one, batch)


def cache_specs(cache, mesh: MeshShape):
    """KV/state caches shard batch over DP; kv-heads over model when
    divisible; an mLSTM's C (B, H, hd, hd) its heads."""
    sizes = mesh.sizes
    dp = tuple(a for a in DP if a in sizes)
    spec_dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    tp = sizes.get(TP, 1)

    def one(path, leaf):
        core = tuple(leaf.shape)
        spec = [None] * len(core)
        # batch dim first; kv-head dim for 4D kv tensors.
        if len(core) >= 1 and core[0] % max(dp_size, 1) == 0 and dp and core[0] > 1:
            spec[0] = spec_dp
        if len(core) == 4 and core[2] % tp == 0:
            spec[2] = TP  # (B, S, KV, hd)
        if len(core) == 4 and "c" in path.rsplit("/", 1)[-1] and core[1] % tp == 0:
            spec = [spec[0], TP, None, None]  # mlstm C (B,H,hd,hd)
        return tuple(spec)

    return tree_lib.map_with_paths(one, cache)


def placements(spec: Spec, device_mesh):
    """The ``DTensor`` placements of ``spec`` on ``device_mesh`` (its dims
    named as the spec's axes): ``Shard(d)`` on each mesh dim that tensor
    dim d is split over, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[names.index(a)] = Shard(dim)
    return tuple(out)

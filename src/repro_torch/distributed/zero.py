"""Data-parallel training with ZeRO-sharded optimizer state, over a
``torch.distributed`` process group: the port's counterpart of the
reference's sharded train step (``jax.jit(train_step, in_shardings=(p_sh,
o_sh, b_sh))`` on a data-parallel mesh).

Every rank holds the whole parameters and one slice of every moment:

1. the batch is split by ``batch_specs`` over the group's ranks (a leaf
   whose rows do not divide stays whole on every rank);
2. each rank runs ``train.step.accumulated_grads`` on its rows (the
   flash kernels' forward and backward under ``impl="cuda"``);
3. the gradients are mean-all-reduced in fp32, as one flat buffer;
4. each rank updates its slice of each parameter and moment with
   ``adamw.update`` (clipped by the global norm of the whole gradients),
   along the dim ``sharding.moment_spec`` gives the moment on a
   ``("data",)`` mesh of the group's size; a leaf with no such dim is
   updated whole on every rank;
5. the updated slices are all-gathered, so every rank holds the same
   parameters.

With ``grad_accum`` microbatches a rank, W ranks compute what one process
computes with ``make_train_step(..., grad_accum=W * grad_accum)`` on the
whole batch (MoE capacities and aux losses are per microbatch in both);
on one rank the step is ``make_train_step``'s, bit for bit.  Tensor
parallelism on a ``model`` axis is not executed here: the port's models
and kernels run on plain tensors, not ``DTensor``s.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import MeshShape
from repro_torch.distributed.sharding import batch_specs, moment_spec, param_spec
from repro_torch.optim import adamw
from repro_torch.train.step import accumulated_grads


def dp_mesh(group=None) -> MeshShape:
    """The ``("data",)`` mesh of ``group``'s ranks."""
    import torch.distributed as dist

    return MeshShape(("data",), (dist.get_world_size(group),))


def moment_dims(params, mesh: MeshShape):
    """The dim each param's moments are split along over ``mesh``'s
    ``data`` axis, or None (kept whole), as the params' tree."""
    def dim(path, p):
        spec = moment_spec(p.shape, param_spec(path, tuple(p.shape), mesh), mesh)
        for i, entry in enumerate(spec):
            if entry == "data" or (isinstance(entry, tuple) and "data" in entry):
                return i
        return None

    return tree_lib.map_with_paths(dim, params)


def _slice(t: torch.Tensor, dim: Optional[int], rank: int, ranks: int):
    if dim is None:
        return t
    n = t.shape[dim] // ranks
    return t.narrow(dim, rank * n, n)


def _check_moments(opt_cfg: adamw.AdamWConfig) -> None:
    if opt_cfg.moment_dtype == "int8":
        raise ValueError("the ZeRO step splits float moments along a dim; "
                         "int8 moments are blocks of the flattened leaf")


def shard_opt_state(opt_state: adamw.AdamWState, params, group=None
                    ) -> adamw.AdamWState:
    """This rank's slice of a whole optimizer state: a copy where it is a
    part of a leaf, the leaf itself where it is all of it (the update
    never writes its inputs)."""
    import torch.distributed as dist

    mesh = dp_mesh(group)
    rank, ranks = dist.get_rank(group), mesh.size
    dims = moment_dims(params, mesh)

    def cut(d, m):
        part = _slice(m, d, rank, ranks)
        return m if part.numel() == m.numel() else part.clone()

    return adamw.AdamWState(step=opt_state.step.clone(),
                            m=tree_lib.tree_map(cut, dims, opt_state.m),
                            v=tree_lib.tree_map(cut, dims, opt_state.v))


def init(opt_cfg: adamw.AdamWConfig, params, group=None) -> adamw.AdamWState:
    """Zero moments of this rank's slices (``adamw.init`` on them)."""
    import torch.distributed as dist

    _check_moments(opt_cfg)
    mesh = dp_mesh(group)
    rank = dist.get_rank(group)
    return adamw.init(opt_cfg, tree_lib.tree_map(
        lambda d, p: _slice(p, d, rank, mesh.size), moment_dims(params, mesh),
        params))


def make_zero_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                         group=None, grad_accum: int = 1,
                         impl: str = "cuda") -> Callable:
    """train_step(params, opt_shard, batch) -> (params, opt_shard,
    metrics) on every rank of ``group``: ``opt_shard`` from ``init`` or
    ``shard_opt_state``; the metrics' loss is the mean over the ranks."""
    import torch.distributed as dist

    _check_moments(opt_cfg)
    mesh = dp_mesh(group)
    rank, ranks = dist.get_rank(group), mesh.size

    def train_step(params, opt_shard, batch):
        specs = batch_specs(batch, mesh)
        local = {k: _slice(v, 0 if specs[k] else None, rank, ranks)
                 for k, v in batch.items()}
        metrics, grads = accumulated_grads(cfg, params, local, grad_accum, impl)
        # One all-reduce of every gradient, as one fp32 buffer.
        leaves = tree_lib.leaves(grads)
        flat = torch.cat([g.float().reshape(-1) for g in leaves])
        dist.all_reduce(flat, group=group)
        flat.div_(ranks)
        parts = iter(flat.split([math.prod(g.shape) for g in leaves]))
        del leaves
        grads = tree_lib.tree_map(lambda g: next(parts).view(g.shape), grads)
        dims = moment_dims(params, mesh)
        cut = lambda d, t: _slice(t, d, rank, ranks)  # noqa: E731
        new_p, new_opt, opt_metrics = adamw.update(
            opt_cfg, tree_lib.tree_map(cut, dims, grads), opt_shard,
            tree_lib.tree_map(cut, dims, params),
            grad_norm=adamw.global_norm(grads))
        del grads, flat

        def gather(d, p):
            if d is None:
                return p
            parts = [torch.empty_like(p) for _ in range(ranks)]
            dist.all_gather(parts, p.contiguous(), group=group)
            return torch.cat(parts, dim=d)

        new_params = tree_lib.tree_map(gather, dims, new_p)
        loss = metrics["loss"].float().clone()
        dist.all_reduce(loss, group=group)
        metrics = {**metrics, "loss": loss / ranks}
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step

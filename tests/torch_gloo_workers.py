"""Worker processes of tests/test_torch_distributed.py's gloo tests: each
joins a gloo group through a ``file://`` rendezvous, runs its share and
writes what it computed to ``<out>/rank<r>.pt``.  Imports only torch and
the port, so a spawned worker starts quickly.  Not a test module itself.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.configs import ShapeSpec
from repro_torch.data import batch_for
from repro_torch.distributed import compression, sharding, zero
from repro_torch.distributed.context import MeshShape, to_device_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, constant

#: The ZeRO step's cells: a batch of 4 rows, S 32, two steps.
ZERO_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")
ZERO_SHAPE = ShapeSpec("t", 32, 4, "train")
ZERO_STEPS = 2
LR = 1e-3


def compression_problem(rank: int, world: int):
    """The reference suite's problem (tests/test_distributed.py::
    test_compressed_allreduce_and_convergence) over ``world`` ranks:
    (this rank's gradient row, the 200 steps of EF-compressed SGD on a
    least-squares problem from the same seeded draws on every rank)."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(world, 64)).astype(np.float32)
    return g[rank], rng


def _compression(rank: int, world: int) -> dict:
    row, rng = compression_problem(rank, world)
    g = torch.tensor(row)
    mean, err = compression.compressed_allreduce_mean(g, torch.zeros_like(g))
    w = torch.zeros(64)
    tgt = torch.tensor(rng.normal(size=(64,)), dtype=torch.float32)
    ef = torch.zeros(64)
    for _ in range(200):
        rows = [2 * (w - tgt) + 0.01 * torch.tensor(rng.normal(size=(64,)),
                                                    dtype=torch.float32)
                for _ in range(world)]
        m, ef = compression.compressed_allreduce_mean(rows[rank], ef)
        w = w - 0.05 * m
    return {"mean": mean, "error": err, "dist": float((w - tgt).norm())}


#: (mesh shape, param path, moment spec?) of the DeviceMesh cases: a
#: column-parallel weight on ``model`` and a row-parallel weight's ZeRO
#: moment over ``data`` and ``model``, each of PLACED_SHAPE.
PLACED = (((1, 2), "layers/0/mixer/wq", False),
          ((2, 1), "layers/0/mixer/wo", True))
PLACED_SHAPE = (8, 6)


def placed_tensor() -> torch.Tensor:
    return torch.arange(float(np.prod(PLACED_SHAPE))).reshape(PLACED_SHAPE)


def _placements(rank: int, world: int) -> list:
    """Per ``PLACED`` case: the ``DeviceMesh``'s dim names and shape, the
    spec, its placements as ("shard", dim) or ("replicate",), and this
    rank's shard of ``placed_tensor()`` distributed by them."""
    from torch.distributed.tensor import Shard, distribute_tensor

    out = []
    for shape, path, moment in PLACED:
        mesh = MeshShape(("data", "model"), shape)
        dm = to_device_mesh(mesh, "cpu")
        spec = sharding.param_spec(path, PLACED_SHAPE, mesh)
        if moment:
            spec = sharding.moment_spec(PLACED_SHAPE, spec, mesh)
        place = sharding.placements(spec, dm)
        out.append({
            "names": tuple(dm.mesh_dim_names), "shape": tuple(dm.shape),
            "spec": spec,
            "placements": [("shard", p.dim) if isinstance(p, Shard)
                           else ("replicate",) for p in place],
            "local": distribute_tensor(placed_tensor(), dm, place).to_local()})
    return out


def zero_inputs(arch: str):
    """(cfg, params, batch, optimizer config) of one ZeRO cell, seeded."""
    cfg = configs.smoke_config(arch)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    batch = batch_for(cfg, ZERO_SHAPE, 0, seed=0)
    return cfg, params, batch, AdamWConfig(lr=constant(LR))


def _zero(arch: str) -> dict:
    cfg, params, batch, opt_cfg = zero_inputs(arch)
    opt = zero.init(opt_cfg, params)
    step = zero.make_zero_train_step(cfg, opt_cfg, impl="torch")
    losses = []
    for _ in range(ZERO_STEPS):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return {"params": params, "losses": losses, "step": int(opt.step),
            "moment_numels": [m.numel() for m in tree_lib.leaves(opt.m)]}


def run(rank: int, world: int, init_file: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        result = {"compression": _compression(rank, world),
                  "placements": _placements(rank, world)}
        for arch in ZERO_ARCHS:
            result[arch] = _zero(arch)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()

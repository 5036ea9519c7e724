"""Shared by the port's train-step parity tests (tests/test_torch_train*.py):
the reference's loss and gradients (``jax.value_and_grad`` of
``repro.train.step.loss_fn``) and the port's (``repro_torch.train.step.
value_and_grad``) on the same smoke-size parameters and batch, in fp32,
held leaf by leaf within rtol = 1e-4, atol = 1e-4 * max(1, max|ref|) of
each leaf (``_tol`` in tests/test_api.py).  Not a test module itself.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro.train import step as j_step
from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.configs import ShapeSpec
from repro_torch.data import batch_for
from repro_torch.models import transformer as tf
from repro_torch.train import step as step_lib

SHAPE = ShapeSpec("t", 32, 4, "train")


def tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1.0))


def cfgs(arch, **changes):
    """(reference, port) smoke configs of ``arch`` with ``changes``."""
    return (dataclasses.replace(j_configs.smoke_config(arch), **changes),
            dataclasses.replace(configs.smoke_config(arch), **changes))


@functools.lru_cache(maxsize=None)
def setup(arch, num_layers=None):
    """(reference params as numpy, the port's batch as numpy); the
    reference's init, matrices scaled by 3 so activations are of order
    one."""
    changes = {} if num_layers is None else {"num_layers": num_layers}
    j_cfg, cfg = cfgs(arch, **changes)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (3.0 if a.ndim >= 2 else 1.0),
        j_tf.init_params(j_cfg, jax.random.PRNGKey(0)))
    batch = {k: v.numpy() for k, v in batch_for(cfg, SHAPE, 0, seed=1).items()}
    return tree, batch


@functools.lru_cache(maxsize=None)
def reference(arch, **changes):
    """((total loss, metrics), gradients in the port's layout) of the
    reference, as floats and CPU tensors."""
    j_cfg, cfg = cfgs(arch, **changes)
    tree, batch = setup(arch, changes.get("num_layers"))
    fn = jax.value_and_grad(lambda p: j_step.loss_fn(
        j_cfg, p, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)
    (total, metrics), grads = fn(jax.tree_util.tree_map(jnp.asarray, tree))
    grads = tf.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, grads), "cpu")
    return (float(total), {k: float(v) for k, v in metrics.items()}), grads


def check(arch, **changes):
    """The port's loss, metrics and gradients against the reference's;
    ``remat`` changes the port's config only (the reference's numbers do
    not depend on it).  Returns the port's metrics."""
    _, cfg = cfgs(arch, **changes)
    tree, batch = setup(arch, changes.get("num_layers"))
    (total, metrics), grads = step_lib.value_and_grad(
        cfg, tf.params_from_numpy(cfg, tree, "cpu"),
        {k: torch.tensor(v) for k, v in batch.items()}, impl="torch")
    (j_total, j_metrics), j_grads = reference(arch, **{
        k: v for k, v in changes.items() if k != "remat"})
    np.testing.assert_allclose(float(total), j_total, rtol=1e-5)
    assert sorted(metrics) == sorted(j_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), j_metrics[k], rtol=1e-5, atol=1e-7)
    paths = [p for p, _ in tree_lib.leaves_with_paths(j_grads)]
    for path, got, ref in zip(paths, tree_lib.leaves(grads), tree_lib.leaves(j_grads)):
        assert got.shape == ref.shape, path
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **tol(ref.numpy()),
                                   err_msg=path)
    assert ("moe_dropped_frac" in metrics) == bool(cfg.num_experts)
    return metrics

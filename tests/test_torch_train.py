"""The port's loss, gradients and train step against the JAX package's
(``repro.train.step``), on the CPU, at smoke size in fp32: the dense
family here (the other families: tests/test_torch_train_families.py and
tests/test_torch_train_recurrent.py; the shared checks:
tests/torch_train_parity.py, rtol = 1e-4, atol = 1e-4 * max(1,
max|ref|) of each gradient leaf).  Remat "none", "full" and "dots" give
the same numbers; the chunked CE (a chunk that leaves a remainder) equals
the reference's.

A train step's first AdamW update is sign-like (m / sqrt(v) is +-1 where
|g| >> eps), so a gradient element near zero that rounds to the other
sign moves its parameter by 2 lr: the steps' parameters are held within
1e-6 on all but a few elements, and within 2 lr + 1e-6 on those.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_sched
from repro.train import step as j_step
from repro_torch import optim
from repro_torch import tree as tree_lib
from repro_torch.models import transformer as tf
from repro_torch.train import step as step_lib
from torch_train_parity import cfgs, check, setup


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b", "qwen1.5-0.5b",
                                  "granite-34b"])
def test_loss_and_gradients_match_reference(arch):
    """The dense configs, each checkpointed under the default remat "full":
    llama3.2-1b (three periods of one attention layer), gemma2-27b (the
    logit and attention softcaps, local and global layers), qwen1.5-0.5b
    (QKV biases) and granite-34b."""
    check(arch)


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_remat_modes_give_the_reference_numbers(arch, remat):
    """Only memory differs between the remat modes ("full" is the configs'
    default, held above)."""
    check(arch, remat=remat)


def test_chunked_cross_entropy_matches_reference():
    """12-position chunks over 32 positions: two chunks and a remainder."""
    check("llama3.2-1b", loss_vocab_chunk=12)


def test_cross_entropy_masked_and_plain():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = rng.random((2, 5)) < 0.5
    for m in (None, mask):
        got = step_lib.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                     None if m is None else torch.tensor(m))
        ref = j_step.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def _step_params(cfg, params, batch, grad_accum, lr):
    ocfg = optim.AdamWConfig(lr=optim.constant(lr))
    fn = step_lib.make_train_step(cfg, ocfg, grad_accum, impl="torch")
    new, st, metrics = fn(params, optim.init(ocfg, params), batch)
    return new, st, metrics


def _close_but_sign_flips(got, ref, lr, max_share=1e-3):
    """Within 1e-6, but for at most ``max_share`` of the elements, which
    may differ by a sign-flipped first AdamW step: 2 lr + 1e-6."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
    assert diff.max() <= 2 * lr + 1e-6
    assert (diff > 1e-6).mean() <= max_share


def test_grad_accum_two_equals_one():
    """Two microbatches of 2 rows give the 4-row batch's loss and, after
    the update, its parameters (fp32 sums in another order)."""
    _, cfg = cfgs("llama3.2-1b")
    tree, batch = setup("llama3.2-1b")
    params = tf.params_from_numpy(cfg, tree, "cpu")
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    lr = 1e-3
    one, st1, m1 = _step_params(cfg, params, batch, 1, lr)
    two, st2, m2 = _step_params(cfg, params, batch, 2, lr)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-5)
    assert sorted(m2) == ["grad_norm", "loss", "lr"]
    for a, b in zip(tree_lib.leaves(one), tree_lib.leaves(two)):
        _close_but_sign_flips(a.numpy(), b.numpy(), lr)
    with pytest.raises(ValueError, match="microbatches"):
        _step_params(cfg, params, batch, 3, lr)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    j_cfg, cfg = cfgs("llama3.2-1b")
    tree, batch = setup("llama3.2-1b")
    lr = 1e-3
    new, st, metrics = _step_params(cfg, tf.params_from_numpy(cfg, tree, "cpu"),
                                    {k: torch.tensor(v) for k, v in batch.items()},
                                    grad_accum, lr)
    jcfg = j_adamw.AdamWConfig(lr=j_sched.constant(lr))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    j_new, _, j_metrics = jax.jit(j_step.make_train_step(j_cfg, jcfg, grad_accum))(
        jp, j_adamw.init(jcfg, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-4)
    j_new = tf.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, j_new), "cpu")
    for a, b in zip(tree_lib.leaves(new), tree_lib.leaves(j_new)):
        _close_but_sign_flips(a.numpy(), b.numpy(), lr)


def test_prefill_and_serve_steps():
    _, cfg = cfgs("qwen1.5-0.5b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    logits = step_lib.make_prefill_step(cfg, impl="torch")(params, toks)
    torch.testing.assert_close(logits, tf.forward(cfg, params, toks, impl="torch")[:, -1])
    _, cache = tf.prefill_with_cache(cfg, params, toks, 16, impl="torch")
    out, cache2 = step_lib.make_serve_step(cfg)(params, cache, toks[:, :1], 8)
    assert out.shape == (2, cfg.vocab_size) and cache2 is cache

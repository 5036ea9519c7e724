"""The port's LM prefill-with-cache and decode steps against the JAX
package's, on the CPU.

The smoke configs of llama3.2-1b, qwen1.5-0.5b and gemma2-27b, the
reference's parameters carried across by ``params_from_numpy``, the same
numpy tokens: last-token logits and the filled ring caches of
``prefill_with_cache``, then ``decode_step``s with a partial ``live``
mask.  fp32 within rtol = 1e-4, atol = 1e-4 * max(1, max|ref|), as
``_tol`` in tests/test_api.py; ring positions exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro_torch import configs
from repro_torch.models import transformer as tf

ARCHS = ("llama3.2-1b", "qwen1.5-0.5b", "gemma2-27b")


def _tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1.0))


def _setup(arch):
    """(reference cfg, port cfg, reference params as jnp, port params)."""
    j_cfg, cfg = j_configs.smoke_config(arch), configs.smoke_config(arch)
    j_params = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, j_params)
    return j_cfg, cfg, j_params, tf.params_from_numpy(cfg, tree, "cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(t):
    return t.float().numpy()


def _ref_layers(j_cfg, j_cache):
    return tf.layers_from_tree(j_cfg, jax.tree_util.tree_map(np.asarray, j_cache))


def _assert_cache_equal(cache, ref_layers):
    assert len(cache) == len(ref_layers)
    for layer, ref in zip(cache, ref_layers):
        np.testing.assert_array_equal(layer["slot_pos"].numpy(), ref["slot_pos"])
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(layer[k]), ref[k], **_tol(ref[k]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [8, 24])
def test_prefill_with_cache_matches_reference(arch, s):
    """Last-token logits and the filled ring caches, with the prompt shorter
    (8) and longer (24) than the capacity (16; gemma2's local window is 16)."""
    j_cfg, cfg, j_params, params = _setup(arch)
    toks = _tokens(cfg, 2, s)
    ref_logits, ref_cache = j_tf.prefill_with_cache(
        j_cfg, j_params, {"tokens": jnp.asarray(toks)}, capacity=16)
    logits, cache = tf.prefill_with_cache(cfg, params, torch.tensor(toks).long(),
                                          16, impl="torch")
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(_np(logits), ref_logits, **_tol(ref_logits))
    _assert_cache_equal(cache, _ref_layers(j_cfg, ref_cache))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_with_live_mask_match_reference(arch):
    """Five decode steps from a prefilled cache, rows at their own positions,
    row 1 live only on odd steps: logits every step, caches at the end."""
    j_cfg, cfg, j_params, params = _setup(arch)
    toks = _tokens(cfg, 2, 10)
    _, j_cache = j_tf.prefill_with_cache(j_cfg, j_params,
                                         {"tokens": jnp.asarray(toks)}, capacity=16)
    _, cache = tf.prefill_with_cache(cfg, params, torch.tensor(toks).long(), 16,
                                     impl="torch")
    j_decode = jax.jit(functools.partial(j_tf.decode_step, j_cfg))
    pos = np.array([10, 10])
    nxt = _tokens(cfg, 2, 5, seed=7)
    for step in range(5):
        live = np.array([True, step % 2 == 1])
        t = nxt[:, step:step + 1]
        ref, j_cache = j_decode(j_params, j_cache, jnp.asarray(t),
                                        jnp.asarray(pos, jnp.int32),
                                        live=jnp.asarray(live))
        got, cache = tf.decode_step(cfg, params, cache, torch.tensor(t).long(),
                                    torch.tensor(pos), live=torch.tensor(live))
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, **_tol(ref))
        pos = pos + live
    _assert_cache_equal(cache, _ref_layers(j_cfg, j_cache))

"""The port's LM stack against the JAX package's, on the CPU.

For the smoke configs of llama3.2-1b, qwen1.5-0.5b (QKV bias) and
gemma2-27b (local/global layers, softcaps, post-norms, embed scale; two
stacked periods and a tail), the reference's parameters go through
``params_from_numpy`` and the same numpy tokens through both packages'
full-sequence ``forward`` (tests/test_torch_lm_cache.py holds
``prefill_with_cache`` and ``decode_step``).  fp32 within
rtol = 1e-4, atol = 1e-4 * max(1, max|ref|), as ``_tol`` in
tests/test_api.py.  bf16: both packages round every projection, norm and
attention output to 8 significant bits, in other orders, so the logits are
held at a relative norm ||got - ref|| / ||ref|| <= 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
import repro_torch
from repro_torch import configs
from repro_torch.models import layers
from repro_torch.models import transformer as tf

ARCHS = ("llama3.2-1b", "qwen1.5-0.5b", "gemma2-27b")
CPU = repro_torch.ExecutionOptions(impl="torch", device="cpu")
BF16_REL = 2e-2


def _tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1.0))


def _setup(arch, seq_len=32, **changes):
    """(reference cfg, port cfg, reference params as jnp, numpy tree)."""
    j_cfg = dataclasses.replace(j_configs.smoke_config(arch, seq_len), **changes)
    cfg = dataclasses.replace(configs.smoke_config(arch, seq_len), **changes)
    j_params = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    return j_cfg, cfg, j_params, jax.tree_util.tree_map(np.asarray, j_params)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    j_cfg, cfg, j_params, tree = _setup(arch)
    toks = _tokens(cfg, 2, 32)
    ref = np.asarray(repro.compile(j_cfg, j_params).run(toks))
    params = tf.params_from_numpy(cfg, tree, "cpu")
    got = _np(repro_torch.compile(cfg, params, CPU).run(toks))
    assert got.shape == ref.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(got, ref, **_tol(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_chunked_attention(arch):
    """S above ``attn_chunked_threshold``: the reference runs its online-
    softmax ``attention_chunked`` (3 query chunks of 512, 2 kv chunks of
    768), the port the same function in its plain version."""
    j_cfg, cfg, j_params, tree = _setup(arch, attn_chunked_threshold=256)
    toks = _tokens(cfg, 1, 1536)
    ref = np.asarray(j_tf.forward(j_cfg, j_params, {"tokens": jnp.asarray(toks)})[0])
    params = tf.params_from_numpy(cfg, tree, "cpu")
    got = _np(tf.forward(cfg, params, torch.tensor(toks).long(), impl="torch"))
    np.testing.assert_allclose(got, ref, **_tol(ref))


def test_bf16_forward_matches_reference():
    j_cfg, cfg, j_params, tree = _setup("llama3.2-1b", dtype="bfloat16")
    toks = _tokens(cfg, 2, 32)
    ref = np.asarray(repro.compile(j_cfg, j_params).run(toks).astype(jnp.float32))
    out = repro_torch.compile(cfg, tf.params_from_numpy(cfg, tree, "cpu"),
                              CPU).run(toks)
    assert out.dtype == torch.bfloat16
    got = _np(out)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= BF16_REL, rel


def test_params_from_numpy_unstacks_periods_in_layer_order():
    """gemma2's smoke stack: 2 periods of (local, attn) and a local tail."""
    j_cfg, cfg, _, tree = _setup("gemma2-27b")
    assert cfg.pattern_layers == ("local", "attn", "local", "attn", "local")
    params = tf.params_from_numpy(cfg, tree, "cpu")
    assert len(params["layers"]) == 5
    wq = [p["mixer"]["wq"].numpy() for p in params["layers"]]
    np.testing.assert_array_equal(wq[0], tree["period"]["0:local"]["mixer"]["wq"][0])
    np.testing.assert_array_equal(wq[1], tree["period"]["1:attn"]["mixer"]["wq"][0])
    np.testing.assert_array_equal(wq[2], tree["period"]["0:local"]["mixer"]["wq"][1])
    np.testing.assert_array_equal(wq[3], tree["period"]["1:attn"]["mixer"]["wq"][1])
    np.testing.assert_array_equal(wq[4], tree["tail"]["0:local"]["mixer"]["wq"])
    assert "post_norm2" in params["layers"][0]


def test_init_params_matches_reference_shapes():
    for arch in ARCHS:
        j_cfg, cfg, _, tree = _setup(arch)
        ours = tf.init_params(cfg, torch.Generator().manual_seed(0))
        theirs = tf.params_from_numpy(cfg, tree, "cpu")
        def spec(t):
            return tuple(t.shape), t.dtype

        assert tf.tree_map(spec, ours) == tf.tree_map(spec, theirs)


def test_lm_facade_refuses_what_it_does_not_run():
    cfg = configs.smoke_config("llama3.2-1b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        repro_torch.ExecutionOptions(impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="applies to CNNs"):
        repro_torch.compile(cfg, params, repro_torch.ExecutionOptions(
            impl="torch", device="cpu", dtype="int8"))
    # An MoE config, once refused, now compiles and runs.
    moe = dataclasses.replace(cfg, num_experts=4, top_k=2)
    moe_params = tf.init_params(moe, torch.Generator().manual_seed(0))
    logits = repro_torch.compile(moe, moe_params, CPU).run(_tokens(moe, 1, 8))
    assert logits.shape == (1, 8, moe.vocab_size)
    assert bool(torch.isfinite(logits).all())
    report = repro_torch.compile(cfg, params, CPU).plan_report()
    assert report["kind"] == "lm" and report["impl"] == "torch"


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    """The three MLP types (gelu is jax.nn.gelu's tanh approximation)."""
    params = j_layers.init_mlp(jax.random.PRNGKey(2), 32, 48, mlp_type)
    params = {k: np.asarray(v) + (0.1 if k.startswith("b_") else 0.0)
              for k, v in params.items()}
    x = np.random.default_rng(4).normal(size=(2, 5, 32)).astype(np.float32)
    ref = np.asarray(j_layers.apply_mlp(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), mlp_type))
    got = layers.apply_mlp({k: torch.tensor(v) for k, v in params.items()},
                           torch.tensor(x), mlp_type).numpy()
    np.testing.assert_allclose(got, ref, **_tol(ref))


def test_norm_rope_embed_match_reference_in_bf16():
    """Where bf16 parity is easy to lose: rms_norm in fp32 times 1 + scale,
    RoPE on split halves with fp32 angles, the embed scale rounded to bf16
    before the multiply.  Both sides round once to bf16 at the end, from
    fp32 values that agree to a few fp32 ulps, so at most one bf16 ulp."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(6) + 1000
    bf = jnp.bfloat16

    def close(got, ref):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                                   atol=2 ** -7)

    xt = torch.tensor(x).to(torch.bfloat16)
    close(layers.rms_norm(xt, torch.tensor(scale)),
          j_layers.rms_norm(jnp.asarray(x, bf), jnp.asarray(scale)))
    close(layers.apply_rope(xt, torch.tensor(pos), 500_000.0),
          j_layers.apply_rope(jnp.asarray(x, bf), jnp.asarray(pos), 500_000.0))
    table = rng.normal(size=(50, 4608)).astype(np.float32)
    toks = np.array([[3, 7, 49]])
    got = layers.embed({"table": torch.tensor(table).to(torch.bfloat16)},
                       torch.tensor(toks), scale_by_dim=True)
    ref = j_layers.embed({"table": jnp.asarray(table, bf)}, jnp.asarray(toks),
                         scale_by_dim=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))

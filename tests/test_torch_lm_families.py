"""The port's MoE, recurrent and frontend LM families against the JAX
package's, on the CPU, through the facade.

The six configs beside the dense ones: granite-moe-1b-a400m and
arctic-480b (MoE; arctic with its parallel dense MLP), recurrentgemma-9b
(rglru, rglru, local), xlstm-125m (mLSTM and sLSTM), hubert-xlarge
(audio frames, encoder only, untied head) and internvl2-2b (vision
patches before the tokens).  At smoke size (``smoke_config``, seq 32,
fp32) the reference's parameters go through ``params_from_numpy``, with
every matrix scaled by ``SCALE`` in both packages so that activations are
of order one and the comparison sees more than the embedding; the same
numpy inputs go to ``repro.compile(...).run`` and
``repro_torch.compile(...).run``.  For every decoding config,
``prefill_with_cache`` and 4 ``decode_step``s (one with a partial live
mask) against the reference's; the serving engine's greedy tokens
against the reference engine's for granite-moe, recurrentgemma and
xlstm.  fp32 within rtol = 1e-4, atol = 1e-4 * max(1, max|ref|), as
``_tol`` in tests/test_api.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro.serving import ServingEngine as JServingEngine
import repro_torch
from repro_torch import configs
from repro_torch.models import transformer as tf

FAMILIES = ("granite-moe-1b-a400m", "arctic-480b", "recurrentgemma-9b",
            "xlstm-125m", "hubert-xlarge", "internvl2-2b")
DECODING = tuple(a for a in FAMILIES if configs.get_config(a).supports_decode)
CPU = repro_torch.ExecutionOptions(impl="torch", device="cpu")
SCALE = 4.0


def _tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1.0))


@functools.lru_cache(maxsize=None)
def _setup(arch, scale=SCALE):
    """(reference cfg, port cfg, reference params as jnp, port params);
    made once an arch (the reference's init dominates the file's time),
    and never written by the tests."""
    j_cfg, cfg = j_configs.smoke_config(arch), configs.smoke_config(arch)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0),
        j_tf.init_params(j_cfg, jax.random.PRNGKey(0)))
    return (j_cfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            tf.params_from_numpy(cfg, tree, "cpu"))


def _inputs(cfg, b, s, seed=1):
    """The model-input of ``cfg``'s family: frames, tokens after patches
    (S in all), or tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)}
    if cfg.frontend == "vision_patches":
        return {"tokens": rng.integers(0, cfg.vocab_size,
                                       (b, s - cfg.num_patches)).astype(np.int32),
                "patch_embeds": rng.normal(
                    size=(b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _port(inputs):
    if isinstance(inputs, dict):
        return {k: torch.tensor(v) for k, v in inputs.items()}
    return torch.tensor(inputs).long()


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("arch", FAMILIES)
def test_compiled_run_matches_reference(arch):
    j_cfg, cfg, j_params, params = _setup(arch)
    inputs = _inputs(cfg, 2, 32)
    ref = np.asarray(repro.compile(j_cfg, j_params).run(inputs))
    compiled = repro_torch.compile(cfg, params, CPU)
    got = _np(compiled.run(inputs))
    assert got.shape == ref.shape == (2, 32, cfg.vocab_size)
    assert float(np.abs(ref).max()) > 1.0
    np.testing.assert_allclose(got, ref, **_tol(ref))
    assert compiled.plan_report()["supports_decode"] == cfg.supports_decode


@pytest.mark.parametrize("arch", DECODING)
def test_prefill_and_decode_match_reference(arch):
    """prefill_with_cache's last logits, then 4 decode steps from its
    cache: the second with row 1 not live (its state must stay), the
    last at per-row positions.  The reference's steps are jitted once
    (every mask and position a (B,) array; the port's first step takes
    ``live=None`` and a scalar position, the same step)."""
    j_cfg, cfg, j_params, params = _setup(arch)
    b, s, cap = 2, 12, 32
    inputs = _inputs(cfg, b, s)
    j_batch = ({k: jnp.asarray(v) for k, v in inputs.items()}
               if isinstance(inputs, dict) else {"tokens": jnp.asarray(inputs)})
    ref, j_cache = jax.jit(lambda p, x: j_tf.prefill_with_cache(
        j_cfg, p, x, cap))(j_params, j_batch)
    with torch.no_grad():
        got, cache = tf.prefill_with_cache(cfg, params, _port(inputs), cap,
                                           impl="torch")
    np.testing.assert_allclose(_np(got), np.asarray(ref), **_tol(np.asarray(ref)))
    j_step = jax.jit(lambda p, c, t, pos, live: j_tf.decode_step(
        j_cfg, p, c, t, pos, live=live))
    rng = np.random.default_rng(2)
    lives = (None, np.array([True, False]), np.array([True, True]), None)
    for i, live in enumerate(lives):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = np.array([s + i, s + i - (i == 3)])
        ref, j_cache = j_step(j_params, j_cache, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(
                                  np.ones(b, bool) if live is None else live))
        with torch.no_grad():
            got, cache = tf.decode_step(
                cfg, params, cache, torch.tensor(toks).long(),
                s if i == 0 else torch.as_tensor(pos),
                live=None if live is None else torch.tensor(live))
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, **_tol(ref))
    # The caches agree leaf by leaf after the steps.
    for ours, theirs in zip(cache, tf.layers_from_tree(
            j_cfg, jax.tree_util.tree_map(np.asarray, j_cache))):
        assert set(ours) == set(theirs)
        for k, t in ours.items():
            np.testing.assert_allclose(_np(t), theirs[k], **_tol(theirs[k]))


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "recurrentgemma-9b",
                                  "xlstm-125m"))
def test_engine_tokens_match_reference_engine(arch):
    """More requests than slots, so slots are freed and re-admitted: a
    recurrent slot must start from the initial state."""
    j_cfg, cfg, j_params, params = _setup(arch)
    ours = repro_torch.compile(cfg, params, CPU).serve(batch_size=2,
                                                       capacity=32)
    theirs = JServingEngine(j_cfg, j_params, batch_size=2, capacity=32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(m))
               for m in rng.integers(2, 7, size=4)]
    uids = [(ours.submit(p, max_new_tokens=4), theirs.submit(p, max_new_tokens=4))
            for p in prompts]
    got, want = ours.run(), theirs.run()
    assert len(got) == len(want) == 4
    for u_ours, u_theirs in uids:
        assert got[u_ours] == [int(t) for t in want[u_theirs]]
    assert len({t for toks in got.values() for t in toks}) >= 4


def test_forward_hidden_sums_moe_aux_over_layers():
    """The trunk's aux losses are the sum of each layer's, as the
    reference's forward_hidden; forward returns the logits alone."""
    j_cfg, cfg, j_params, params = _setup("granite-moe-1b-a400m")
    toks = _inputs(cfg, 2, 32)
    _, j_aux = j_tf.forward_hidden(j_cfg, j_params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        hidden, aux = tf.forward_hidden(cfg, params, _port(toks), impl="torch")
    assert hidden.shape == (2, 32, cfg.d_model)
    assert set(aux) == set(j_aux)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(j_aux[k]), rtol=1e-5, atol=1e-6)
    assert float(aux["load_balance"]) > 0


def test_encoder_only_model_is_refused_by_serve():
    _, cfg, _, params = _setup("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        repro_torch.compile(cfg, params, CPU).serve(batch_size=1, capacity=16)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_matches_reference_shapes(arch):
    """init_params and params_from_numpy give the same tree of shapes and
    dtypes, the mLSTM shape marker included; in bf16 the fp32 leaves
    (router, gates, Lambda, norms) stay fp32."""
    import dataclasses

    for dtype in ("float32", "bfloat16"):
        j_cfg = dataclasses.replace(j_configs.smoke_config(arch), dtype=dtype)
        cfg = dataclasses.replace(configs.smoke_config(arch), dtype=dtype)
        tree = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype),
            jax.eval_shape(lambda k: j_tf.init_params(j_cfg, k),
                           jax.random.PRNGKey(0)))
        ours = tf.init_params(cfg, torch.Generator().manual_seed(0))
        theirs = tf.params_from_numpy(cfg, tree, "cpu")

        def spec(t):
            return tuple(t.shape), t.dtype

        assert tf.tree_map(spec, ours) == tf.tree_map(spec, theirs)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-9b",
                                  "xlstm-125m", "internvl2-2b"])
def test_serve_launcher_runs_every_decoding_family(arch, capsys):
    from repro_torch.launch import serve as serve_launcher

    serve_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "3", "--new-tokens", "3", "--batch", "2",
                         "--capacity", "32"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] 3 requests, 9 tokens")


def test_serve_launcher_refuses_an_encoder_only_model():
    from repro_torch.launch import serve as serve_launcher

    with pytest.raises(SystemExit, match="encoder-only"):
        serve_launcher.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                             "cpu"])

"""The port's continuous-batching engine against the JAX package's, on the
CPU, and its refusals.

Same reference parameters (the smoke llama3.2-1b in fp32, carried across
by ``params_from_numpy``), same prompts, greedy: the port's engine must
answer every request with the reference ``ServingEngine``'s tokens, with
more requests than slots, so slots are freed and re-admitted.  The
weights are the reference's init scaled by 8 (in both packages), so that
greedy decoding does not settle on one repeated token and the comparison
sees many distinct argmaxes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro.serving import ServingEngine as JServingEngine
import repro_torch
from repro_torch import configs
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import transformer as tf
from repro_torch.serving import InvalidRequest, QueueNotDrained, ServingEngine

CPU = repro_torch.ExecutionOptions(impl="torch", device="cpu")


def _tree(cfg, scale=8.0):
    params = j_tf.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0), params)


def _prompts(n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(m)) for m in rng.integers(2, 9, size=n)]


def test_engine_tokens_match_reference_engine():
    j_cfg, cfg = (j_configs.smoke_config("llama3.2-1b"),
                  configs.smoke_config("llama3.2-1b"))
    tree = _tree(j_cfg)
    ours = repro_torch.compile(cfg, tf.params_from_numpy(cfg, tree, "cpu"),
                               CPU).serve(batch_size=2, capacity=32)
    theirs = JServingEngine(j_cfg, jax.tree_util.tree_map(jax.numpy.asarray, tree),
                            batch_size=2, capacity=32)
    uids = [(ours.submit(p, max_new_tokens=6), theirs.submit(p, max_new_tokens=6))
            for p in _prompts()]
    got, want = ours.run(), theirs.run()
    assert len(got) == len(want) == 5
    for u_ours, u_theirs in uids:
        assert got[u_ours] == [int(t) for t in want[u_theirs]]
    tokens = {t for toks in got.values() for t in toks}
    assert len(tokens) >= 8, tokens


def test_engine_matches_manual_decode_loop():
    """One request alone: the engine's tokens are a greedy decode_step loop
    over the prompt (slot-local admission) and then its own samples."""
    cfg = configs.smoke_config("gemma2-27b")
    params = tf.params_from_numpy(cfg, _tree(j_configs.smoke_config("gemma2-27b")),
                                  "cpu")
    prompt = _prompts(1)[0]
    engine = ServingEngine(cfg, params, batch_size=1, capacity=32, impl="torch")
    engine.submit(prompt, max_new_tokens=5)
    got = engine.run()[1]

    cache = tf.init_cache(cfg, 1, 32)
    toks, want = list(prompt), []
    with torch.no_grad():
        for pos in range(len(prompt) + 4):
            logits, cache = tf.decode_step(cfg, params, cache,
                                           torch.tensor([[toks[pos]]]), pos)
            if pos >= len(prompt) - 1:
                want.append(int(logits[0].argmax()))
                toks.append(want[-1])
    assert got == want


def test_invalid_prompts_are_refused():
    cfg = configs.smoke_config("llama3.2-1b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    engine = repro_torch.compile(cfg, params, CPU).serve(batch_size=2, capacity=16)
    for bad in ([], [1.5, 2.0], [0, cfg.vocab_size], [-1], ["a"]):
        with pytest.raises(InvalidRequest):
            engine.submit(np.asarray(bad))
    assert not engine.queue
    engine.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(QueueNotDrained) as err:
        engine.run(max_steps=2)
    assert err.value.remaining == [1]


def test_engine_refuses_what_it_does_not_serve():
    cfg = configs.smoke_config("llama3.2-1b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    encoder = dataclasses.replace(cfg, encoder_only=True)
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(encoder, params, batch_size=1, capacity=16, impl="torch")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ServingEngine(cfg, params, batch_size=1, capacity=16)  # CPU params
    # Every reference arch has a config now, and a recurrent pattern,
    # once refused, is served.
    for arch in configs.ARCHS:
        assert configs.get_config(arch).name == arch
    recurrent = dataclasses.replace(cfg, layer_pattern=("rglru", "attn"))
    engine = ServingEngine(recurrent, tf.init_params(
        recurrent, torch.Generator().manual_seed(0)), batch_size=1,
        capacity=16, impl="torch")
    uid = engine.submit([1, 2, 3], max_new_tokens=3)
    assert len(engine.run()[uid]) == 3


def test_serve_launcher_on_cpu(capsys):
    serve_launcher.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                         "--requests", "3", "--new-tokens", "4", "--batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] 3 requests, 12 tokens") and "tok/s" in out[0]
    assert [line.split(":")[0].strip() for line in out[1:]] == [
        "req 1", "req 2", "req 3"]

"""What the port's CUDA graphs rest on, on the CPU.

- The decode step updates its cache in place (one ring slot a live row)
  and still computes the reference's step: a 2-layer gemma2 smoke config
  (one local layer of window 4, one global), capacity 8 so that both rings
  wrap, rows at their own positions under mixed ``live`` masks, against
  ``repro.models.transformer.decode_step``.  Logits and K/V within
  rtol = 1e-4, atol = 1e-4 * max(1, max|ref|) (tests/test_torch_lm_cache.py:
  the two frameworks sum the projections in another order), ring
  positions exactly; and exactly, against the port's own cache before the
  step, that only the live rows' slots changed, in the same tensors.
- The serving engine on that static cache answers as the reference's
  ``ServingEngine``: 5 requests at batch 2 (slots freed and reused), rings
  that wrap.
- ``graphs.capture_counted`` / ``add_launches``: k replays of a captured
  body count what k eager runs count, and neither the warm-up nor the
  capture counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs, graphs
from repro_torch.models import transformer as tf
from repro_torch.serving import ServingEngine


def _tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1.0))


def _configs(window=4):
    """(reference cfg, port cfg): gemma2's smoke config cut to one local
    and one global layer, the local window ``window``."""
    return tuple(dataclasses.replace(c.smoke_config("gemma2-27b"), num_layers=2,
                                     local_window=window)
                 for c in (j_configs, configs))


def _tree(cfg, scale=1.0):
    params = j_tf.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0), params)


def test_in_place_decode_step_matches_reference():
    j_cfg, cfg = _configs()
    tree = _tree(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    params = tf.params_from_numpy(cfg, tree, "cpu")
    capacity, steps = 8, 14
    j_cache = j_tf.init_cache(j_cfg, 2, capacity)
    cache = tf.init_cache(cfg, 2, capacity)
    tensors = [dict(layer) for layer in cache]
    j_decode = jax.jit(lambda p, c, t, pos, live: j_tf.decode_step(
        j_cfg, p, c, t, pos, live=live))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, steps))
    pos = np.zeros(2, np.int64)
    for step in range(steps):
        live = np.array([True, step % 3 != 0])
        t = toks[:, step:step + 1]
        before = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        ref, j_cache = j_decode(j_params, j_cache, jnp.asarray(t, jnp.int32),
                                jnp.asarray(pos, jnp.int32), jnp.asarray(live))
        got, out = tf.decode_step(cfg, params, cache, torch.tensor(t),
                                  torch.tensor(pos), live=torch.tensor(live))
        assert out is cache
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
        for layer, old, own in zip(cache, before, tensors):
            cap = layer["k"].shape[1]
            for name, t_new in layer.items():
                assert t_new is own[name]
                changed = (t_new != old[name]).reshape(2, cap, -1).any(-1)
                allowed = torch.zeros(2, cap, dtype=torch.bool)
                for row in np.flatnonzero(live):
                    allowed[row, pos[row] % cap] = True
                assert not (changed & ~allowed).any(), (step, name)
            assert all(int(layer["slot_pos"][r, pos[r] % cap]) == pos[r]
                       for r in np.flatnonzero(live))
        pos = pos + live
    assert pos.min() > capacity          # both rings wrapped
    for layer, ref_layer in zip(cache, tf.layers_from_tree(
            j_cfg, jax.tree_util.tree_map(np.asarray, j_cache))):
        np.testing.assert_array_equal(layer["slot_pos"].numpy(),
                                      ref_layer["slot_pos"])
        for k in ("k", "v"):
            np.testing.assert_allclose(layer[k].numpy(), ref_layer[k],
                                       **_tol(ref_layer[k]))


def test_engine_on_static_cache_matches_reference_engine():
    j_cfg, cfg = _configs()
    tree = _tree(j_cfg, scale=8.0)
    ours = ServingEngine(cfg, tf.params_from_numpy(cfg, tree, "cpu"),
                         batch_size=2, capacity=8, impl="torch")
    theirs = JServingEngine(j_cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            batch_size=2, capacity=8)
    static = [dict(layer) for layer in ours.cache]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, size=int(m)) for m in rng.integers(2, 7, 5)]
    uids = [(ours.submit(p, max_new_tokens=6), theirs.submit(p, max_new_tokens=6))
            for p in prompts]
    got, want = ours.run(), theirs.run()
    assert len(got) == len(want) == 5
    for u_ours, u_theirs in uids:
        assert got[u_ours] == [int(t) for t in want[u_theirs]]
    assert max(len(p) for p in prompts) + 6 > 8      # a ring wrapped
    assert all(layer[k] is own[k] for layer, own in zip(ours.cache, static)
               for k in own)


def _fake_forward(wrappers, plan):
    """A stand-in for a forward: counts each kernel's launches as its
    wrapper does when it launches on the card."""
    def run():
        for name, n in plan.items():
            wrappers[name].launches += n
    return run


@pytest.mark.parametrize("warmups", [1, 3])
def test_capture_tally_counts_replays_as_eager_runs(warmups):
    wrappers = graphs.launch_counters()
    assert len(wrappers) == 9 and "flash_attention" in wrappers
    plan = {"gemm": 2, "im2col_conv": 1, "winograd_fused": 3}
    forward = _fake_forward(wrappers, plan)
    saved = graphs.read_launches(wrappers)
    try:
        for fn in wrappers.values():
            fn.launches = 0
        for _ in range(4):
            forward()
        eager = graphs.read_launches(wrappers)

        for fn in wrappers.values():
            fn.launches = 5
        delta = graphs.capture_counted(
            wrappers, lambda: [forward() for _ in range(warmups)], forward)
        assert delta == plan
        assert set(graphs.read_launches(wrappers).values()) == {5}
        for fn in wrappers.values():
            fn.launches = 0
        graphs.add_launches(wrappers, delta)
        graphs.add_launches(wrappers, delta, times=3)
        assert graphs.read_launches(wrappers) == eager

        for fn in wrappers.values():
            fn.launches = 7

        def refused():
            forward()
            raise RuntimeError("capture refused")

        with pytest.raises(RuntimeError, match="refused"):
            graphs.capture_counted(wrappers, forward, refused)
        assert set(graphs.read_launches(wrappers).values()) == {7}
    finally:
        for name, fn in wrappers.items():
            fn.launches = saved[name]


def test_captured_call_refuses_cpu_inputs():
    with pytest.raises(ValueError, match="one card"):
        graphs.CapturedCall(lambda x: x + 1, (torch.zeros(3),), "a CPU body")

"""The port's optimizer (``repro_torch.optim``) against the JAX package's
(``repro.optim``), on the CPU, on the same numpy parameters and gradients.

- schedules and the int8 block quantizer: equal (the quantizer bit for
  bit: the same fp32 divisions, round half to even, the same clip);
- ``adamw.update`` in fp32, bf16 and int8 moments, two steps: parameters
  and fp32 moments within rtol = atol = 1e-6 (the same fp32 operations;
  ``b ** step`` and the norm's sum may round apart in the last place),
  bf16 moments within one bf16 unit, int8 moments' codes and scales bit
  for bit;
- weight decay: the reference decays a stacked per-layer norm (its
  ``p.ndim >= 2`` sees the period axis), the port decays exactly its
  leaves of two or more dims (a reference fault not copied).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro.optim import quantized_state as j_qs
from repro.optim import schedules as j_sched
from repro_torch import configs, optim
from repro_torch import tree as tree_lib
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, quantized_state


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-4),
    lambda m: m.warmup_cosine(1e-3, 5, 40),
    lambda m: m.warmup_cosine(2e-3, 0, 10, final_frac=0.0),
])
def test_schedules_match_reference(make):
    ours, ref = make(optim), make(j_sched)
    for step in (0, 1, 3, 5, 6, 20, 39, 40, 55):
        got = ours(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("shape", [(7,), (256,), (3, 100), (4, 256), (2, 3, 129)])
def test_quantize_is_bit_equal_to_reference(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * rng.choice([1e-6, 1.0, 30.0])).astype(np.float32)
    x.reshape(-1)[:3] = 0.0
    ours = quantized_state.quantize(torch.tensor(x))
    ref = j_qs.quantize(jnp.asarray(x))
    assert ours.shape == ref.shape and ours.q.dtype == torch.int8
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(quantized_state.dequantize(ours).numpy(),
                                  np.asarray(j_qs.dequantize(ref)))


def test_round_half_to_even():
    """A value exactly half way between two codes takes the even one, as
    jnp.round does: x = 2.5 * scale rounds to 2."""
    x = torch.zeros(256)
    x[0], x[1] = 127.0, 2.5
    q = quantized_state.quantize(x)
    assert q.q[0, 1] == 2 and q.q[0, 0] == 127


def _flat_params(rng):
    """A flat tree with 2-D weights and 1-D norms, as numpy fp32."""
    return {"w": rng.normal(size=(16, 24)).astype(np.float32) * 0.1,
            "emb": rng.normal(size=(300, 8)).astype(np.float32) * 0.1,
            "norm": rng.normal(size=(24,)).astype(np.float32) * 0.1,
            "bias": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_update_matches_reference(moment_dtype):
    rng = np.random.default_rng(1)
    params = _flat_params(rng)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    kw = dict(weight_decay=0.1, grad_clip_norm=100.0, moment_dtype=moment_dtype)
    ours_cfg = optim.AdamWConfig(lr=optim.warmup_cosine(1e-2, 1, 10), **kw)
    ref_cfg = j_adamw.AdamWConfig(lr=j_sched.warmup_cosine(1e-2, 1, 10), **kw)
    p = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st, jst = optim.init(ours_cfg, p), j_adamw.init(ref_cfg, jp)
    for g in grads:
        p, st, m = optim.update(ours_cfg, {k: torch.tensor(v) for k, v in g.items()},
                                st, p)
        jp, jst, jm = j_adamw.update(ref_cfg, {k: jnp.asarray(v) for k, v in g.items()},
                                     jst, jp)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(st.step) == int(jst.step) == 2 and st.step.dtype == torch.int32
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-6)
        for ours, ref in ((st.m[k], jst.m[k]), (st.v[k], jst.v[k])):
            if moment_dtype == "int8":
                np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
                np.testing.assert_array_equal(ours.scale.numpy(),
                                              np.asarray(ref.scale))
            else:
                want = np.asarray(ref.astype(jnp.float32))
                assert ours.dtype == getattr(torch, moment_dtype)
                # one unit of the moment type's last place
                ulp = 2.0 ** (-23 if moment_dtype == "float32" else -7)
                np.testing.assert_allclose(ours.float().numpy(), want, rtol=ulp,
                                           atol=1e-30)


def test_update_clips_by_global_norm():
    """With the clip active the port and the reference agree; the clip
    divides every gradient by norm / grad_clip_norm."""
    rng = np.random.default_rng(2)
    params = _flat_params(rng)
    g = {k: 10 * rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    cfg = optim.AdamWConfig(lr=optim.constant(1e-2), grad_clip_norm=1.0)
    jcfg = j_adamw.AdamWConfig(lr=j_sched.constant(1e-2), grad_clip_norm=1.0)
    p = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    p2, st, m = optim.update(cfg, {k: torch.tensor(v) for k, v in g.items()},
                             optim.init(cfg, p), p)
    jp2, jst, _ = j_adamw.update(jcfg, {k: jnp.asarray(v) for k, v in g.items()},
                                 j_adamw.init(jcfg, jp), jp)
    assert float(m["grad_norm"]) > 10
    for k in params:
        np.testing.assert_allclose(st.m[k].numpy(), np.asarray(jst.m[k]),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(p2[k].numpy(), np.asarray(jp2[k]), rtol=1e-6,
                                   atol=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = _flat_params(rng)
    np.testing.assert_allclose(
        float(optim.global_norm({k: torch.tensor(v) for k, v in tree.items()})),
        float(j_adamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()})),
        rtol=1e-6)


def _llama_smoke_with_norms(seed=0):
    """The reference's smoke Llama params (stacked periods) with every norm
    moved off zero, and the same params in the port's tree."""
    j_cfg, cfg = j_configs.smoke_config("llama3.2-1b"), configs.smoke_config("llama3.2-1b")
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, j_tf.init_params(j_cfg, jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=a.shape).astype(a.dtype) * 0.5
                         if "norm" in jax.tree_util.keystr(path) else a), tree)
    return j_cfg, cfg, tree


def test_reference_decays_stacked_norms_the_port_does_not():
    """One step with zero gradients: AdamW's update is 0, so each leaf
    moves by -lr * decay * p alone.  The reference's stacked per-layer
    norm (``period/0:attn/norm1``, (3, 64): 2-D) is decayed; the port's
    per-layer norms (1-D) are not, its weights are, and ``final_norm`` is
    in neither."""
    j_cfg, cfg, tree = _llama_smoke_with_norms()
    lr, wd = 0.01, 0.1
    jcfg = j_adamw.AdamWConfig(lr=j_sched.constant(lr), weight_decay=wd)
    ocfg = optim.AdamWConfig(lr=optim.constant(lr), weight_decay=wd)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jnew, _, _ = j_adamw.update(jcfg, jax.tree_util.tree_map(jnp.zeros_like, jp),
                                j_adamw.init(jcfg, jp), jp)
    p = tf.params_from_numpy(cfg, tree, "cpu")
    new, _, _ = optim.update(ocfg, tree_lib.tree_map(torch.zeros_like, p),
                             optim.init(ocfg, p), p)

    stacked = tree["period"]["0:attn"]["norm1"]
    assert stacked.ndim == 2 and np.abs(stacked).max() > 0
    ref_norm = np.asarray(jnew["period"]["0:attn"]["norm1"])
    np.testing.assert_allclose(ref_norm, stacked * (1 - lr * wd), rtol=1e-6)
    port_norm = np.stack([layer["norm1"].numpy() for layer in new["layers"]])
    np.testing.assert_array_equal(port_norm, stacked)
    diff = float(np.abs(ref_norm - port_norm).max())
    print(f"stacked norm1 after one step: reference - port max |diff| = {diff:.3g}")
    assert diff > 0
    np.testing.assert_array_equal(np.asarray(jnew["final_norm"]), tree["final_norm"])
    np.testing.assert_array_equal(new["final_norm"].numpy(), tree["final_norm"])


def test_port_decays_exactly_its_leaves_of_two_or_more_dims():
    _, cfg, tree = _llama_smoke_with_norms(seed=1)
    lr, wd = 0.01, 0.1
    ocfg = optim.AdamWConfig(lr=optim.constant(lr), weight_decay=wd)
    p = tf.params_from_numpy(cfg, tree, "cpu")
    new, _, _ = optim.update(ocfg, tree_lib.tree_map(torch.zeros_like, p),
                             optim.init(ocfg, p), p)
    kinds = set()
    for (path, old), got in zip(tree_lib.leaves_with_paths(p), tree_lib.leaves(new)):
        want = old * (1 - lr * wd) if old.ndim >= 2 else old
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0, msg=path)
        kinds.add(old.ndim >= 2)
    assert kinds == {True, False}


def test_state_tree_and_moment_types():
    cfg = configs.smoke_config("qwen1.5-0.5b")
    p = tf.init_params(cfg, torch.Generator().manual_seed(0))
    for md, kind in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        st = optim.init(optim.AdamWConfig(lr=optim.constant(1e-3), moment_dtype=md), p)
        assert all(t.dtype == kind for t in tree_lib.leaves(st.m))
    st = optim.init(optim.AdamWConfig(lr=optim.constant(1e-3), moment_dtype="int8"), p)
    wq = st.m["layers"][0]["mixer"]["wq"]
    assert isinstance(wq, optim.QTensor) and wq.q.dtype == torch.int8
    keys = [k for k, _ in tree_lib.leaves_with_paths(st)]
    assert keys[0] == ".step" and ".m/layers/0/mixer/wq/0" in keys
    with pytest.raises(ValueError, match="moment_dtype"):
        optim.init(optim.AdamWConfig(lr=optim.constant(1e-3), moment_dtype="fp8"), p)
    assert adamw.AdamWState.__name__ == "AdamWState"

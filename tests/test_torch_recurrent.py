"""The port's recurrent blocks against the JAX package's, on the CPU.

RG-LRU (prefill through the doubling scan, then single decode steps from
its state), mLSTM in each of its three forms against the reference's same
form (the forms round differently, so each is held against its own), and
sLSTM, on the same numpy weights and inputs; the doubling scan against a
sequential loop; ``reset_cache_rows`` and the live mask on recurrent
state.  fp32 within rtol = 1e-4, atol = 1e-4 * max(1, max|ref|), as
``_tol`` in tests/test_api.py.  Weights are the reference's init scaled
up, so that outputs are of order one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as j_rglru
from repro.models import xlstm as j_xlstm
from repro_torch import configs
from repro_torch.models import rglru, xlstm
from repro_torch.models import transformer as tf

D, H = 32, 4


def _tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1.0))


def _scaled(tree, scale):
    return {k: np.asarray(v) * (scale if np.ndim(v) >= 2 else 1.0)
            for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _x(b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(np.float32)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# RG-LRU


def _rglru_params():
    return _scaled(j_rglru.init_rglru_block(jax.random.PRNGKey(0), D, 48, 4,
                                            jnp.float32), 10.0)


@pytest.mark.parametrize("s", [1, 7, 33])
def test_rglru_prefill_matches_reference(s):
    p, x = _rglru_params(), _x(2, s)
    ref, ref_cache = j_rglru.apply_rglru_block(_j(p), jnp.asarray(x),
                                               fill_state=True)
    got, cache = rglru.apply_rglru_block(_t(p), torch.tensor(x),
                                         fill_state=True)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
    for k, v in _np(ref_cache).items():
        np.testing.assert_allclose(cache[k].numpy(), v, **_tol(v))
    assert float(np.abs(ref).max()) > 0.1


def test_rglru_prefill_then_decode_matches_reference():
    """Prefill 9 tokens, then 3 single steps from the carried (h, conv)
    state; and prefill from a carried state (h0 folded in)."""
    p, x = _rglru_params(), _x(2, 12)
    j_out, j_c = j_rglru.apply_rglru_block(_j(p), jnp.asarray(x[:, :9]),
                                           fill_state=True)
    out, c = rglru.apply_rglru_block(_t(p), torch.tensor(x[:, :9]),
                                     fill_state=True)
    for t in range(9, 12):
        j_out, j_c = j_rglru.apply_rglru_block(_j(p), jnp.asarray(x[:, t:t + 1]),
                                               cache=j_c)
        out, c = rglru.apply_rglru_block(_t(p), torch.tensor(x[:, t:t + 1]),
                                         cache=c)
        ref = np.asarray(j_out)
        np.testing.assert_allclose(out.numpy(), ref, **_tol(ref))
    j_out, _ = j_rglru.apply_rglru_block(_j(p), jnp.asarray(x[:, :5]), cache=j_c)
    out, _ = rglru.apply_rglru_block(_t(p), torch.tensor(x[:, :5]), cache=c)
    ref = np.asarray(j_out)
    np.testing.assert_allclose(out.numpy(), ref, **_tol(ref))


@pytest.mark.parametrize("s", [1, 2, 5, 16, 37])
def test_doubling_scan_matches_sequential_loop(s):
    rng = np.random.default_rng(s)
    a = torch.tensor(rng.uniform(0.5, 1.0, (2, s, 6)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(2, s, 6)).astype(np.float32))
    h0 = torch.tensor(rng.normal(size=(2, 6)).astype(np.float32))
    for init in (None, h0):
        h = torch.zeros(2, 6) if init is None else init
        want = []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got, last = rglru.linear_scan(a, b, init)
        np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(last.numpy(), want[-1].numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# mLSTM


def _mlstm_inputs(b=2, s=16, hd=8, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, H, hd)).astype(np.float32) for _ in range(3))
    log_f = np.log(1 / (1 + np.exp(-rng.normal(2.0, 1.0, (b, s, H))))).astype(np.float32)
    log_i = rng.normal(size=(b, s, H)).astype(np.float32)
    return q, k, v, log_f, log_i


def _state(b, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, H, hd, hd)).astype(np.float32),
            rng.normal(size=(b, H, hd)).astype(np.float32),
            rng.normal(size=(b, H)).astype(np.float32))


def test_mlstm_parallel_matches_reference():
    args = _mlstm_inputs()
    ref = np.asarray(j_xlstm._mlstm_parallel(*map(jnp.asarray, args)))
    got = xlstm.mlstm_parallel(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, ref, **_tol(ref))


@pytest.mark.parametrize("chunk", [4, 16])
def test_mlstm_chunked_matches_reference(chunk):
    args = _mlstm_inputs()
    st = _state(2, 8, 4)
    ref, ref_st = j_xlstm._mlstm_chunked(*map(jnp.asarray, args),
                                         tuple(map(jnp.asarray, st)), chunk)
    got, got_st = xlstm.mlstm_chunked(*map(torch.tensor, args),
                                      tuple(map(torch.tensor, st)), chunk)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
    for a, r in zip(got_st, ref_st):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, **_tol(r))


def test_mlstm_step_matches_reference():
    q, k, v, log_f, log_i = _mlstm_inputs(s=1)
    st = _state(2, 8, 5)
    args = (q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0])
    ref_st, ref = j_xlstm._mlstm_step(tuple(map(jnp.asarray, st)),
                                      *map(jnp.asarray, args))
    got_st, got = xlstm.mlstm_step(tuple(map(torch.tensor, st)),
                                   *map(torch.tensor, args))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
    for a, r in zip(got_st, ref_st):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, **_tol(r))


@pytest.mark.parametrize("s,fill,form", [(16, False, "parallel"),
                                         (16, True, "chunked"),
                                         (24, True, "chunked")])
def test_mlstm_block_takes_the_reference_form(s, fill, form):
    """The block runs the reference's form and matches its output and
    state; the rule itself at the reference's thresholds."""
    p = _scaled(j_xlstm.init_mlstm_block(jax.random.PRNGKey(1), D, H,
                                         jnp.float32), 4.0)
    x = _x(2, s)
    assert xlstm.mlstm_form(s, False, fill) == form
    ref, ref_c = j_xlstm.apply_mlstm_block(_j(p), jnp.asarray(x), H,
                                           fill_state=fill, chunk=8)
    got, c = xlstm.apply_mlstm_block(_t(p), torch.tensor(x), H,
                                     fill_state=fill, chunk=8)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
    assert (c is None) == (ref_c is None)
    if fill:
        for k, v in _np(ref_c).items():
            np.testing.assert_allclose(c[k].numpy(), v, **_tol(v))
        ref, _ = j_xlstm.apply_mlstm_block(_j(p), jnp.asarray(x[:, :1]), H,
                                           cache=ref_c)
        got, _ = xlstm.apply_mlstm_block(_t(p), torch.tensor(x[:, :1]), H,
                                         cache=c)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
    assert xlstm.mlstm_form(1, True, False) == "step"
    assert xlstm.mlstm_form(8192, False, False) == "chunked"
    assert xlstm.mlstm_form(4096, False, False) == "parallel"
    assert xlstm.mlstm_form(8200, False, False) == "parallel"


# ---------------------------------------------------------------------------
# sLSTM


def test_slstm_matches_reference():
    """A prefill that returns its state, then 2 steps from it."""
    p = _scaled(j_xlstm.init_slstm_block(jax.random.PRNGKey(2), D, H,
                                         jnp.float32), 10.0)
    x = _x(2, 12)
    ref, ref_c = j_xlstm.apply_slstm_block(_j(p), jnp.asarray(x[:, :10]), H,
                                           fill_state=True)
    got, c = xlstm.apply_slstm_block(_t(p), torch.tensor(x[:, :10]), H,
                                     fill_state=True)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
    assert float(np.abs(ref).max()) > 0.5
    for t in (10, 11):
        ref, ref_c = j_xlstm.apply_slstm_block(_j(p), jnp.asarray(x[:, t:t + 1]),
                                               H, cache=ref_c)
        got, c = xlstm.apply_slstm_block(_t(p), torch.tensor(x[:, t:t + 1]),
                                         H, cache=c)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, **_tol(ref))
    for k, v in _np(ref_c).items():
        np.testing.assert_allclose(c[k].numpy(), v, **_tol(v))


def test_recurrent_caches_start_as_the_reference():
    """sLSTM's m starts at -10, mLSTM's at 0, the rest at zero; no two
    leaves share memory (they are updated in place)."""
    sl = xlstm.init_slstm_cache(2, H, 8)
    ml = xlstm.init_mlstm_cache(2, H, 8)
    for ours, ref in ((sl, j_xlstm.init_slstm_cache(2, H, 8)),
                      (ml, j_xlstm.init_mlstm_cache(2, H, 8))):
        for k, v in _np(ref).items():
            np.testing.assert_array_equal(ours[k].numpy(), v)
    ptrs = [t.data_ptr() for c in (sl, ml) for t in c.values()]
    assert len(set(ptrs)) == len(ptrs)


# ---------------------------------------------------------------------------
# The live mask and reset_cache_rows on recurrent state


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_live_mask_and_reset_on_recurrent_state(arch):
    """A decode step with row 1 not live leaves row 1's recurrent state
    exactly as it was, at the same addresses; reset_cache_rows puts a
    row back to the initial state and leaves the others."""
    cfg = configs.smoke_config(arch)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tf.init_cache(cfg, 2, 16)
    toks = torch.tensor([[3], [5]])
    with torch.no_grad():
        for pos in range(3):
            tf.decode_step(cfg, params, cache, toks, pos)
        recurrent = [i for i, bt in enumerate(cfg.pattern_layers)
                     if bt in ("rglru", "mlstm", "slstm")]
        before = [{k: t.clone() for k, t in cache[i].items()} for i in recurrent]
        ptrs = [{k: t.data_ptr() for k, t in cache[i].items()} for i in recurrent]
        tf.decode_step(cfg, params, cache, toks, 3,
                       live=torch.tensor([True, False]))
    for i, old, ptr in zip(recurrent, before, ptrs):
        for k, t in cache[i].items():
            assert t.data_ptr() == ptr[k]
            assert torch.equal(t[1], old[k][1]), (i, k)
        assert any(not torch.equal(t[0], old[k][0])
                   for k, t in cache[i].items()), i
    fresh = tf.init_cache(cfg, 1, 16)
    tf.reset_cache_rows(cache, fresh, 0)
    for i, old in zip(recurrent, before):
        for k, t in cache[i].items():
            assert torch.equal(t[0], fresh[i][k][0]), (i, k)
            assert torch.equal(t[1], old[k][1]), (i, k)

"""The port's flash-attention plain version against the JAX package's
kernel (Pallas, interpret mode) and its oracle ``attention_ref``.

The same numpy inputs go to both packages.  The port's layout is the
kernel's: q (B, S, H, hd), k/v (B, Sk, KV, hd), query head h on KV head
h // (H // KV); the reference's kernel wrapper takes K/V heads already
broadcast to H and its oracle (BH, S, hd).  fp32 at the reference suite's
tolerance (rtol = atol = 2e-4); bf16 within 3e-2 * max(1, max|ref|): each
side rounds q, k, v, p and the output to 8 significant bits, once in
another order, so they may differ by two units of the last place; and
each query row's difference within 1e-2 of that row's norm, which holds
the late causal rows, 10 times smaller than the first, at their own scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

BF16_TOL = 3e-2
BF16_ROW_RTOL = 1e-2


def _row_err(got, ref):
    """The largest per-row relative error over the last dimension."""
    return float((np.linalg.norm(got - ref, axis=-1)
                  / np.linalg.norm(ref, axis=-1)).max())


def _inputs(b, s, sk, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, hd)).astype(np.float32)
    return q, k, v


def _ours(q, k, v, dtype=torch.float32, **kw):
    t = [torch.tensor(a).to(dtype) for a in (q, k, v)]
    return flash_attention(*t, impl="torch", **kw).float().numpy()


def _ref_oracle(q, k, v, causal, window, cap, dtype=jnp.float32):
    """The reference's attention_ref on broadcast K/V heads, back in the
    port's layout."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)

    def flat(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, hd), dtype)

    out = j_attention_ref(flat(q), flat(k), flat(v), causal=causal,
                          window=window, logit_cap=cap)
    return np.asarray(out.astype(jnp.float32)).reshape(b, h, s, hd).transpose(
        0, 2, 1, 3)


# The five cases of tests/test_flash_attention.py.
CASES = [
    dict(b=2, s=64, h=3, hd=16, causal=True, window=0, cap=0.0),
    dict(b=1, s=128, h=2, hd=32, causal=True, window=32, cap=0.0, bq=32, bk=64),
    dict(b=2, s=48, h=2, hd=16, causal=True, window=0, cap=50.0),
    dict(b=1, s=64, h=1, hd=16, causal=False, window=0, cap=0.0),
    dict(b=1, s=50, h=2, hd=16, causal=True, window=0, cap=0.0),  # padded
]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_reference_kernel(case):
    case = dict(case)
    b, s, h, hd = (case.pop(n) for n in ("b", "s", "h", "hd"))
    bq, bk = case.pop("bq", 16), case.pop("bk", 16)
    causal, window, cap = case["causal"], case["window"], case["cap"]
    q, k, v = _inputs(b, s, s, h, h, hd, 0)
    got = _ours(q, k, v, causal=causal, window=window, logit_cap=cap)
    ref = np.asarray(j_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, logit_cap=cap, bq=bq, bk=bk, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, _ref_oracle(q, k, v, causal, window, cap),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,kv,causal,window,cap", [
    (8, 2, True, 0, 0.0),      # Llama-style grouping, G = 4
    (4, 2, True, 12, 50.0),    # gemma2-style: G = 2, window, softcap
    (6, 1, False, 0, 0.0),     # MQA, bidirectional
])
def test_gqa_matches_broadcast_heads(h, kv, causal, window, cap):
    """Query head j reads KV head j // G, as broadcasting each KV head to its
    G query heads (the reference's q.reshape(b, s, kv, g, hd) grouping)."""
    q, k, v = _inputs(2, 40, 40, h, kv, 32, 1)
    got = _ours(q, k, v, causal=causal, window=window, logit_cap=cap)
    np.testing.assert_allclose(got, _ref_oracle(q, k, v, causal, window, cap),
                               rtol=2e-4, atol=2e-4)
    g = h // kv
    wide = _ours(q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2),
                 causal=causal, window=window, logit_cap=cap)
    np.testing.assert_allclose(got, wide, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,sk", [(50, 50), (50, 37), (20, 45)])
def test_non_causal_ragged_matches_oracle(s, sk):
    """Non-causal attention with a ragged Sk, against attention_ref only:
    the reference's kernel wrapper pads Sk to its block and, for
    non-causal attention, widens the window instead of masking the padded
    keys, so they get softmax weight (ROADMAP.md, queue 2).  The port masks
    k >= Sk."""
    q, k, v = _inputs(1, s, sk, 4, 2, 16, 2)
    got = _ours(q, k, v, causal=False)
    np.testing.assert_allclose(got, _ref_oracle(q, k, v, False, 0, 0.0),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 16, 50.0)])
def test_bf16_matches_reference_kernel(causal, window, cap):
    q, k, v = _inputs(1, 64, 64, 2, 2, 16, 3)
    got = _ours(q, k, v, torch.bfloat16, causal=causal, window=window,
                logit_cap=cap)
    ref = j_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            causal=causal, window=window, logit_cap=cap,
                            bq=16, bk=16, interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    tol = BF16_TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    assert _row_err(got, ref) <= BF16_ROW_RTOL


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_softcap_saturated_matches_reference_kernel(dtype):
    """q scaled by 8: scaled scores of std 8 reach the cap's bend (cap 50),
    where leaving the cap out moves the output far past the tolerance."""
    q, k, v = _inputs(1, 64, 64, 2, 2, 32, 4)
    q = q * 8
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = _ours(q, k, v, tdtype, causal=True, window=0, logit_cap=50.0)
    ref = np.asarray(j_flash_attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), causal=True, window=0,
        logit_cap=50.0, bq=16, bk=16, interpret=True).astype(jnp.float32))
    nocap = _ours(q, k, v, tdtype, causal=True, window=0, logit_cap=0.0)
    row_tol = 2e-4 if dtype == jnp.float32 else BF16_ROW_RTOL
    assert _row_err(got, ref) <= row_tol
    assert _row_err(nocap, ref) > 10 * row_tol
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            got, _ref_oracle(q, k, v, True, 0, 50.0), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hd,h,kv,causal,window", [
    (80, 4, 4, True, 0),        # hubert-xlarge's head dim (its model is
    (80, 4, 2, True, 24),       # non-causal: see the ragged case above)
    (256, 4, 1, True, 16),      # recurrentgemma-9b: MQA, hd 256, window
    (256, 2, 1, True, 0),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_head_dims_80_and_256_match_reference_kernel(hd, h, kv, causal,
                                                     window, dtype):
    """The head dims the kernel gains for hubert-xlarge (80) and
    recurrentgemma-9b (256): the plain version against the reference's
    kernel in interpret mode (K/V heads broadcast for it) and its oracle,
    on tiny S; causal or windowed, where the reference's wrapper pads
    nothing it does not mask.  fp32 at 2e-4; bf16 per element and per
    row as above."""
    b, s = 1, 40
    q, k, v = _inputs(b, s, s, h, kv, hd, 7)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = _ours(q, k, v, tdtype, causal=causal, window=window)
    g = h // kv
    kb, vb = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    ref = np.asarray(j_flash_attention(
        *(jnp.asarray(a, dtype) for a in (q, kb, vb)), causal=causal,
        window=window, bq=16, bk=16, interpret=True).astype(jnp.float32))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            got, _ref_oracle(q, k, v, causal, window, 0.0), rtol=2e-4,
            atol=2e-4)
    else:
        tol = BF16_TOL * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        assert _row_err(got, ref) <= BF16_ROW_RTOL


def test_head_dims_are_the_kernels():
    """The wrapper's head dims are the C entry's switch cases."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    src = (_build._KERNELS_DIR / _build.SOURCES["flash_attention"]).read_text()
    cases = tuple(int(n) for n in re.findall(r"REPRO_FLASH_CASE\((\d+)\)", src))
    assert cases == ops.HEAD_DIMS == (16, 32, 64, 80, 128, 256)


def test_output_dtype_and_refusals():
    q = torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    assert attention_ref(q, k, k).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, k, k)                     # impl='cuda' on the CPU
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16),
                        impl="torch")
    with pytest.raises(ValueError, match="no key"):
        flash_attention(q, k[:, :2], k[:, :2], window=4, impl="torch")
    with pytest.raises(ValueError, match="impl"):
        flash_attention(q, k, k, impl="pallas")

"""The flash-attention backward on the CPU: ``ref.py::attention_bwd_ref``
(the plain version of csrc/flash_attention_bwd.cu, from the saved row
statistic ``lse``) and the ``FlashAttention`` autograd.Function that
``flash_attention`` is under grad, against ``torch.autograd`` through
``attention_ref`` and against ``jax.vjp`` of the reference's training
attention (``repro.models.attention.attention_naive``, the function the
JAX package differentiates).

The same numpy inputs go to every side.  fp32 within rtol = atol = 2e-4
of max(1, max|ref|) (the flash suite's fp32 tolerance): the three compute
the same sums in other orders.  The Function's wiring on the CPU is the
card's: its forward saves ``lse``, its backward is the plain backward.

The bf16 kernel's arithmetic (p and ds rounded to bf16 before the dv, dk
and dq products, its tiles and its head split's group order) is replayed
by scripts/flash_bwd_replay.py and held here, on bf16 inputs, against
``jax.vjp`` in fp32 and ``attention_bwd_ref`` at the card's bf16 gates;
so is the fp32 kernel's (every product as 3xTF32, the permuted k8 steps,
the partial sums, its tiles and its head split), on fp32 inputs, at the
card's fp32 gates; the kernels themselves run on the card
(tests/test_torch_cuda.py).
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_naive
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    FlashAttention,
    attention_bwd_ref,
    attention_ref,
    attention_ref_lse,
    flash_attention,
    ops,
)
from repro_torch.kernels.flash_attention.ref import attention_mask

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "flash_bwd_replay", REPO / "scripts" / "flash_bwd_replay.py")
replay_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(replay_mod)
BF16_SOURCE = (_build._KERNELS_DIR / "flash_attention" / "csrc"
               / "flash_attention_bwd_bf16.cuh")
FP32_SOURCE = BF16_SOURCE.with_name("flash_attention_bwd_fp32.cuh")

TOL = 2e-4
# (B, S, Sk, H, KV, hd, causal, window, cap): causal, window, softcap,
# GQA and MQA, non-causal ragged S and Sk, hd 80 and 256.
CASES = {
    "causal gqa": (2, 24, 24, 8, 2, 16, True, 0, 0.0),
    "window": (1, 40, 40, 4, 2, 32, True, 7, 0.0),
    "softcap": (2, 20, 20, 4, 4, 16, True, 0, 5.0),
    "mqa window softcap": (1, 33, 33, 6, 1, 16, True, 9, 3.0),
    "non-causal ragged": (2, 19, 13, 4, 2, 32, False, 0, 0.0),
    "hd 80 non-causal": (1, 17, 17, 4, 4, 80, False, 0, 0.0),
    "hd 256 mqa window": (1, 21, 21, 2, 1, 256, True, 6, 0.0),
}


def _inputs(b, s, sk, h, kv, hd, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (q_scale * rng.normal(size=(b, s, h, hd))).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, hd)).astype(np.float32)
    do = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    return q, k, v, do


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _autograd(fn, q, k, v, do):
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*t)
    return out.detach(), torch.autograd.grad(out, t, torch.tensor(do))


def _jax_grads(q, k, v, do, causal, window, cap):
    """The reference's attention_naive and its vjp, in the port's layout."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv

    def fn(q, k, v):
        out = attention_naive(q.reshape(b, s, kv, g, hd), k, v, jnp.arange(s),
                              jnp.arange(sk), causal, window, cap)
        return out.reshape(b, s, h, hd)

    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES)
def test_function_gradients_match_autograd_and_jax(case):
    b, s, sk, h, kv, hd, causal, window, cap = CASES[case]
    q, k, v, do = _inputs(b, s, sk, h, kv, hd)
    out, grads = _autograd(lambda *t: flash_attention(
        *t, causal, window, cap, impl="torch"), q, k, v, do)
    auto_out, auto = _autograd(lambda *t: attention_ref(
        *t, causal, window, cap), q, k, v, do)
    j_out, j_grads = _jax_grads(q, k, v, do, causal, window, cap)
    _close(out, auto_out)
    _close(out, j_out)
    for got, a, j in zip(grads, auto, j_grads):
        _close(got, a)
        _close(got, j)


@pytest.mark.parametrize("case", ["causal gqa", "mqa window softcap",
                                  "non-causal ragged"])
def test_bwd_ref_from_saved_lse(case):
    """attention_bwd_ref from the forward's (out, lse) equals autograd; the
    lse is the natural log-sum-exp of the valid scaled scores times log2 e
    (the kernels' base-2 units)."""
    b, s, sk, h, kv, hd, causal, window, cap = CASES[case]
    q, k, v, do = _inputs(b, s, sk, h, kv, hd, seed=1)
    t = [torch.tensor(a) for a in (q, k, v)]
    out, lse = attention_ref_lse(*t, causal, window, cap)
    dq, dk, dv = attention_bwd_ref(*t, out, torch.tensor(do), lse, causal,
                                   window, cap)
    _, auto = _autograd(lambda *x: attention_ref(*x, causal, window, cap),
                        q, k, v, do)
    for got, ref in zip((dq, dk, dv), auto):
        _close(got, ref)
    # lse by hand for one (batch, head): query head h on KV head h // G.
    scale = 1 / np.sqrt(hd)
    scores = np.einsum("sd,kd->sk", q[0, :, h - 1], k[0, :, (h - 1) // (h // kv)])
    y = scores * scale
    y = np.tanh(y / cap) * cap if cap > 0 else y
    qp, kp = np.arange(s)[:, None], np.arange(sk)[None, :]
    valid = np.ones((s, sk), bool)
    if causal:
        valid &= kp <= qp
    if window > 0:
        valid &= kp > qp - window
    y = np.where(valid, y, -np.inf)
    want = np.log(np.exp(y - y.max(1, keepdims=True)).sum(1)) + y.max(1)
    np.testing.assert_allclose(lse[0, h - 1].numpy(), want * np.log2(np.e),
                               rtol=1e-5, atol=1e-5)


def test_saturated_softcap_gradient_shrinks():
    """Gemma2's global case with q x 8: the scaled scores pass the cap's
    bend (the factor 1 - tanh^2 on ds is below 0.05 for most pairs), and
    the gradients stay finite and equal to jax's."""
    b, s, sk, h, kv, hd, causal, window, cap = 1, 32, 32, 4, 2, 32, True, 0, 2.0
    q, k, v, do = _inputs(b, s, sk, h, kv, hd, seed=2, q_scale=8.0)
    _, grads = _autograd(lambda *t: flash_attention(
        *t, causal, window, cap, impl="torch"), q, k, v, do)
    _, j_grads = _jax_grads(q, k, v, do, causal, window, cap)
    for got, j in zip(grads, j_grads):
        assert torch.isfinite(got).all()
        _close(got, j)
    y = np.einsum("bshd,bkhd->bhsk", q, np.repeat(k, h // kv, axis=2)) / np.sqrt(hd)
    factor = (1 - np.tanh(y / cap) ** 2)[:, :, np.tril(np.ones((s, sk), bool))]
    assert np.median(factor) < 0.05


def test_bf16_function_keeps_dtypes_and_tracks_fp32():
    """In bf16 the Function's gradients come in bf16 and track the fp32
    ones within bf16's rounding of p and the outputs: 3e-2 of max(1,
    max|ref|), the flash suite's bf16 tolerance."""
    b, s, sk, h, kv, hd, causal, window, cap = CASES["mqa window softcap"]
    q, k, v, do = _inputs(b, s, sk, h, kv, hd, seed=3)
    t = [torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*t, causal, window, cap, impl="torch")
    grads = torch.autograd.grad(out, t, torch.tensor(do).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    f32 = [a.detach().float().numpy() for a in t]
    _, ref = _autograd(lambda *x: attention_ref(*x, causal, window, cap),
                       *f32, torch.tensor(do).to(torch.bfloat16).float().numpy())
    for got, r in zip(grads, ref):
        _close(got.float(), r, tol=3e-2)


def test_function_is_used_only_under_grad():
    """Without grad (or with no input requiring it) the forward is the
    inference path: no graph node, no lse; under grad the node is
    FlashAttention's."""
    q, k, v, _ = _inputs(1, 8, 8, 4, 2, 16)
    t = [torch.tensor(a) for a in (q, k, v)]
    assert flash_attention(*t, impl="torch").grad_fn is None
    req = [x.clone().requires_grad_() for x in t]
    with torch.no_grad():
        assert flash_attention(*req, impl="torch").grad_fn is None
    with torch.inference_mode():
        assert flash_attention(*t, impl="torch").grad_fn is None
    out = flash_attention(*req, impl="torch")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert FlashAttention.__name__ == "FlashAttention"


def test_cuda_impl_refuses_cpu_tensors_under_grad():
    q, k, v, do = _inputs(1, 8, 8, 4, 2, 16)
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(*t)
    plain = [x.detach() for x in t]
    out, lse = attention_ref_lse(*plain)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention_bwd(*plain, out, torch.tensor(do), lse)


def test_backward_entry_head_dims_are_the_forward_s():
    """The backward's C entry is compiled for the forward's head dims, and
    the wrapper's argument list matches the entry's parameters."""
    src = (_build._KERNELS_DIR / _build.SOURCES["flash_attention_bwd"]).read_text()
    cases = tuple(int(n) for n in re.findall(r"REPRO_FLASH_BWD_CASE\((\d+)\)", src))
    assert cases == ops.HEAD_DIMS
    entry = src[src.index('extern "C" int repro_flash_attention_bwd('):]
    params = entry[:entry.index(")")].split("(", 1)[1].split(",")
    assert len(params) == len(ops._BWD_ARGTYPES)
    fwd = (_build._KERNELS_DIR / _build.SOURCES["flash_attention"]).read_text()
    fwd_entry = fwd[fwd.index('extern "C" int repro_flash_attention('):]
    fwd_params = fwd_entry[:fwd_entry.index(")")].split("(", 1)[1].split(",")
    assert len(fwd_params) == len(ops._ARGTYPES)
    assert fwd_params[-1].strip() == "float* lse"


# ---------------------------------------------------------------------------
# The bf16 kernel's arithmetic (scripts/flash_bwd_replay.py) and its head
# split.

# chip_smoke.py's bf16 gates: FLASH_BWD_TOL and FLASH_BWD_ROW_RTOL, each
# row's norm floored at 1e-2 of the largest row's.
BF16_TOL = BF16_ROW_TOL = 1e-2
REPLAY_CASES = {
    "llama grouping": (1, 128, 128, 8, 2, 64, True, 0, 0.0),
    "gemma2 window softcap": (1, 160, 160, 4, 2, 128, True, 48, 50.0),
    "mqa hd 256 split": (1, 96, 96, 8, 1, 256, True, 40, 0.0),
}


@pytest.mark.parametrize("case", REPLAY_CASES)
def test_bf16_replay_holds_the_card_gates(case):
    """The replay on bf16 q, k, v and dout against jax.vjp of
    attention_naive in fp32 on the same (bf16-representable) values, and
    against the plain backward: each element within 1e-2 of max(1,
    max|ref|), each row within 1e-2 of its norm (floored).

    jax's vjp uses the exact forward output, so against it the replay
    takes the fp32 forward's out and lse; against the plain version it
    takes the bf16 forward's, as the card does.  (The bf16 out moves D =
    rowsum(dout out) by its rounding, and in the causal rows where dq
    cancels that alone puts the plain bf16 backward 2.5e-2 per row from
    jax: a property of the forward's output, not of this kernel.)"""
    b, s, sk, h, kv, hd, causal, window, cap = REPLAY_CASES[case]
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(b, s, sk, h, kv, hd, seed=4))
    _, j_grads = _jax_grads(*(t.float().numpy() for t in (q, k, v, do)),
                            causal, window, cap)
    out, lse = attention_ref_lse(*(t.float() for t in (q, k, v)), causal,
                                 window, cap)
    sides = [(replay_mod.replay(q, k, v, out, do, lse, causal, window, cap),
              [torch.tensor(j) for j in j_grads])]
    out, lse = attention_ref_lse(q, k, v, causal, window, cap)
    sides.append((replay_mod.replay(q, k, v, out, do, lse, causal, window, cap),
                  attention_bwd_ref(q, k, v, out, do, lse, causal, window, cap)))
    for got, refs in sides:
        for x, ref in zip(got, refs):
            assert x.dtype == torch.bfloat16
            elem, row = replay_mod.errors(x, ref)
            assert elem <= BF16_TOL and row <= BF16_ROW_TOL, (elem, row)
    if case == "mqa hd 256 split":
        assert ops.bwd_head_split(b, kv, sk, h // kv, hd) > 1


def test_bf16_replay_split_sums_the_groups_in_order():
    """The head split changes only the order of dk's and dv's fp32 sums:
    split and unsplit replays agree within one bf16 rounding."""
    b, s, sk, h, kv, hd, causal, window, cap = REPLAY_CASES["mqa hd 256 split"]
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(b, s, sk, h, kv, hd, seed=5))
    out, lse = attention_ref_lse(q, k, v, causal, window, cap)
    one = replay_mod.replay(q, k, v, out, do, lse, causal, window, cap, split=1)
    many = replay_mod.replay(q, k, v, out, do, lse, causal, window, cap, split=8)
    assert torch.equal(one[0], many[0])       # dq does not depend on it
    for a, c in zip(one[1:], many[1:]):
        assert replay_mod.errors(a, c)[0] <= 2 ** -7


def test_bwd_head_split_rule():
    """Llama-3.2-1B's microbatch fills the card unsplit; recurrentgemma-9b's
    MQA at hd 256 (128 dk/dv blocks for 132 SMs) splits its 16 heads into
    groups that give every SM two blocks; G = 1 cannot split; the fp32
    partials' workspace is (dk, dv) x groups x dk's shape."""
    assert ops.bwd_head_split(2, 8, 4096, 4, 64) == 1
    split = ops.bwd_head_split(1, 1, 4096, 16, 256)
    assert split == 4 and 128 * split >= ops.BWD_BLOCKS_PER_SM * 132
    assert ops.bwd_head_split(1, 1, 4096, 16, 256, sms=64) == 1
    assert ops.bwd_head_split(1, 16, 1000, 1, 80) == 1
    assert ops.bwd_head_split(1, 1, 96, 8, 256) == 8   # never more than G
    assert (ops.bwd_workspace_shape(split, 1, 4096, 1, 256)
            == (2, split, 1, 4096, 1, 256))


def test_replay_tiles_and_split_keys_are_the_kernels():
    """The replay's tiles and ops.BWD_BLOCK_KEYS are the bf16 kernel's
    Cfg<HD>, read from its source."""
    text = BF16_SOURCE.read_text()

    def pick(name):
        m = re.search(rf"int {name} = HD (<=|==) (\d+) \? (\d+) : (\d+);", text)
        assert m, name
        op, edge, yes, no = m.groups()
        return lambda hd: int(yes) if (hd <= int(edge) if op == "<=" else
                                       hd == int(edge)) else int(no)

    bk, bq_t, bk_t = pick("BK"), pick("BQ_T"), pick("BK_T")
    assert "static constexpr int NW = 4;" in text
    assert "static constexpr int BQ = 16 * NW;" in text
    for hd in ops.HEAD_DIMS:
        assert replay_mod.tiles(hd) == (bk(hd), bq_t(hd), 64, bk_t(hd))
        assert ops.BWD_BLOCK_KEYS[hd] == bk(hd)


# ---------------------------------------------------------------------------
# The fp32 kernel's arithmetic (scripts/flash_bwd_replay.py's replay_fp32).

# chip_smoke.py's fp32 gates: FLASH_BWD_TOL and FLASH_BWD_ROW_RTOL, each
# row's norm floored at 1e-2 of the largest row's.
FP32_TOL, FP32_ROW_TOL = 2e-4, 1e-4
# (B, S, Sk, H, KV, hd, causal, window, cap, q scale): Llama-3.2-1B's
# grouping, Gemma2's window with its softcap, the softcap saturated (q x
# 8), ragged non-causal, hd 256 MQA with the head split.
FP32_REPLAY_CASES = {
    "llama grouping": (1, 128, 128, 8, 2, 64, True, 0, 0.0, 1.0),
    "gemma2 window softcap": (1, 144, 144, 4, 2, 128, True, 48, 50.0, 1.0),
    "softcap saturated": (1, 96, 96, 4, 2, 32, True, 0, 2.0, 8.0),
    "non-causal ragged": (2, 70, 45, 4, 2, 64, False, 0, 0.0, 1.0),
    "mqa hd 256 split": (1, 96, 96, 8, 1, 256, True, 40, 0.0, 1.0),
}


def _fp32_case(case, seed=6):
    b, s, sk, h, kv, hd, causal, window, cap, qs = FP32_REPLAY_CASES[case]
    q, k, v, do = _inputs(b, s, sk, h, kv, hd, seed=seed, q_scale=qs)
    t = [torch.tensor(a) for a in (q, k, v, do)]
    out, lse = attention_ref_lse(*t[:3], causal, window, cap)
    return (q, k, v, do), t, out, lse, (causal, window, cap)


def _plain_f64(t, out, lse, mask):
    """attention_bwd_ref on float64 copies of the fp32 inputs: its steps
    to float64's rounding, which the card's fp32 gates hold the kernel
    against."""
    return attention_bwd_ref(*(x.double() for x in (t[0], t[1], t[2], out,
                                                     t[3], lse)), *mask)


@pytest.mark.parametrize("case", FP32_REPLAY_CASES)
def test_fp32_replay_holds_the_card_gates(case):
    """The fp32 replay against jax.vjp of attention_naive, against the
    plain backward, and against the plain backward's steps in float64
    (``attention_bwd_ref`` on float64 copies of the same inputs), on the
    same numpy inputs and the plain forward's out and lse: each element
    within 2e-4 of max(1, max|ref|), each row within 1e-4 of its norm
    (floored at 1e-2 of the largest row's).

    The fp32 plain version takes D as jax does (rowsum(p o dp), over the
    row sum of p), so the causal first row's dq,
    whose true value cancels to ~0 (one key: p = 1), is 0 in both, and
    the replay's own rounding of that row (its D is rowsum(dout o out))
    is what the three comparisons read there."""
    arrays, t, out, lse, mask = _fp32_case(case)
    got = replay_mod.replay_fp32(t[0], t[1], t[2], out, t[3], lse, *mask)
    _, j_grads = _jax_grads(*arrays, *mask)
    plain = attention_bwd_ref(t[0], t[1], t[2], out, t[3], lse, *mask)
    pairs = [*zip(got, (torch.tensor(j) for j in j_grads)),
             *zip(got, _plain_f64(t, out, lse, mask)),
             *zip(got, plain)]
    assert len(pairs) == 9
    for x, ref in pairs:
        assert x.dtype == torch.float32 and torch.isfinite(x).all()
        elem, row = replay_mod.errors(x, ref)
        assert elem <= FP32_TOL and row <= FP32_ROW_TOL, (elem, row)


@pytest.mark.parametrize("lse_ulps", [0, 4])
@pytest.mark.parametrize("case", ["llama grouping", "mqa hd 256 split",
                                  "gemma2 window softcap"])
def test_fp32_plain_causal_first_row_cancels_as_jax(case, lse_ulps):
    """The fp32 plain backward's dq at the causal first row (one key, p =
    1, so its true gradient is 0) against ``jax.vjp`` of the reference's
    ``attention_naive`` on the same inputs: within 1e-6 of the row floor
    (1e-2 of the largest dq row's norm), every head; from the plain
    forward's lse and from one moved by up to ``lse_ulps`` units of its
    last place, as another forward's (the kernel's) may be."""
    arrays, t, out, lse, mask = _fp32_case(case)
    if lse_ulps:
        g = torch.Generator().manual_seed(1)
        steps = torch.randint(-lse_ulps, lse_ulps + 1, lse.shape, generator=g)
        lse = lse + steps * (torch.nextafter(lse.abs(), torch.tensor(np.inf))
                             - lse.abs())
    _, j_grads = _jax_grads(*arrays, *mask)
    dq = attention_bwd_ref(t[0], t[1], t[2], out, t[3], lse, *mask)[0]
    ref = torch.tensor(j_grads[0])
    floor = 1e-2 * float(ref.norm(dim=-1).max())
    first = (dq[:, 0] - ref[:, 0]).norm(dim=-1)            # (B, H)
    assert float(first.max()) <= 1e-6 * floor, float(first.max()) / floor


def test_fp32_plain_backward_with_an_empty_row():
    """Rows with no valid key (causal, window 3, S 12 over Sk 6: rows 8 to
    11) have p = 0, so D = 0 there, not 0 / 0: every fp32 plain gradient
    is finite, those rows' dq is 0, and each gradient is within the fp32
    gates of the plain steps in float64 (whose D reads out)."""
    b, s, sk, h, kv, hd, causal, window = 1, 12, 6, 4, 2, 16, True, 3
    t = [torch.tensor(a) for a in _inputs(b, s, sk, h, kv, hd, seed=3)]
    out, lse = attention_ref_lse(*t[:3], causal, window)
    empty = ~attention_mask(s, sk, causal, window, "cpu").any(-1)
    assert empty.tolist() == [False] * 8 + [True] * 4
    got = attention_bwd_ref(t[0], t[1], t[2], out, t[3], lse, causal, window)
    want = _plain_f64(t, out, lse, (causal, window, 0.0))
    for x, ref in zip(got, want):
        assert torch.isfinite(x).all()
        elem, row = replay_mod.errors(x, ref)
        assert elem <= FP32_TOL and row <= FP32_ROW_TOL, (elem, row)
    assert not got[0][:, empty].any()


def test_fp32_plain_rows_at_the_saturated_softcap_cell():
    """Why the card holds the fp32 kernel at its saturated softcap cell to
    the float64 steps alone: there the fp32 plain version's own dq rows
    lie more than half the row gate (1e-4) from its float64 steps.  One KV
    group of that cell (S 4096, two query heads, hd 128, causal, softcap
    50, q x 8: exponents near 72, rows near one-hot) against the same
    inputs unsaturated (q x 1), where they lie under 5 % of it; dk and dv
    within the gate at both."""
    b, s, h, kv, hd, cap = 1, 4096, 2, 1, 128, 50.0
    rows = {}
    for scale in (8.0, 1.0):
        q, k, v, do = _inputs(b, s, s, h, kv, hd, seed=6, q_scale=scale)
        t = [torch.tensor(a) for a in (q, k, v, do)]
        out, lse = attention_ref_lse(*t[:3], True, 0, cap)
        plain = attention_bwd_ref(t[0], t[1], t[2], out, t[3], lse, True, 0, cap)
        f64 = _plain_f64(t, out, lse, (True, 0, cap))
        rows[scale] = [replay_mod.errors(x, r)[1] for x, r in zip(plain, f64)]
        del plain, f64
    print(f"fp32 plain rows from float64 (dq, dk, dv): saturated {rows[8.0]}, "
          f"unsaturated {rows[1.0]}")
    assert 0.5 * FP32_ROW_TOL < rows[8.0][0] <= FP32_ROW_TOL, rows
    assert rows[1.0][0] < 0.05 * FP32_ROW_TOL, rows
    assert max(rows[8.0][1:] + rows[1.0][1:]) <= FP32_ROW_TOL, rows


@pytest.mark.parametrize("terms", [2, 1])
@pytest.mark.parametrize("case", ["llama grouping", "gemma2 window softcap",
                                  "mqa hd 256 split"])
def test_fp32_replay_without_a_correction_term_fails(case, terms):
    """The margin: with the hi.lo term dropped (2), or as plain TF32 (1),
    some gradient breaks the fp32 gates (against the float64 steps, as on
    the card) where the three terms pass."""
    _, t, out, lse, mask = _fp32_case(case)
    plain = _plain_f64(t, out, lse, mask)
    got = replay_mod.replay_fp32(t[0], t[1], t[2], out, t[3], lse, *mask,
                                 terms=terms)
    worst = [replay_mod.errors(x, r) for x, r in zip(got, plain)]
    assert any(e > FP32_TOL or r > FP32_ROW_TOL for e, r in worst), worst


def test_fp32_replay_split_sums_the_groups_in_order():
    """The head split changes only the order of dk's and dv's fp32 sums:
    split and unsplit replays agree within fp32 rounding; dq does not
    depend on it."""
    _, t, out, lse, mask = _fp32_case("mqa hd 256 split", seed=7)
    args = (t[0], t[1], t[2], out, t[3], lse, *mask)
    one = replay_mod.replay_fp32(*args, split=1)
    many = replay_mod.replay_fp32(*args, split=8)
    assert torch.equal(one[0], many[0])
    for a, c in zip(one[1:], many[1:]):
        assert replay_mod.errors(a, c)[0] <= 1e-6


def _c_int(expr: str, env: dict) -> int:
    """An int constant expression of a Cfg<HD> line: right-nested ?:,
    comparisons, + - * / %, names from ``env``."""
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        then, other = rest.split(":", 1)
        return _c_int(then if _c_int(cond, env) else other, env)
    return int(eval(expr.replace("/", "//"), {"__builtins__": {}}, env))


def _cfg(text: str, hd: int) -> dict:
    """Every ``static constexpr int`` of the source's Cfg<HD> at head dim
    ``hd``, in order of definition."""
    body = text[text.index("struct Cfg {"):]
    body = body[:body.index("\n};")]
    env = {"HD": hd}
    for name, expr in re.findall(r"static constexpr int (\w+) =\s*([^;]+);",
                                 body):
        env[name] = _c_int(" ".join(expr.split()), env)
    return env


def test_fp32_replay_tiles_and_split_keys_are_the_kernels():
    """The fp32 replay's tiles and partial lengths are the fp32 kernel's
    Cfg<HD>, read from its source; its keys a dk/dv block equal the bf16
    body's, so ops.BWD_BLOCK_KEYS and bwd_head_split hold for both types:
    recurrentgemma-9b's MQA at hd 256 splits 4 ways in fp32 too."""
    fp32, bf16 = FP32_SOURCE.read_text(), BF16_SOURCE.read_text()
    for hd in ops.HEAD_DIMS:
        c = _cfg(fp32, hd)
        assert replay_mod.tiles_fp32(hd) == (
            c["BK"], c["BQ_T"], c["JQ"], c["JD_DKDV"], c["BQ"], c["BK_T"],
            c["JK"], c["JD_DQ"])
        assert c["BK"] == _cfg(bf16, hd)["BK"] == ops.BWD_BLOCK_KEYS[hd]
        assert c["THREADS"] == 128 and c["BQ"] == 64
    assert ops.bwd_head_split(1, 1, 4096, 16, 256) == 4
    assert ops.bwd_head_split(2, 8, 4096, 4, 64) == 1
    # Every product on the shared 3xTF32 helpers: no CUDA-core FMA loop,
    # no p or ds array in shared memory.
    header = _build._KERNELS_DIR / _build.SHARED_INCLUDE / "sgemm_3xtf32.cuh"
    assert header in _build.included_headers(FP32_SOURCE)
    assert fp32.count("tc::mma_3xtf32(") == 5
    assert "mma_tf32(c, al, bh);\n  mma_tf32(c, ah, bl);\n" in header.read_text()
    assert not re.search(r"fmaf\(|\bP[sS]\b|\bdS[sS]\b", fp32)
    assert "(dtype == 0 && split != 1)" not in (
        _build._KERNELS_DIR / _build.SOURCES["flash_attention_bwd"]).read_text()

"""The fp32 flash-attention kernel on the tensor cores (flash_attention/
csrc/flash_attention_fp32.cuh), on the CPU: its arithmetic replayed in
numpy (scripts/flash_fp32_replay.py) against the JAX package's
``flash_attention_pallas`` (interpret mode) and its oracle
``attention_ref``, at the fp32 gates of ``chip_smoke.py``: each element
within 2e-4 of max(1, max|ref|), each query row within 1e-4 of its norm.

The replay runs both products as three TF32 products per fp32 product
(lo.hi, hi.lo, hi.hi per k8 step), the softmax in base 2 with the
kernel's softcap formula, and P.V with each k8 step's keys in the
kernel's order 0, 2, 4, 6, 1, 3, 5, 7.  Dropping a correction term fails
the gates.  The kernel itself runs on the card (tests/test_torch_cuda.py).
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "flash_fp32_replay", REPO / "scripts" / "flash_fp32_replay.py")
replay_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(replay_mod)

SOURCE = Path(flash_ops.__file__).parent / "csrc" / "flash_attention_fp32.cuh"
HEADER = (Path(flash_ops.__file__).parents[1] / "csrc"
          / "sgemm_3xtf32.cuh")

# (b, s, h, kv, hd, causal, window, cap, q scale, bq, bk): the five cases
# of tests/test_flash_attention.py, GQA with G = 4, a window across kv
# tiles, and the softcap saturated (q x 8: scaled scores of std 8 reach
# the cap's bend).
CASES = {
    "causal": (2, 64, 3, 3, 16, True, 0, 0.0, 1.0, 16, 16),
    "window": (1, 128, 2, 2, 32, True, 32, 0.0, 1.0, 32, 64),
    "softcap": (2, 48, 2, 2, 16, True, 0, 50.0, 1.0, 16, 16),
    "bidirectional": (1, 64, 1, 1, 16, False, 0, 0.0, 1.0, 16, 16),
    "padded": (1, 50, 2, 2, 16, True, 0, 0.0, 1.0, 16, 16),
    "gqa4": (1, 96, 8, 2, 64, True, 0, 0.0, 1.0, 32, 32),
    "window_tiles": (1, 160, 4, 2, 128, True, 40, 50.0, 1.0, 32, 32),
    "softcap_saturated": (1, 64, 2, 2, 32, True, 0, 50.0, 8.0, 16, 16),
}


def _inputs(case, seed=0):
    b, s, h, kv, hd, *_, qs, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, s, h, hd)) * qs).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    return q, k, v


def _references(case, q, k, v):
    """The Pallas kernel (interpret mode) and the oracle, on K/V heads
    broadcast to H (what the reference's wrapper takes), in the port's
    layout."""
    b, s, h, kv, hd, causal, window, cap, _, bq, bk = CASES[case]
    kb, vb = (np.repeat(a, h // kv, axis=2) for a in (k, v))
    pallas = np.asarray(j_flash_attention(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), causal=causal,
        window=window, logit_cap=cap, bq=bq, bk=bk, interpret=True))

    def flat(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, hd))

    oracle = np.asarray(j_attention_ref(flat(q), flat(kb), flat(vb),
                                        causal=causal, window=window,
                                        logit_cap=cap))
    return pallas, oracle.reshape(b, h, s, hd).transpose(0, 2, 1, 3)


def _replay(case, q, k, v, terms=3):
    *_, causal, window, cap, _, _, _ = CASES[case]
    return replay_mod.replay(q, k, v, causal, window, cap, terms)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_holds_the_fp32_gates_against_the_reference(case):
    q, k, v = _inputs(case)
    got = _replay(case, q, k, v)
    for ref in _references(case, q, k, v):
        elem, row = replay_mod.errors(got, ref)
        assert elem <= 1 and row <= 1, (elem, row)


@pytest.mark.parametrize("case", ["gqa4", "window_tiles", "softcap_saturated"])
@pytest.mark.parametrize("terms", [2, 1])
def test_dropping_a_correction_term_fails_the_gates(case, terms):
    """The margin: with the hi.lo term dropped, or as plain TF32 (hi.hi
    only), the row gate fails where the kernel's three terms pass."""
    q, k, v = _inputs(case)
    pallas, _ = _references(case, q, k, v)
    assert replay_mod.errors(_replay(case, q, k, v), pallas)[1] <= 1
    assert replay_mod.errors(_replay(case, q, k, v, terms), pallas)[1] > 1


def test_permuted_keys_give_the_plain_product():
    """P.V with each k8 step's keys in the kernel's order sums the same
    products: within fp32 rounding of the unpermuted product."""
    rng = np.random.default_rng(5)
    p = rng.random((16, 64)).astype(np.float32)
    v = rng.normal(size=(64, 32)).astype(np.float32)
    acc = np.zeros((16, 32), np.float32)
    for j in range(0, 64, 8):
        keys = j + replay_mod.PERM
        acc = replay_mod.mma(acc, p[:, keys], v[keys], 3)
    ref = p.astype(np.float64) @ v
    assert sorted(replay_mod.PERM) == list(range(8))
    np.testing.assert_allclose(acc, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_replay_tiles_are_the_kernels():
    """The replay's kv tile (32 keys at hd <= 64, 16 at hd 128) and P.V
    partial (JC k8 steps) are the kernel's Cfg<HD>::BK and JC, read from
    the source; so is the term order, in the shared header's
    ``mma_3xtf32`` that both products call."""
    text = SOURCE.read_text()
    m = re.search(r"int BK = HD <= (\d+) \? (\d+) : (\d+);", text)
    assert m, "Cfg<HD>::BK not found"
    edge, small, large = map(int, m.groups())
    for hd in flash_ops.HEAD_DIMS:
        assert replay_mod.block_keys(hd) == (small if hd <= edge else large)
    assert f"int JC = {replay_mod.JC};" in text
    # Both products through the shared header's 3xTF32 helper.
    assert text.count("tc::mma_3xtf32(") == 2
    assert ("mma_tf32(c, al, bh);\n  mma_tf32(c, ah, bl);\n"
            "  mma_tf32(c, ah, bh);") in HEADER.read_text()

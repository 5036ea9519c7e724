"""The port's MoE layer against the JAX package's ``apply_moe``, on the CPU.

The same numpy router, expert weights and tokens go to both packages'
``apply_moe`` at three capacity factors: 0.5 drops copies (some experts
get more than their capacity), 1.25 is the configs' default and 4.0
keeps every copy.  The output and the three aux values (load_balance,
router_z, dropped_frac) in fp32 within rtol = 1e-4, atol = 1e-4 *
max(1, max|ref|), as ``_tol`` in tests/test_api.py; the sharded
dispatch variant gives the same output.  The weights are the reference's
init scaled up, so that outputs are of order one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro_torch.models import moe

D, F, E, K = 32, 48, 8, 2


def _tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1.0))


def _params(seed=0, scale=10.0):
    p = j_moe.init_moe(jax.random.PRNGKey(seed), D, F, E, jnp.float32)
    return {k: np.asarray(v) * scale for k, v in p.items()}


def _x(b=2, s=24, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(np.float32)


def _both(params, x, cf, sharded=False, top_k=K):
    y_ref, aux_ref = j_moe.apply_moe(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        top_k, cf, sharded_dispatch=sharded)
    y, aux = moe.apply_moe({k: torch.tensor(v) for k, v in params.items()},
                           torch.tensor(x), top_k, cf, sharded_dispatch=sharded)
    return (y.numpy(), {k: float(v) for k, v in aux.items()},
            np.asarray(y_ref), {k: float(v) for k, v in aux_ref.items()})


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_apply_moe_matches_reference(cf):
    params, x = _params(), _x()
    y, aux, y_ref, aux_ref = _both(params, x, cf)
    assert y.shape == y_ref.shape == x.shape
    np.testing.assert_allclose(y, y_ref, **_tol(y_ref))
    assert set(aux) == set(aux_ref) == {"load_balance", "router_z",
                                        "dropped_frac"}
    for k in aux:
        np.testing.assert_allclose(aux[k], aux_ref[k], rtol=1e-5, atol=1e-6)
    if cf == 0.5:
        assert aux["dropped_frac"] > 0.1
    if cf == 4.0:
        assert aux["dropped_frac"] == 0.0
    assert float(np.abs(y_ref).max()) > 0.5


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_sharded_dispatch_gives_the_same_output(cf):
    """``sharded_dispatch`` is accepted and gives the default's output,
    as the reference's own equality holds on one device
    (tests/test_moe.py::test_sharded_dispatch_matches_default), and it
    matches the reference's sharded variant."""
    params, x = _params(), _x()
    y, aux, y_ref, _ = _both(params, x, cf, sharded=False)
    y_sh, aux_sh, y_ref_sh, _ = _both(params, x, cf, sharded=True)
    np.testing.assert_allclose(y_sh, y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y_sh, y_ref_sh, **_tol(y_ref_sh))
    assert aux_sh == aux


def test_capacity_and_slots():
    """cap = max(int(T k cf / E), k); kept copies take distinct slots in
    token order, each expert's ranks 0, 1, ... below cap."""
    assert moe.capacity(48, 2, 1.25, 8) == 15
    assert moe.capacity(4, 8, 1.25, 32) == 8
    params, x = _params(), _x()
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(t, K, 0.5, E)
    _, _, _, idx = moe.route({k: torch.tensor(v) for k, v in params.items()},
                             torch.tensor(x).reshape(t, D), K)
    flat = idx.reshape(-1).numpy()
    kept = []
    seen = np.zeros(E, int)
    for e in flat:
        if seen[e] < cap:
            kept.append(e * cap + seen[e])
        seen[e] += 1
    assert len(set(kept)) == len(kept)
    assert (seen > cap).any(), "the case must drop copies"


def test_bf16_matches_reference():
    params = _params()
    for k in ("w_gate", "w_up", "w_down"):
        params[k] = params[k].astype(jnp.bfloat16)
    x = _x().astype(jnp.bfloat16)
    y_ref, _ = j_moe.apply_moe({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(x), K, 1.25)
    y, _ = moe.apply_moe(
        {k: torch.tensor(np.asarray(v, np.float32)).to(
            torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
         for k, v in params.items()},
        torch.tensor(np.asarray(x, np.float32)).bfloat16(), K, 1.25)
    assert y.dtype == torch.bfloat16
    y_ref = np.asarray(y_ref.astype(jnp.float32))
    rel = np.linalg.norm(y.float().numpy() - y_ref) / np.linalg.norm(y_ref)
    assert rel <= 2e-2, rel

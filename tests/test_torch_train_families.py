"""The port's loss and gradients against ``jax.value_and_grad`` of the
JAX package's ``loss_fn`` for the MoE and frontend families, on the CPU
at smoke size in fp32 (tests/torch_train_parity.py: every gradient leaf
within rtol = 1e-4, atol = 1e-4 * max(1, max|ref|)): granite-moe and
arctic (with its dense branch; the aux losses at ``AUX_LB_COEF`` and
``AUX_Z_COEF``, ``moe_dropped_frac``), hubert (masked audio targets) and
internvl2 (the text after the patches).
"""
import pytest

from torch_train_parity import check


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b",
                                  "hubert-xlarge", "internvl2-2b"])
def test_loss_and_gradients_match_reference(arch):
    check(arch)

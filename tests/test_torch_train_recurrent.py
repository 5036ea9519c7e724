"""The port's loss and gradients against ``jax.value_and_grad`` of the
JAX package's ``loss_fn`` for the recurrent families, on the CPU at smoke
size in fp32 (tests/torch_train_parity.py: every gradient leaf within
rtol = 1e-4, atol = 1e-4 * max(1, max|ref|)): recurrentgemma at 6 layers
(two periods of rglru, rglru, local, each checkpointed; its smoke
config's seventh layer only adds to the reference's compile time) and
xlstm at its smoke config (12 layers, one pattern of 8 short of two
periods, so all unwrapped, as in the reference; the ``_hd`` marker leaf
gets a zero gradient in both).
"""
from torch_train_parity import check


def test_recurrentgemma_matches_reference():
    check("recurrentgemma-9b", num_layers=6)


def test_xlstm_matches_reference():
    check("xlstm-125m")

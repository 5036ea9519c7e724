"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips where ``torch.cuda.is_available()`` is false (decided inside the
fixture, never at import).  This file imports torch and the port only, so
it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the GEMM and the implicit-GEMM conv sum the same products as
their plain versions in another order, rtol = 1e-4 with atol = 1e-4 *
max|ref|; the fused Winograd kernel also rounds inside its transforms,
5e-4 (tests/test_conv_conformance.py); a whole network compounds the
per-layer differences over its depth, 1e-3 of max|ref|.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.kernels.gemm.ops import matmul_bias_act
from repro_torch.kernels.im2col_gemm.ops import im2col_conv
from repro_torch.kernels.winograd.ops import fused_winograd
from repro_torch.models.cnn import CNNLayer, init_cnn, random_batchnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip where none is visible (decided per test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(device, seed, *shapes):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*s, generator=g).to(device) for s in shapes]


def _close(got, ref, rtol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=rtol,
                               atol=rtol * max(1.0, float(ref.abs().max())))


@pytest.mark.parametrize("m,n,k", [(169, 255, 512), (70, 100, 37), (676, 255, 256)])
def test_gemm_kernel_on_card(cuda_device, m, n, k):
    a, b, bias = _randn(cuda_device, 5, (m, k), (k, n), (n,))
    got = matmul_bias_act(a, b, bias, "leaky")
    _close(got, matmul_bias_act(a, b, bias, "leaky", impl="torch"), 1e-4)


@pytest.mark.parametrize("h,w,c,o,s", [
    (13, 13, 64, 100, 1),      # whole rows per block, ragged out channels
    (19, 70, 16, 20, 2),       # stride 2
    (9, 80, 8, 16, 1),         # OW > 64: 8x8 tiles with a ragged column tile
])
def test_im2col_kernel_on_card(cuda_device, h, w, c, o, s):
    x, wt, bias = _randn(cuda_device, 6, (2, h, w, c), (3, 3, c, o), (o,))
    spec = ConvSpec(c, o, (3, 3), (s, s), (1, 1))
    got = im2col_conv(x, wt, spec, bias=bias, activation="leaky")
    ref = im2col_conv(x, wt, spec, bias=bias, activation="leaky", impl="torch")
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("t,c,o", [(81, 64, 128), (103, 8, 20), (4900, 8, 16)])
def test_winograd_kernel_on_card(cuda_device, t, c, o):
    tiles, u, bias = _randn(cuda_device, 7, (t, 8, 8, c), (8, 8, c, o), (o,))
    got = fused_winograd(tiles, u, bias=bias, activation="leaky")
    ref = fused_winograd(tiles, u, bias=bias, activation="leaky", impl="torch")
    _close(got, ref, 5e-4)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x, wt = _randn(cuda_device, 8, (1, 6, 6, 12), (3, 3, 12, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        im2col_conv(x, wt, ConvSpec(12, 4))
    with pytest.raises(ValueError, match="float32"):
        matmul_bias_act(x[0, 0].double(), wt[0, 0].double())


def test_small_network_on_card(cuda_device):
    """A narrow YOLOv3-tiny-shaped net: impl='cuda' against impl='torch',
    with one kernel launch per planned conv step."""
    def conv(ch, k=3):
        return CNNLayer("conv", out_channels=ch, kernel=k)

    pool2 = CNNLayer("maxpool", size=2, stride=2)
    # Winograd at 64 and 32 px, the GEMM on the 1x1s, im2col at 16 px.
    layers = (conv(13), pool2, conv(24), pool2, conv(16, 1),
              CNNLayer("maxpool", size=2, stride=1), conv(32),
              CNNLayer("conv", out_channels=21, kernel=1, batch_norm=False,
                       activation="linear"))
    model = repro_torch.CNNModel(layers, (64, 64), name="narrow")
    rng = np.random.default_rng(0)
    params = random_batchnorm(init_cnn(rng, layers), rng)
    x = torch.tensor(rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
                     device=cuda_device)
    cu = repro_torch.compile(model, params, repro_torch.ExecutionOptions(batch=2))
    plain = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", batch=2))
    wrappers = {ConvAlgorithm.DIRECT: matmul_bias_act,
                ConvAlgorithm.IM2COL_GEMM: im2col_conv,
                ConvAlgorithm.WINOGRAD: fused_winograd}
    for fn in wrappers.values():
        fn.launches = 0
    got = cu.run(x)
    counts = cu.network_plan().algorithm_counts()
    assert set(counts) == set(wrappers)
    assert {a: fn.launches for a, fn in wrappers.items()} == counts
    _close(got, plain.run(x), 1e-3)

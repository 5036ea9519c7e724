"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips where ``torch.cuda.is_available()`` is false (decided inside the
fixture, never at import).  This file imports torch and the port only, so
it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the GEMM, the implicit-GEMM conv and the 3-pass tuple
multiply sum the same products as their plain versions in another order
(the GEMM and the tuple multiply as three TF32 products per fp32 product,
about 1e-6 of max|ref| in scripts/tf32x3_replay.py),
rtol = 1e-4 with atol = 1e-4 * max|ref|; the int8 kernels sum exactly in
int32, as their plain versions do, and differ at most in the fp32
epilogue, 1e-5; the fused Winograd kernel and the
3-pass transforms also round inside their transforms, 5e-4
(tests/test_conv_conformance.py); a whole network compounds the per-layer
differences over its depth, 1e-3 of max|ref|.  Flash attention: fp32
within 2e-4 (the reference suite's tolerance); bf16 within 3e-2 of
max(1, max|ref|), two units of bf16's last place (both versions round p and
the output to bf16, the sums in another order); and each query row's
difference within 1e-4 (fp32) or 1e-2 (bf16) of that row's norm, which
holds the late causal rows at their own scale (scripts/flash_bf16_replay.py
replays the kernel's bf16 arithmetic on the CPU: at most 0.006).  An LM
forward compounds that over its layers: fp32 within 1e-3 of max|ref|.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec
from repro_torch.kernels.conv_ops import kernel_wrappers
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm.ops import call_splits as gemm_splits
from repro_torch.kernels.gemm.ops import matmul_bias_act, matmul_q8_bias_act
from repro_torch.kernels.im2col_gemm.ops import (
    call_splits,
    im2col_conv,
    im2col_conv_q8,
    pick_blocks,
)
from repro_torch.kernels.winograd.ops import (
    fused_winograd,
    input_transform,
    output_transform,
    tuple_multiply,
)
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


def _row_err(got, ref):
    """The largest per-row relative error over the last dimension."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


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


@pytest.mark.parametrize("m,n,k,splits", [
    (169, 256, 1024, 32),      # YOLOv3-tiny 416 b1 L13: split 32 ways
    (169, 255, 512, 32),       # L15: N = 255, 4-byte copies of B
    (676, 255, 256, 8),        # L21
    (5776, 128, 256, 2),       # MODEL_20 608 L13
    (92416, 32, 64, 1),        # MODEL_20 608 L2: N = 32, no split
    (70, 100, 37, 3),          # ragged K: 4-byte copies of A, 3 chunks
])
def test_gemm_split_k_on_card(cuda_device, m, n, k, splits):
    """The tensor-core GEMM with the split the rule gives (workspace and
    reduce kernel where it splits) against the plain version; two calls
    agree bit for bit, since the partials are added in split order."""
    a, b, bias = _randn(cuda_device, 16, (m, k), (k, n), (n,))
    assert gemm_splits(m, n, k) == splits
    got = matmul_bias_act(a, b, bias, "leaky")
    again = matmul_bias_act(a, b, bias, "leaky")
    _close(got, matmul_bias_act(a, b, bias, "leaky", impl="torch"), 1e-4)
    assert torch.equal(got, again)
    _close(matmul_bias_act(a, b), matmul_bias_act(a, b, impl="torch"), 1e-4)


@pytest.mark.parametrize("t,c,o", [
    (100, 256, 256),           # VGG-16 224 L7
    (1444, 8, 64),             # VGG-16 224 L0: C = 8, one k8 step
    (103, 8, 20),              # ragged T, O % 4 != 0
])
def test_tuple_multiply_on_card(cuda_device, t, c, o):
    v, u = _randn(cuda_device, 17, (64, t, c), (64, c, o))
    got = tuple_multiply(v, u)
    _close(got, tuple_multiply(v, u, impl="torch"), 1e-4)
    assert torch.equal(got, tuple_multiply(v, u))


def test_tensor_core_gemms_refuse_cpu_and_dtype(cuda_device):
    """A CPU operand and a non-fp32 one raise; neither is computed by the
    plain version instead."""
    a, b = _randn(cuda_device, 18, (64, 32), (32, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        matmul_bias_act(a, b.cpu())
    with pytest.raises(ValueError, match="float32"):
        matmul_bias_act(a.half(), b.half())
    v, u = _randn(cuda_device, 19, (64, 10, 8), (64, 8, 4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tuple_multiply(v.cpu(), u)
    with pytest.raises(ValueError, match="float32"):
        tuple_multiply(v.double(), u.double())


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


@pytest.mark.parametrize("b,h,w,c,o,s,splits", [
    (1, 13, 13, 512, 1024, 1, 4),   # YOLOv3-tiny 416 L12: split 4 ways
    (2, 13, 13, 512, 1024, 1, 2),
    (2, 19, 70, 16, 20, 2, 2),      # stride 2, ragged out channels
    (2, 13, 13, 64, 18, 1, 8),      # O % 4 != 0: scalar weight loads
    (1, 152, 152, 128, 256, 2, 1),  # MODEL_20 L12: 400 blocks, no split
])
def test_im2col_split_k_on_card(cuda_device, b, h, w, c, o, s, splits):
    """The split-K path (workspace and reduce kernel) and the single-pass
    path against the plain version; two calls agree bit for bit, since the
    partial sums are added in split order, without atomics."""
    x, wt, bias = _randn(cuda_device, 15, (b, h, w, c), (3, 3, c, o), (o,))
    spec = ConvSpec(c, o, (3, 3), (s, s), (1, 1))
    oh, ow = spec.out_hw(h, w)
    assert call_splits(b, oh, ow, c, o, pick_blocks(oh, ow)[0]) == splits
    got = im2col_conv(x, wt, spec, bias=bias, activation="leaky")
    again = im2col_conv(x, wt, spec, bias=bias, activation="leaky")
    ref = im2col_conv(x, wt, spec, bias=bias, activation="leaky", impl="torch")
    _close(got, ref, 1e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize("t,c,o", [(81, 64, 128), (103, 8, 20), (4900, 8, 16)])
def test_winograd_kernel_on_card(cuda_device, t, c, o):
    tiles, u, bias = _randn(cuda_device, 7, (t, 8, 8, c), (8, 8, c, o), (o,))
    got = fused_winograd(tiles, u, bias=bias, activation="leaky")
    ref = fused_winograd(tiles, u, bias=bias, activation="leaky", impl="torch")
    _close(got, ref, 5e-4)


@pytest.mark.parametrize("t,c,o", [(1444, 64, 64), (103, 8, 20)])
def test_winograd_3pass_kernels_on_card(cuda_device, t, c, o):
    """Each 3-pass kernel against its plain version on the same inputs: a
    VGG-16 224 b1 shape (layer 1) and a ragged one."""
    tiles, u, bias = _randn(cuda_device, 9, (t, 8, 8, c), (64, c, o), (o,))
    v = input_transform(tiles)
    _close(v, input_transform(tiles, impl="torch"), 5e-4)
    v = v.reshape(64, t, c)
    m = tuple_multiply(v, u)
    _close(m, tuple_multiply(v, u, impl="torch"), 1e-4)
    m = m.reshape(8, 8, t, o)
    for b, act in ((bias, "leaky"), (None, "linear")):
        _close(output_transform(m, b, act),
               output_transform(m, b, act, impl="torch"), 5e-4)


def _int8(device, seed, *shapes):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randint(-127, 128, s, generator=g, dtype=torch.int8).to(device)
            for s in shapes]


@pytest.mark.parametrize("m,n,k", [(169, 255, 512), (70, 100, 48),
                                   (676, 128, 256), (169, 256, 1024)])
def test_gemm_q8_kernel_on_card(cuda_device, m, n, k):
    """Ragged M and N (the 255-wide detection head), K a multiple of 16
    but not of the kernel's 32-deep step (48)."""
    a, b = _int8(cuda_device, 10, (m, k), (k, n))
    scale, bias = _randn(cuda_device, 11, (n,), (n,))
    scale = scale.abs() * 1e-3
    for bb, act in ((bias, "leaky"), (None, "linear")):
        got = matmul_q8_bias_act(a, b, scale, bb, act)
        _close(got, matmul_q8_bias_act(a, b, scale, bb, act, impl="torch"), 1e-5)


@pytest.mark.parametrize("h,w,c,o,s,k", [
    (13, 13, 512, 100, 1, 3),     # whole rows per block, ragged out channels
    (19, 70, 16, 20, 2, 3),       # stride 2, 8x8 tiles, ragged column tile
    (9, 80, 32, 16, 1, 3),        # OW > 64: 8x8 tiles
    (10, 11, 16, 9, 2, 1),        # a 1x1 stride-2 conv
])
def test_im2col_q8_kernel_on_card(cuda_device, h, w, c, o, s, k):
    x, wt = _int8(cuda_device, 12, (2, h, w, c), (k, k, c, o))
    scale, bias = _randn(cuda_device, 13, (o,), (o,))
    scale = scale.abs() * 1e-3
    spec = ConvSpec(c, o, (k, k), (s, s), ((k - 1) // 2,) * 2)
    got = im2col_conv_q8(x, wt, spec, scale, bias=bias, activation="leaky")
    ref = im2col_conv_q8(x, wt, spec, scale, bias=bias, activation="leaky",
                         impl="torch")
    _close(got, ref, 1e-5)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x, wt = _randn(cuda_device, 8, (1, 6, 6, 12), (3, 3, 12, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        im2col_conv(x, wt, ConvSpec(12, 4))
    with pytest.raises(ValueError, match="float32"):
        matmul_bias_act(x[0, 0].double(), wt[0, 0].double())
    xq, wq = _int8(cuda_device, 14, (1, 6, 6, 8), (3, 3, 8, 4))
    with pytest.raises(ValueError, match="multiple of 16"):
        im2col_conv_q8(xq, wq, ConvSpec(8, 4), torch.ones(4, device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 16"):
        matmul_q8_bias_act(xq[0, 0], wq[0, 0], torch.ones(4, device=cuda_device))
    with pytest.raises(ValueError, match="int8"):
        matmul_q8_bias_act(x[0, 0, :, :8], wt[0, 0, :8],
                           torch.ones(4, device=cuda_device))


def _small_network_on_card(device, **options):
    """A narrow YOLOv3-tiny-shaped net: impl='cuda' against impl='torch',
    with each kernel launched as often as the plan says."""
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
                     device=device)
    cu = repro_torch.compile(model, params,
                             repro_torch.ExecutionOptions(batch=2, **options),
                             calibration=x)
    plain = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        impl="torch", batch=2, **options), calibration=x)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    got = cu.run(x)
    launches = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    if options.get("dtype") == "int8":
        from repro_torch.core.quant import sqnr_db

        ref = plain.run(x)
        assert torch.isfinite(got).all() and sqnr_db(ref, got) >= 40.0
    else:
        _close(got, plain.run(x), 1e-3)
    return cu.network_plan(), launches


def test_small_network_on_card(cuda_device):
    netplan, launches = _small_network_on_card(cuda_device)
    assert set(netplan.algorithm_counts()) == {
        ConvAlgorithm.DIRECT, ConvAlgorithm.IM2COL_GEMM, ConvAlgorithm.WINOGRAD}
    assert launches == netplan.kernel_launches() == {
        "gemm": 2, "im2col_conv": 1, "winograd_fused": 2}


def test_small_network_3pass_on_card(cuda_device):
    """The same net with the 3-pass pipeline on both Winograd layers."""
    netplan, launches = _small_network_on_card(cuda_device,
                                               winograd_fused=False)
    assert launches == netplan.kernel_launches() == {
        "gemm": 2, "im2col_conv": 1, "input_transform": 2,
        "tuple_multiply": 2, "output_transform": 2}


def test_small_network_int8_on_card(cuda_device):
    """The same net under dtype='int8': the 3x3 convs run the int8 conv
    kernel (the 13-wide stem passes the traffic gate, its input padded
    from 3 to 16 channels), the narrow 1x1s fail the gate and stay fp32,
    and the output is within 40 dB of the plain int8 forward (an fp32
    difference before an int8 layer may round a value near a quantization
    step the other way)."""
    netplan, launches = _small_network_on_card(cuda_device, dtype="int8")
    assert launches == netplan.kernel_launches() == {
        "im2col_conv_q8": 3, "gemm": 2}


def test_device_ms_times_the_card_and_refuses_a_synchronizing_call(cuda_device):
    """``util.device_ms`` times runs longer than the card's launch queue
    (here 1500 launches, split into held runs) and raises on a call that
    synchronizes the host, whose events would time the host."""
    from repro_torch.util import device_ms

    y = torch.zeros(16, device=cuda_device)
    ms = device_ms([lambda: y.add_(1)] * 1500)
    torch.cuda.synchronize()
    assert 0 < ms < 0.1
    with pytest.raises(RuntimeError, match="synchronizes"):
        device_ms([lambda: (y.add_(1), torch.cuda.synchronize())] * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,sk,h,kv,hd,causal,window,cap", [
    (2, 64, 64, 3, 3, 16, True, 0, 0.0),
    (1, 128, 128, 2, 2, 32, True, 32, 0.0),
    (2, 200, 200, 8, 2, 64, True, 0, 0.0),       # Llama grouping, ragged S
    (1, 300, 300, 4, 2, 128, True, 100, 50.0),   # gemma2: window + softcap
    (1, 50, 37, 4, 2, 64, False, 0, 0.0),        # non-causal, ragged Sk
    (1, 130, 130, 4, 4, 128, False, 40, 0.0),    # bidirectional window
])
def test_flash_attention_kernel_on_card(cuda_device, dtype, b, s, sk, h, kv,
                                        hd, causal, window, cap):
    q, k, v = (t.to(dtype) for t in _randn(
        cuda_device, 20, (b, s, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    got = flash_attention(q, k, v, causal, window, cap)
    ref = flash_attention(q, k, v, causal, window, cap, impl="torch")
    assert got.dtype == dtype
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    _close(got.float(), ref.float(), tol)
    assert _row_err(got, ref) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("b,s,sk,h,kv,hd,causal,window", [
    (1, 1, 1, 4, 4, 64, True, 0),          # S = 1
    (1, 3, 1, 8, 8, 32, False, 0),         # Sk = 1, non-causal, G = 1
    (1, 1, 77, 8, 1, 64, False, 0),        # one query, G = 8
    (2, 131, 197, 8, 4, 16, False, 0),     # G = 2; S, Sk off 64 and 128
    (1, 333, 333, 16, 4, 32, True, 0),     # G = 4, causal, ragged S
    (1, 300, 300, 8, 1, 128, True, 128),   # window of two tiles: rows
    (1, 257, 257, 8, 2, 64, True, 64),     # 64m + w - 1 start on a tile
])
def test_flash_attention_bf16_edges_on_card(cuda_device, b, s, sk, h, kv, hd,
                                            causal, window):
    """The bf16 tensor-core kernel against attention_ref at the edges of
    its tiling: single rows and keys, every grouping, ragged S and Sk,
    window edges on tile boundaries, all four head dims."""
    q, k, v = (t.bfloat16() for t in _randn(
        cuda_device, 23, (b, s, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    got = flash_attention(q, k, v, causal, window)
    ref = flash_attention(q, k, v, causal, window, impl="torch")
    assert got.dtype == torch.bfloat16
    _close(got.float(), ref.float(), 3e-2)
    assert _row_err(got, ref) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_softcap_saturated_on_card(cuda_device, dtype):
    """q scaled by 8: scaled scores of std 8 reach the cap's bend, so the
    kernel must compute it; the plain version without the cap fails the
    same row gate."""
    q, k, v = _randn(cuda_device, 22, (1, 300, 4, 128), (1, 300, 2, 128),
                     (1, 300, 2, 128))
    q, k, v = (q * 8).to(dtype), k.to(dtype), v.to(dtype)
    got = flash_attention(q, k, v, True, 0, 50.0)
    ref = flash_attention(q, k, v, True, 0, 50.0, impl="torch")
    nocap = flash_attention(q, k, v, True, 0, 0.0, impl="torch")
    row_tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert _row_err(got, ref) <= row_tol
    assert _row_err(got, nocap) > row_tol


def test_flash_attention_refuses_what_it_does_not_take(cuda_device):
    q, k = _randn(cuda_device, 21, (1, 8, 4, 48), (1, 8, 2, 48))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].cpu().contiguous(),
                        k[..., :32].cpu().contiguous())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b"])
def test_small_lm_on_card(cuda_device, arch):
    """A smoke LM: the flash kernel launched once per attention layer,
    impl='cuda' against impl='torch', and prefill through the kernel
    against token-by-token decode."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = configs.smoke_config(arch)
    params = tf.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    flash_attention.launches = 0
    got = repro_torch.compile(cfg, params).run(toks)
    assert flash_attention.launches == cfg.num_layers
    ref = repro_torch.compile(cfg, params, repro_torch.ExecutionOptions(
        impl="torch")).run(toks)
    _close(got, ref, 1e-3)
    logits_pf, cache_pf = tf.prefill_with_cache(cfg, params, toks[:, :8], 16)
    cache = tf.init_cache(cfg, 2, 16, cuda_device)
    for t in range(8):
        logits_dec, cache = tf.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
    _close(logits_pf, logits_dec, 1e-3)

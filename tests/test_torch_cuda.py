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
epilogue, 1e-5 (the int8 conv and the int8 GEMM, whose epilogues round
as the plain ones do, are held bit for bit, split and unsplit); the fused
Winograd kernel (3xTF32 products too) and the
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
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ops import call_splits as gemm_splits
from repro_torch.kernels.gemm.ops import matmul_bias_act, matmul_q8_bias_act
from repro_torch.kernels.im2col_gemm import ops as im2col_ops
from repro_torch.kernels.im2col_gemm.ops import (
    call_splits,
    call_splits_q8,
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


@pytest.mark.parametrize("t,c,o", [
    (169, 128, 256),           # MODEL_20 608 L14 and L17
    (100, 256, 256),           # VGG-16 224 L7
    (1444, 8, 64),             # VGG-16 224 L0: one chunk of 8 channels
    (37, 24, 42),              # ragged T and O, O % 4 != 0: 4-byte copies
])
def test_winograd_fused_tensor_cores_on_card(cuda_device, t, c, o):
    """The fused kernel's 3xTF32 products at the main path's shapes, with
    and without bias, against the plain version; two calls agree bit for
    bit (nothing in it depends on the order blocks run in)."""
    tiles, u, bias = _randn(cuda_device, 20, (t, 8, 8, c), (8, 8, c, o), (o,))
    for b, act in ((bias, "leaky"), (None, "linear")):
        got = fused_winograd(tiles, u, bias=b, activation=act)
        _close(got, fused_winograd(tiles, u, bias=b, activation=act,
                                   impl="torch"), 5e-4)
        assert torch.equal(got, fused_winograd(tiles, u, bias=b,
                                               activation=act))


def test_winograd_fused_refuses_misaligned_operands(cuda_device):
    """The kernel copies tiles and U 16 bytes at a time: a contiguous view
    that starts off a 16-byte boundary is refused, not misread."""
    t, c, o = 5, 8, 16
    flat, u = _randn(cuda_device, 23, (t * 64 * c + 1,), (8, 8, c, o))
    tiles = flat[1:].view(t, 8, 8, c)
    assert tiles.is_contiguous() and tiles.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_winograd(tiles, u)


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


@pytest.mark.parametrize("m,n,k,splits", [
    (169, 256, 1024, 16),   # YOLOv3-tiny 416 int8 L13
    (169, 255, 512, 16),    # L15: the 255-wide head, byte loads of B
    (169, 128, 256, 8),     # L17
    (92416, 32, 64, 1),     # MODEL_20 608 int8 L2: the 128 x 32 tile
    (5776, 128, 256, 1),    # MODEL_20 L13, L16, L19
    (70, 100, 48, 2),       # ragged M and N, K % 32 == 16
    (676, 128, 256, 8),
    (100, 20, 160, 5),      # N <= 32 and split: the narrow tile, ragged N
    (300, 48, 96, 3),       # N % 16 == 0 in a partial 64-wide tile
])
def test_gemm_q8_kernel_on_card(cuda_device, monkeypatch, m, n, k, splits):
    """The int8 tensor-core GEMM with the split the rule gives (int32
    partials, then the reduce kernel's epilogue) equals the same call
    unsplit and the plain version bit for bit."""
    a, b = _int8(cuda_device, 10, (m, k), (k, n))
    scale, bias = _randn(cuda_device, 11, (n,), (n,))
    scale = scale.abs() * 1e-3
    assert gemm_ops.call_splits_q8(m, n, k) == splits
    for bb, act in ((bias, "leaky"), (None, "linear")):
        got = matmul_q8_bias_act(a, b, scale, bb, act)
        ref = matmul_q8_bias_act(a, b, scale, bb, act, impl="torch")
        with monkeypatch.context() as mp:
            mp.setattr(gemm_ops, "call_splits_q8", lambda *args: 1)
            unsplit = matmul_q8_bias_act(a, b, scale, bb, act)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        assert torch.equal(unsplit, ref)


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


@pytest.mark.parametrize("b,h,w,c,o,s,splits", [
    (1, 13, 13, 512, 1024, 1, 4),   # YOLOv3-tiny 416 int8 L12: 4 splits
    (1, 13, 13, 256, 512, 1, 8),    # L10 and L14: 8 splits of one chunk
    (1, 26, 26, 384, 256, 1, 4),    # L20: 12 chunks in 4 ranges
    (1, 14, 14, 512, 512, 1, 8),    # VGG-16 224 int8 L14-L16's shape
    (2, 19, 70, 48, 20, 2, 2),      # stride 2, ragged O, C % 32 == 16
    (1, 13, 13, 64, 100, 1, 2),     # ragged O (a partial 64-channel block)
    (1, 10, 11, 16, 9, 2, 1),       # O % 4 != 0: byte loads, one chunk
])
def test_im2col_q8_split_k_on_card(cuda_device, monkeypatch, b, h, w, c, o,
                                   s, splits):
    """The int8 tensor-core conv with the split the rule gives (int32
    partials in a workspace, then the reduce kernel's epilogue) equals the
    same call unsplit and the plain version bit for bit, and a second call
    the first."""
    x, wt = _int8(cuda_device, 21, (b, h, w, c), (3, 3, c, o))
    scale, bias = _randn(cuda_device, 22, (o,), (o,))
    scale = scale.abs() * 1e-3
    spec = ConvSpec(c, o, (3, 3), (s, s), (1, 1))
    oh, ow = spec.out_hw(h, w)
    assert call_splits_q8(b, oh, ow, c, o, pick_blocks(oh, ow, "int8")[0]) == splits
    for bb, act in ((bias, "leaky"), (None, "linear")):
        got = im2col_conv_q8(x, wt, spec, scale, bias=bb, activation=act)
        again = im2col_conv_q8(x, wt, spec, scale, bias=bb, activation=act)
        ref = im2col_conv_q8(x, wt, spec, scale, bias=bb, activation=act,
                             impl="torch")
        with monkeypatch.context() as m:
            m.setattr(im2col_ops, "call_splits_q8", lambda *args: 1)
            unsplit = im2col_conv_q8(x, wt, spec, scale, bias=bb,
                                     activation=act)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        assert torch.equal(got, unsplit)
        assert torch.equal(got, again)


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


def _conv(ch, k=3, s=1):
    return CNNLayer("conv", out_channels=ch, kernel=k, stride=s)


_POOL2 = CNNLayer("maxpool", size=2, stride=2)
_HEAD = CNNLayer("conv", out_channels=21, kernel=1, batch_norm=False,
                 activation="linear")
# A narrow YOLOv3-tiny-shaped net: the GEMM on the 1x1s, fused Winograd
# at 64 and 16 px, im2col on the stride-2 conv; a forced 3-pass planner
# keeps Winograd only on the 32 -> 16 conv.
_NARROW = (_conv(32), _conv(16), _POOL2, _conv(24, s=2), _conv(16, 1),
           CNNLayer("maxpool", size=2, stride=1), _conv(32), _HEAD)
# Its int8 variant: a 13-wide stem and no stride-2 conv.
_NARROW_INT8 = (_conv(13), _POOL2, _conv(24), _POOL2, _conv(16, 1),
                CNNLayer("maxpool", size=2, stride=1), _conv(32), _HEAD)


def _small_network_on_card(device, layers=_NARROW, **options):
    """A narrow net: impl='cuda' against impl='torch', with each kernel
    launched as often as the plan says."""
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
        "gemm": 2, "im2col_conv": 1, "winograd_fused": 3}


def test_small_network_3pass_on_card(cuda_device):
    """The same net with the policy forcing the 3-pass pipeline: the
    32 -> 16 conv runs it, the other 3x3 convs im2col."""
    netplan, launches = _small_network_on_card(cuda_device,
                                               winograd_fused=False)
    assert launches == netplan.kernel_launches() == {
        "gemm": 2, "im2col_conv": 3, "input_transform": 1,
        "tuple_multiply": 1, "output_transform": 1}


def test_small_network_int8_on_card(cuda_device):
    """The same net under dtype='int8': the 3x3 convs run the int8 conv
    kernel (the 13-wide stem passes the traffic gate, its input padded
    from 3 to 16 channels), the narrow 1x1s fail the gate and stay fp32,
    and the output is within 40 dB of the plain int8 forward (an fp32
    difference before an int8 layer may round a value near a quantization
    step the other way)."""
    netplan, launches = _small_network_on_card(cuda_device, _NARROW_INT8,
                                               dtype="int8")
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


@pytest.mark.parametrize("b,s,sk,h,kv,hd,causal,window,cap", [
    (1, 1, 1, 4, 4, 64, True, 0, 0.0),          # S = 1
    (1, 3, 1, 8, 8, 32, False, 0, 0.0),         # Sk = 1, non-causal, G = 1
    (1, 1, 77, 8, 1, 64, False, 0, 0.0),        # one query, G = 8
    (2, 131, 197, 8, 4, 16, False, 0, 0.0),     # G = 2; S, Sk off 32 and 64
    (1, 333, 333, 16, 4, 32, True, 0, 0.0),     # G = 4, causal, ragged S
    (1, 300, 300, 8, 1, 128, True, 128, 0.0),   # window of eight 16-key tiles
    (1, 257, 257, 8, 2, 64, True, 64, 0.0),     # rows 64m + w - 1 start a tile
    (2, 100, 100, 4, 2, 16, True, 0, 0.0),      # hd 16, two batches
    (1, 290, 290, 4, 2, 128, True, 100, 50.0),  # hd 128, window + softcap
])
def test_flash_attention_fp32_edges_on_card(cuda_device, b, s, sk, h, kv, hd,
                                            causal, window, cap):
    """The fp32 3xTF32 kernel against attention_ref at the edges of its
    tiling (128 rows a block, two m16 tiles a warp; 32-key tiles at hd <=
    64, 16-key tiles at hd 128): single rows and keys, every grouping,
    ragged S and Sk, window edges on tile boundaries, all four head dims;
    two calls give the same bits (no atomics)."""
    q, k, v = _randn(cuda_device, 24, (b, s, h, hd), (b, sk, kv, hd),
                     (b, sk, kv, hd))
    got = flash_attention(q, k, v, causal, window, cap)
    ref = flash_attention(q, k, v, causal, window, cap, impl="torch")
    assert got.dtype == torch.float32
    _close(got, ref, 2e-4)
    assert _row_err(got, ref) <= 1e-4
    assert torch.equal(got, flash_attention(q, k, v, causal, window, cap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,sk,h,kv,hd,causal,window", [
    (1, 1000, 1000, 4, 4, 80, False, 0),    # hubert-xlarge's hd, ragged
    (2, 131, 197, 4, 2, 80, False, 0),      # Sk off every tile
    (1, 333, 333, 8, 2, 80, True, 0),       # causal, ragged S
    (1, 600, 600, 4, 1, 256, True, 256),    # recurrentgemma: MQA, window
    (1, 200, 200, 4, 1, 256, True, 0),      # causal
    (2, 131, 97, 4, 2, 256, False, 0),      # non-causal, ragged Sk
])
def test_flash_attention_head_dims_80_and_256_on_card(cuda_device, dtype, b,
                                                      s, sk, h, kv, hd,
                                                      causal, window):
    """The head dims of hubert-xlarge (1280 / 16 = 80) and
    recurrentgemma-9b (256), in both kernels: hd 80 on the templates'
    tiles (5 k-steps, 10 output n-tiles), hd 256 on its own configuration
    (Q reloaded from shared memory and 32-key tiles in bf16; 8 warps of
    one m16 tile in fp32), each against attention_ref at the kernel
    gates; two calls give the same bits."""
    q, k, v = (t.to(dtype) for t in _randn(
        cuda_device, 26, (b, s, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    got = flash_attention(q, k, v, causal, window)
    ref = flash_attention(q, k, v, causal, window, impl="torch")
    assert got.dtype == dtype
    fp32 = dtype == torch.float32
    _close(got.float(), ref.float(), 2e-4 if fp32 else 3e-2)
    assert _row_err(got, ref) <= (1e-4 if fp32 else 1e-2)
    assert torch.equal(got, flash_attention(q, k, v, causal, window))


def test_flash_attention_fp32_refuses_misaligned_operands(cuda_device):
    """The fp32 kernel copies q, k and v 16 bytes at a time, as the bf16
    one does: a contiguous view off a 16-byte boundary is refused."""
    flat, k = _randn(cuda_device, 25, (8 * 4 * 32 + 1,), (1, 8, 2, 32))
    q = flat[1:].view(1, 8, 4, 32)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, k)


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


# ---------------------------------------------------------------------------
# CUDA graphs (repro_torch.graphs): the captured forwards and decode step.


@pytest.mark.parametrize("m,n,k,splits", [
    (169, 256, 1024, 32),      # split: workspace and reduce kernel
    (92416, 32, 64, 1),        # unsplit
])
def test_kernel_launch_is_captured_by_a_cuda_graph(cuda_device, m, n, k,
                                                   splits):
    """A launch through ctypes (a library that links the CUDA runtime
    statically) on torch's current stream is recorded by a torch capture:
    the replay computes what the eager launch does, bit for bit, and on
    new operands copied into the captured ones the new product."""
    a, b, bias = _randn(cuda_device, 30, (m, k), (k, n), (n,))
    assert gemm_splits(m, n, k) == splits
    want = matmul_bias_act(a, b, bias, "leaky")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        matmul_bias_act(a, b, bias, "leaky")        # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = matmul_bias_act(a, b, bias, "leaky")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    a.copy_(_randn(cuda_device, 31, (m, k))[0])
    graph.replay()
    assert torch.equal(out, matmul_bias_act(a, b, bias, "leaky"))


def _tiny64(device, batch, dtype):
    """YOLOv3-tiny's layers at 64x64: a compiled model, its input and a
    second input."""
    from repro_torch.configs import yolov3

    model = repro_torch.CNNModel(yolov3.TINY_LAYERS, (64, 64),
                                 name="yolov3-tiny 64")
    rng = np.random.default_rng(1)
    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    x, x2 = (torch.tensor(rng.standard_normal((batch, 64, 64, 3)).astype(
        np.float32), device=device) for _ in range(2))
    cu = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        batch=batch, dtype=dtype), calibration=x)
    return cu, x, x2


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("batch", [1, 2])
def test_captured_forward_equals_eager(cuda_device, batch, dtype):
    """``run`` replays the executor's graph: equal to the eager forward
    bit for bit on two inputs (the input is copied into the graph's), a
    result the caller holds is not overwritten by the next call, and k
    calls count k times the plan's launches."""
    cu, x, x2 = _tiny64(cuda_device, batch, dtype)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    y = cu.run(x)
    ex = cu.executor(batch)
    assert ex.graph is not None
    y2 = cu.run(x2)
    cu.run(x)
    launches = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    assert launches == {k: 3 * n for k, n in
                        cu.network_plan(batch).kernel_launches().items()}
    assert torch.equal(y, ex.eager(x))
    assert torch.equal(y2, ex.eager(x2))
    assert not torch.equal(y, y2)


def test_captured_decode_step_equals_eager(cuda_device):
    """The engine's captured decode step against the same engine run
    eagerly (``step``): the same tokens for 5 requests at batch 2 with
    slot reuse, the same cache bit for bit, and one step's logits equal."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serving import EagerServingEngine, ServingEngine

    cfg = configs.smoke_config("gemma2-27b")
    params = tf.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    params = tf.tree_map(lambda t: t * 8 if t.ndim >= 2 else t, params)
    engines = [cls(cfg, params, batch_size=2, capacity=24)
               for cls in (ServingEngine, EagerServingEngine)]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, size=int(m)) for m in rng.integers(2, 9, 5)]
    results = []
    for engine in engines:
        for p in prompts:
            engine.submit(p, max_new_tokens=20)
        results.append(engine.run())
    graph, eager = engines
    assert graph._graph is not None and eager._graph is None
    assert results[0] == results[1]
    for a, b in zip(graph.cache, eager.cache):
        assert all(torch.equal(a[k], b[k]) for k in a)
    tokens, live = np.array([[5], [7]]), np.array([True, False])
    assert torch.equal(graph._decode(tokens, live), eager._decode(tokens, live))


def test_captured_lm_shapes_share_one_pool(cuda_device):
    """A CompiledLM's graphs share one memory pool: after a second token
    shape is captured into it, each shape's replay still equals its eager
    forward bit for bit."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = configs.smoke_config("llama3.2-1b")
    params = tf.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    lm = repro_torch.compile(cfg, params)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    first = lm.run(toks)
    second = lm.run(toks[:, :12])
    assert len({g.graph.pool() for g in lm._graphs.values()}) == 1
    assert torch.equal(first, lm.eager(toks))
    assert torch.equal(lm.run(toks), lm.eager(toks))
    assert torch.equal(second, lm.eager(toks[:, :12]))


def test_moe_forward_and_decode_are_captured_on_card(cuda_device):
    """granite-moe's smoke config: the MoE dispatch has static shapes, so
    the forward replays as one CUDA graph (equal to the eager forward bit
    for bit, within 1e-3 of impl='torch', one flash launch a layer) and
    the engine's decode step as another (its tokens equal the eager
    engine's)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serving import EagerServingEngine

    cfg = configs.smoke_config("granite-moe-1b-a400m")
    params = tf.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    params = tf.tree_map(lambda t: t * 8 if t.ndim >= 2 else t, params)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    lm = repro_torch.compile(cfg, params)
    flash_attention.launches = 0
    got = lm.run(toks)
    assert len(lm._graphs) == 1
    assert flash_attention.launches == cfg.num_layers      # one replay
    assert torch.equal(lm.run(toks), lm.eager(toks))
    ref = repro_torch.compile(cfg, params, repro_torch.ExecutionOptions(
        impl="torch")).eager(toks)
    _close(got, ref, 1e-3)
    engines = [lm.serve(batch_size=2, capacity=24),
               EagerServingEngine.from_compiled(lm, batch_size=2, capacity=24)]
    assert engines[0]._graph is not None
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(m))
               for m in rng.integers(2, 9, 4)]
    results = []
    for engine in engines:
        for p in prompts:
            engine.submit(p, max_new_tokens=6)
        results.append(engine.run())
    assert results[0] == results[1]


def test_capture_refuses_a_body_that_synchronizes(cuda_device):
    """A host sync inside a captured body raises with the path named; the
    body is not run eagerly instead, and the card stays usable."""
    from repro_torch.graphs import CapturedCall

    calls = []

    def body(x):
        calls.append(1)
        return x * float(x.sum())

    x = torch.ones(8, device=cuda_device)
    with pytest.raises(RuntimeError, match="capture of a synchronizing body"):
        CapturedCall(body, (x,), "a synchronizing body")
    assert len(calls) == 2          # the warm-up and the refused capture
    assert float((x * 2).sum()) == 16.0


def _tiny64_multi(device, dtype, **options):
    """YOLOv3-tiny at 64x64, batch 4: the single-device compilation, one
    over ``[card, card]`` with ``options``, and two inputs."""
    from repro_torch.configs import yolov3

    model = repro_torch.CNNModel(yolov3.TINY_LAYERS, (64, 64),
                                 name="yolov3-tiny 64")
    rng = np.random.default_rng(2)
    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    x, x2 = (torch.tensor(rng.standard_normal((4, 64, 64, 3)).astype(
        np.float32), device=device) for _ in range(2))
    card = torch.device("cuda", torch.cuda.current_device())
    single = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        batch=4, dtype=dtype), calibration=x)
    multi = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        batch=4, dtype=dtype, **options), calibration=x,
        devices=[card, card])
    return single, multi, x, x2


def _same_forward(got, ref, dtype):
    from repro_torch.core.quant import sqnr_db

    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.isfinite(got.float()).all()
    if dtype == "int8":
        assert sqnr_db(ref, got) >= 40.0
    else:
        tol = 1e-3 if dtype == "float32" else 2e-2
        torch.testing.assert_close(
            got.float(), ref.float(), rtol=tol,
            atol=tol * max(1.0, float(ref.float().abs().max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pipeline_on_one_card(cuda_device, dtype):
    """Two stages on one repeated card, two microbatches: each stage its
    own stream, graph and pool.  Against the single-device replay; each
    stage's graph launches its slice's plan, and per call each stage
    replays once a microbatch; an output the caller holds survives the
    next call (the boundary copies wait for their readers)."""
    single, multi, x, x2 = _tiny64_multi(cuda_device, dtype,
                                         pipeline_stages=2, microbatch=2)
    ex = multi.pipeline_executor(4)
    y = multi.run(x)
    pools = {st.graph.graph.pool() for st in ex.stages}
    assert len(pools) == len(ex.stages) == 2
    np_ = multi.network_plan(4)
    for st, (a, z) in zip(ex.stages, ex.pipeplan.stage_bounds):
        assert st.graph.launches == np_.kernel_launches(a, z)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    y2 = multi.run(x2)
    launches = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    assert launches == {k: 2 * n for k, n in np_.kernel_launches().items()}
    _same_forward(y, single.run(x), dtype)
    _same_forward(y2, single.run(x2), dtype)
    assert not torch.equal(y, y2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_sharding_on_one_card(cuda_device, dtype):
    """Two shards of 2 on one repeated card against the single-device
    replay of the batch of 4; each shard's graph launches the plan."""
    single, multi, x, x2 = _tiny64_multi(cuda_device, dtype)
    ex = multi.executor(4)
    assert len(ex.shards) == 2 and ex.graph is None
    y, y2 = multi.run(x), multi.run(x2)
    for sh in ex.shards:
        assert sh.graph.launches == multi.network_plan(4).kernel_launches()
    _same_forward(y, single.run(x), dtype)
    _same_forward(y2, single.run(x2), dtype)


# One shape per kernel family, each through its wrapper on the card: (the
# family, the call).  Shapes where the fp32 and int8 kernels split (and
# launch their reduce), the 16-bit GEMM sums its splits in a cluster, and
# the 16-bit conv runs persistent blocks.
def _family_calls(device):
    from repro_torch.kernels.gemm.ops import matmul16_bias_act
    from repro_torch.kernels.im2col_gemm.ops import im2col_conv16
    from repro_torch.kernels.winograd.ops import (
        fused_winograd16,
        input_transform16,
        output_transform16,
        tuple_multiply16,
    )

    g = torch.Generator(device="cpu").manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    def q(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(device)

    bf = torch.bfloat16
    spec = ConvSpec(64, 96, (3, 3), (1, 1), (1, 1))
    spec16 = ConvSpec(32, 64, (3, 3), (2, 2), (1, 1))
    return {
        "gemm": lambda: matmul_bias_act(r(169, 512), r(512, 256), r(256)),
        "gemm_q8": lambda: matmul_q8_bias_act(q(169, 512), q(512, 256),
                                              r(256), r(256)),
        "gemm_16": lambda: matmul16_bias_act(r(169, 512, dtype=bf),
                                             r(512, 255, dtype=bf), r(255)),
        "im2col_conv": lambda: im2col_conv(r(1, 26, 26, 64), r(3, 3, 64, 96),
                                           spec, bias=r(96)),
        "im2col_conv_q8": lambda: im2col_conv_q8(
            q(1, 26, 26, 64), q(3, 3, 64, 96), spec, r(96), bias=r(96)),
        "im2col_conv_16": lambda: im2col_conv16(
            r(1, 160, 160, 32, dtype=bf), r(3, 3, 32, 64, dtype=bf), spec16,
            bias=r(64)),
        "winograd_fused": lambda: fused_winograd(r(50, 8, 8, 64),
                                                 r(8, 8, 64, 96), bias=r(96)),
        "winograd_fused_16": lambda: fused_winograd16(
            r(17, 8, 8, 64, dtype=bf), r(2, 8, 8, 64, 255, dtype=bf), r(64),
            bias=r(255)),
        "winograd_3pass": lambda: output_transform(tuple_multiply(
            input_transform(r(50, 8, 8, 64)).reshape(64, 50, 64),
            r(64, 64, 96)).reshape(8, 8, 50, 96), r(96)),
        "winograd_3pass_16": lambda: output_transform16(tuple_multiply16(
            input_transform16(r(50, 8, 8, 64, dtype=bf)).reshape(64, 50, 64),
            r(2, 64, 64, 96, dtype=bf), r(64)).reshape(8, 8, 50, 96), r(96)),
    }


@pytest.mark.parametrize("family", [
    "gemm", "gemm_q8", "gemm_16", "im2col_conv", "im2col_conv_q8",
    "im2col_conv_16", "winograd_fused", "winograd_fused_16",
    "winograd_3pass", "winograd_3pass_16"])
def test_describe_equals_the_launch_descriptor(cuda_device, family):
    """Each launch a wrapper records on the card is what its library's
    launcher computes for the same shapes (``describe``): grid, cluster,
    threads, stages and shared memory, a persistent grid at the card's
    resident blocks; its shared memory within the function's limit and
    the device's opt-in."""
    from repro_torch.analysis import VerifyReport, record_launches
    from repro_torch.analysis.passes import describe_pass

    with record_launches() as launches:
        _family_calls(cuda_device)[family]()
    torch.cuda.synchronize()
    assert launches and {d.library for d in launches} == {family}
    report = VerifyReport(level="kernel")
    rows = describe_pass(report, launches)
    assert report.clean, report.summary()
    assert len(rows) == len(launches)
    if family in ("gemm", "gemm_q8", "im2col_conv", "im2col_conv_q8",
                  "winograd_fused_16"):
        assert launches[0].splits > 1 and launches[1].kernel.endswith(
            "_reduce")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_validate_full_is_clean_on_card(cuda_device, dtype):
    """A plan compiled with validate='full' on the card: its executor's
    gate records a forward of the CUDA kernels and every pass comes out
    clean; the executor then runs."""
    from repro_torch.configs import yolov3

    model = repro_torch.CNNModel(yolov3.TINY_LAYERS, (64, 64),
                                 name="yolov3-tiny 64")
    rng = np.random.default_rng(3)
    params = random_batchnorm(init_cnn(rng, model.layers), rng)
    cu = repro_torch.compile(model, params, repro_torch.ExecutionOptions(
        batch=2, dtype=dtype, validate="full"))
    report = cu.reports[2]
    assert report.clean and report.level == "full", report.summary()
    assert len(report.kernels) == report.network["expected_launches"]
    y = cu.run(torch.zeros((2, 64, 64, 3), device=cuda_device))
    assert torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# LM training: the flash backward kernel, the train step, the optimizer.


def _grad_row_err(got, ref, floor=1e-2):
    """The largest per-row relative error of a gradient, each row's norm
    floored at ``floor`` of the largest row's: a row whose gradient
    cancels to ~0 (the first causal rows' dq: p (dp - D) sums to ~0) is
    held at the scale of the others (chip_smoke.py's
    ``FLASH_BWD_ROW_FLOOR``)."""
    got, ref = got.float(), ref.float()
    norm = ref.norm(dim=-1)
    return float(((got - ref).norm(dim=-1)
                  / norm.clamp_min(floor * float(norm.max()))).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,sk,h,kv,hd,causal,window,cap", [
    (2, 200, 200, 8, 2, 64, True, 0, 0.0),       # Llama grouping, ragged S
    (1, 300, 300, 4, 2, 128, True, 100, 50.0),   # gemma2: window + softcap
    (1, 50, 37, 4, 2, 64, False, 0, 0.0),        # non-causal, ragged Sk
    (1, 130, 130, 4, 4, 80, False, 0, 0.0),      # hubert's head dim
    (1, 257, 257, 4, 1, 256, True, 64, 0.0),     # MQA, hd 256, window
    (1, 33, 33, 8, 8, 16, True, 0, 0.0),
    (1, 65, 65, 2, 1, 32, False, 17, 5.0),
    (1, 257, 257, 16, 1, 256, True, 64, 0.0),    # MQA: the head split
    (1, 1, 17, 4, 2, 64, False, 0, 0.0),         # S 1: one row of 16
    (1, 17, 17, 4, 1, 32, True, 0, 0.0),         # S 17: one past a fragment
])
def test_flash_attention_backward_on_card(cuda_device, dtype, b, s, sk, h, kv,
                                          hd, causal, window, cap):
    """flash_attention under grad (the FlashAttention Function: the forward
    writes lse, the backward kernel runs) against attention_bwd_ref from
    the same (out, lse, dout), and lse against attention_ref_lse's:
    gradients per element within 2e-4 (fp32) or 3e-2 (bf16) of max(1,
    max|ref|), per row within 1e-4 or 1e-2 of the row's norm.  In fp32 the
    reference is attention_bwd_ref's steps in float64 (on float64 copies of
    the same inputs), as in chip_smoke.py's phase 8f: at a causal first
    row, whose dq cancels to ~0, an fp32 evaluation keeps only its own
    rounding of dp - D, so two fp32 evaluations (the kernel's 3xTF32 sums
    and the plain version's) can differ there by more than the row gate,
    so the kernel is held to the float64 steps."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref,
        attention_ref_lse,
        flash_attention_bwd,
    )

    q, k, v, do = (t.to(dtype) for t in _randn(
        cuda_device, 30, (b, s, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
        (b, s, h, hd)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    launches, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, causal, window, cap)
    lse = out.grad_fn.saved_tensors[4]          # the forward's, (B, H, S)
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == launches + 1
    assert flash_attention_bwd.launches == bwd + 1
    _, lse_ref = attention_ref_lse(q, k, v, causal, window, cap)
    _close(lse, lse_ref, 1e-4)
    args = (q, k, v, out.detach(), do, lse)
    if dtype == torch.float32:
        args = tuple(a.double() for a in args)
    refs = attention_bwd_ref(*args, causal, window, cap)
    tol, row_tol = (2e-4, 1e-4) if dtype == torch.float32 else (3e-2, 1e-2)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype
        _close(got.float(), ref.float(), tol)
        assert _grad_row_err(got, ref) <= row_tol
    # The instance that writes lse computes the same output as the serving one.
    assert torch.equal(out.detach(), flash_attention(q, k, v, causal, window, cap))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kv,hd,window,split", [
    (1, 257, 16, 1, 256, 64, True),    # MQA at hd 256: the heads split
    (2, 200, 4, 4, 64, 0, False),      # G = 1: one group, stored in place
])
def test_flash_attention_backward_is_bit_equal_on_card(cuda_device, dtype, b,
                                                       s, h, kv, hd, window,
                                                       split):
    """Two backward calls (bf16 or fp32) on the same inputs give the same
    bits, with the head split (fp32 partials summed in group order by the
    reduce launch) and without: no atomics, no order that depends on
    timing."""
    from repro_torch.kernels.flash_attention import ops

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (ops.bwd_head_split(b, kv, s, h // kv, hd, sms) > 1) == split
    q, k, v, do = (t.to(dtype) for t in _randn(
        cuda_device, 31, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
        (b, s, h, hd)))
    lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda_device)
    out = ops._forward_cuda(q, k, v, True, window, 0.0, lse)
    first = ops.flash_attention_bwd(q, k, v, out, do, lse, True, window)
    second = ops.flash_attention_bwd(q, k, v, out, do, lse, True, window)
    for a, c in zip(first, second):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b",
                                  "granite-moe-1b-a400m", "hubert-xlarge"])
def test_train_step_gradients_on_card(cuda_device, arch):
    """A smoke config's loss and gradients through the kernels (forward and
    backward) against the plain versions on the card, fp32: every leaf
    within 1e-3 of its norm (the flash kernel's 3xTF32 products and the
    backward's fp32 sums in other orders, compounded over the layers)."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import batch_for
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import value_and_grad

    cfg = configs.smoke_config(arch)
    params = tf.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    batch = batch_for(cfg, ShapeSpec("t", 32, 4, "train"), 0, device=cuda_device)
    bwd = flash_attention_bwd.launches
    (loss, _), grads = value_and_grad(cfg, params, batch, "cuda")
    n_attn = sum(t in ("attn", "local") for t in cfg.pattern_layers)
    assert flash_attention_bwd.launches == bwd + n_attn
    (ref_loss, _), ref = value_and_grad(cfg, params, batch, "torch")
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-4)
    for (path, g), r in zip(tree_lib.leaves_with_paths(grads), tree_lib.leaves(ref)):
        assert float((g - r).norm()) <= 1e-3 * max(float(r.norm()), 1e-6), path


def test_adamw_update_is_captured_by_a_cuda_graph(cuda_device):
    """update reads nothing back to the host: it captures into a CUDA graph,
    and the replay equals the eager update on the same inputs."""
    from repro_torch import optim

    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"w": torch.randn(64, 300, device=cuda_device, generator=g),
              "n": torch.randn(300, device=cuda_device, generator=g)}
    grads = {k: torch.randn(v.shape, device=cuda_device, generator=g)
             for k, v in params.items()}
    for md in ("float32", "int8"):
        cfg = optim.AdamWConfig(lr=optim.warmup_cosine(1e-2, 2, 10), moment_dtype=md)
        state = optim.init(cfg, params)
        eager = optim.update(cfg, grads, state, params)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            optim.update(cfg, grads, state, params)          # warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = optim.update(cfg, grads, state, params)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured[0]["w"], eager[0]["w"])
        assert torch.equal(captured[0]["n"], eager[0]["n"])
        assert int(captured[1].step) == 1

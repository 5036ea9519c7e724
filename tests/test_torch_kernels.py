"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs go through the Pallas kernel (``interpret=True``, as
tests/test_kernels.py runs it on the CPU) and through the port's kernel
wrapper with ``impl='torch'`` on the CPU, at shapes whose T, C and O are
not block multiples.  Tolerance rtol = atol = 5e-4, as in
tests/test_conv_conformance.py.  The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.conv_spec import ConvAlgorithm as JConvAlgorithm
from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.core.conv_spec import Epilogue as JEpilogue
from repro.core.winograd import transform_weights as j_transform_weights
from repro.kernels.conv_ops import conv2d_pallas
from repro.kernels.gemm.kernel import matmul_pallas
from repro.kernels.im2col_gemm.kernel import conv2d_im2col_gemm_pallas
from repro.kernels.im2col_gemm.ops import pad_conv_operands
from repro.kernels.winograd.kernel import fused_winograd_pallas
from repro_torch.core.conv2d import conv2d
from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec, Epilogue
from repro_torch.kernels.conv_ops import conv2d_cuda
from repro_torch.kernels.gemm.ops import matmul_bias_act
from repro_torch.kernels.im2col_gemm.ops import im2col_conv
from repro_torch.kernels.winograd.ops import (
    fused_winograd,
    input_transform,
    output_transform,
    tuple_multiply,
)

TOL = dict(rtol=5e-4, atol=5e-4)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ceil_to(x, q):
    return -(-x // q) * q


def _pad_to(a, shape):
    return np.pad(a, [(0, s - d) for d, s in zip(a.shape, shape)])


# ---------------------------------------------------------------------------
# GEMM: matmul_pallas


@pytest.mark.parametrize("m,n,k,act", [(37, 70, 45, "leaky"),
                                       (169, 255, 40, "linear")])
def test_gemm_matches_matmul_pallas(m, n, k, act):
    rng = np.random.default_rng(0)
    a, b, bias = _np(rng, m, k), _np(rng, k, n), _np(rng, n)
    bm, bn, bk = 8, 128, 128
    mp, np_, kp = _ceil_to(m, bm), _ceil_to(n, bn), _ceil_to(k, bk)
    ref = matmul_pallas(
        jnp.asarray(_pad_to(a, (mp, kp))), jnp.asarray(_pad_to(b, (kp, np_))),
        bm, bn, bk, interpret=True,
        bias=jnp.asarray(_pad_to(bias, (np_,)))[None], activation=act,
    )
    got = matmul_bias_act(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(bias), act, impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:m, :n], **TOL)


# ---------------------------------------------------------------------------
# Implicit-GEMM conv: conv2d_im2col_gemm_pallas


@pytest.mark.parametrize("case", [
    dict(h=9, w=11, c=16, o=20, s=1, act="leaky"),
    dict(h=13, w=10, c=8, o=9, s=2, act="relu"),
])
def test_im2col_conv_matches_pallas(case):
    rng = np.random.default_rng(1)
    c, o, s = case["c"], case["o"], case["s"]
    x = _np(rng, 2, case["h"], case["w"], c)
    w, bias = _np(rng, 3, 3, c, o), _np(rng, o)
    jspec = JConvSpec(c, o, (3, 3), (s, s), (1, 1))
    oh, ow = jspec.out_hw(case["h"], case["w"])
    toh, bc, bo = 4, 8, 128
    x_p, w_p, bias_p = pad_conv_operands(
        jnp.asarray(x), jnp.asarray(w), jspec, (toh, bc, bo),
        bias=jnp.asarray(bias))
    ref = conv2d_im2col_gemm_pallas(
        x_p, w_p, s, s, oh, ow, toh, bc, bo, interpret=True, bias=bias_p,
        activation=case["act"])
    got = im2col_conv(torch.from_numpy(x), torch.from_numpy(w),
                      ConvSpec(c, o, (3, 3), (s, s), (1, 1)),
                      bias=torch.from_numpy(bias), activation=case["act"],
                      impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :oh, :, :o],
                               **TOL)


# ---------------------------------------------------------------------------
# Fused Winograd: fused_winograd_pallas


def test_fused_winograd_matches_pallas():
    rng = np.random.default_rng(2)
    t, c, o = 21, 16, 20
    tiles, w3, bias = _np(rng, t, 8, 8, c), _np(rng, 3, 3, c, o), _np(rng, o)
    u = np.asarray(j_transform_weights(jnp.asarray(w3)))
    bt, bc, bo = 8, 8, 8
    tp, op = _ceil_to(t, bt), _ceil_to(o, bo)
    ref = fused_winograd_pallas(
        jnp.asarray(_pad_to(tiles, (tp, 8, 8, c))),
        jnp.asarray(_pad_to(u, (8, 8, c, op))), bt, bc, bo, interpret=True,
        bias=jnp.asarray(_pad_to(bias, (op,)))[None], activation="leaky",
    )
    got = fused_winograd(torch.from_numpy(tiles), torch.from_numpy(u),
                         bias=torch.from_numpy(bias), activation="leaky",
                         impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:t, ..., :o],
                               **TOL)


# ---------------------------------------------------------------------------
# Kernel dispatch: conv2d_pallas (self-contained path: channel padding,
# Winograd tile extraction, the direct path's pad-before-subsample)


@pytest.mark.parametrize("algo,k,s,p,c", [
    ("WINOGRAD", 3, 1, 1, 5),
    ("IM2COL_GEMM", 3, 2, 1, 5),
    ("DIRECT", 1, 2, 1, 6),
])
def test_conv_dispatch_matches_conv2d_pallas(algo, k, s, p, c):
    rng = np.random.default_rng(3)
    o = 11
    x, w, bias = _np(rng, 2, 14, 13, c), _np(rng, k, k, c, o), _np(rng, o)
    ref = conv2d_pallas(
        jnp.asarray(x), jnp.asarray(w), JConvSpec(c, o, (k, k), (s, s), (p, p)),
        getattr(JConvAlgorithm, algo), interpret=True,
        epilogue=JEpilogue(bias=jnp.asarray(bias), activation="leaky"),
    )
    got = conv2d_cuda(
        torch.from_numpy(x), torch.from_numpy(w),
        ConvSpec(c, o, (k, k), (s, s), (p, p)), getattr(ConvAlgorithm, algo),
        epilogue=Epilogue(torch.from_numpy(bias), "leaky"), impl="torch",
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# impl='cuda' never computes on the CPU


def test_cuda_impl_refuses_cpu_tensors():
    rng = np.random.default_rng(4)
    a, b = torch.from_numpy(_np(rng, 4, 8)), torch.from_numpy(_np(rng, 8, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        matmul_bias_act(a, b, impl="cuda")
    x, w = torch.from_numpy(_np(rng, 1, 6, 6, 8)), torch.from_numpy(_np(rng, 3, 3, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        im2col_conv(x, w, ConvSpec(8, 4), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_winograd(torch.from_numpy(_np(rng, 3, 8, 8, 8)),
                       torch.from_numpy(_np(rng, 8, 8, 8, 4)), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        input_transform(torch.from_numpy(_np(rng, 3, 8, 8, 8)), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tuple_multiply(torch.from_numpy(_np(rng, 64, 3, 8)),
                       torch.from_numpy(_np(rng, 64, 8, 4)), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        output_transform(torch.from_numpy(_np(rng, 8, 8, 3, 4)),
                         torch.from_numpy(_np(rng, 4)), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv2d(x, w, ConvSpec(8, 4), impl="cuda")

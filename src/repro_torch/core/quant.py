"""Int8 inference quantization: offline scales, calibration and the
planner's policy gates.

The port of ``repro/core/quant.py`` (its own copy: the port imports
nothing of the JAX package).  Everything here runs offline, in
``compile``, except ``quantize_activation``, which runs at the entry of
every int8 layer of the forward.

Scheme (symmetric, round half to even, [-127, 127]):

  activations  per-input-channel scales sx (C,) = max|x| / 127 over
               (B, H, W) of a calibration batch, folded into the weights
               before weight quantization, so the kernel's dequant is one
               per-output-channel row.
  weights      per-output-channel scales sw (O,) of the folded weights
               w * sx[c].
  kernels      int8 x int8 products summed exactly in int32, then
               act(float(acc) * sw + bias) in fp32; activations between
               layers stay fp32.

Policy gates, which decide whether a layer quantizes:

  - traffic: the layer's int8 im2col/GEMM bytes must be at most
    ``INT8_TRAFFIC_THRESHOLD`` of its fp32 bytes (``int8_worthwhile``),
    with the reference's own ideal-reuse byte count (a cin=3 stem fails);
  - Winograd error budget: the F(6,3) input transform stretches the data
    range (``winograd_transform_amplification``), so int8 Winograd misses
    the 30 dB budget and an int8 3x3 layer runs im2col.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.smem_model import im2col_gemm_traffic_bytes

QMAX = 127.0
SCALE_FLOOR = 1e-12        # all-zero channels quantize to zeros, not NaNs
INT8_TRAFFIC_THRESHOLD = 0.5
WINOGRAD_SQNR_BUDGET_DB = 30.0


# ---------------------------------------------------------------------------
# Scales and (de)quantization


def activation_scales(x: torch.Tensor) -> torch.Tensor:
    """Per-channel symmetric scales of an NHWC activation: max|x| / 127
    over every axis but the last, floored at ``SCALE_FLOOR``; fp32 (C,)."""
    amax = torch.amax(x.float().abs(), dim=tuple(range(x.ndim - 1)))
    return torch.clamp_min(amax / QMAX, SCALE_FLOOR)


def quantize_activation(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], int8; ``scale`` is (C,).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, and the
    division is a division (not a product with the reciprocal), so the
    result equals the reference's bit for bit.  Plain torch ops: four
    elementwise launches at each int8 layer's entry.
    """
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def quantize_conv_weights(w: torch.Tensor, x_scale: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (kh, kw, C, O) fp32, x_scale (C,) -> (wq int8 (kh, kw, C, O),
    w_scale fp32 (O,)).

    The activation scales are folded in (w' = w * x_scale[c]), so the
    integer product xq * wq approximates x * w and the dequant is
    y[o] = w_scale[o] * sum xq * wq.
    """
    wf = w.float() * x_scale[None, None, :, None]
    amax = torch.amax(wf.abs(), dim=(0, 1, 2))
    w_scale = torch.clamp_min(amax / QMAX, SCALE_FLOOR)
    wq = torch.clamp(torch.round(wf / w_scale), -QMAX, QMAX).to(torch.int8)
    return wq, w_scale


def sqnr_db(ref, test) -> float:
    """Signal-to-quantization-noise ratio in dB, in float64."""
    ref = np.asarray(_numpy(ref), np.float64)
    err = np.asarray(_numpy(test), np.float64) - ref
    sig = float(np.sum(ref * ref))
    noise = float(np.sum(err * err))
    if noise == 0.0:
        return float("inf")
    return 10.0 * np.log10(max(sig, 1e-300) / noise)


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


# ---------------------------------------------------------------------------
# Offline calibration


def default_calibration_batch(h: int, w: int, in_channels: int,
                              batch: int = 2, seed: int = 0) -> np.ndarray:
    """A seeded standard-normal calibration batch (batch, h, w, C), fp32.

    Made with ``numpy.random.default_rng(seed)``: it cannot reproduce the
    reference's ``jax.random.normal(PRNGKey(seed))`` batch without JAX, so
    a compilation that needs the same scales as the reference passes an
    explicit batch to both.  Real sample inputs calibrate better.
    """
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, h, w, in_channels)).astype(np.float32)


def calibrate_activation_scales(netplan, folded_params: Sequence[Dict],
                                x) -> Dict[int, torch.Tensor]:
    """{conv step index: (C,) fp32 scales of that conv's input}.

    Walks the layer table as ``netplan.run_network`` does, on logical
    (unpadded) channels, through the plain fp32 convs of core/im2col.py,
    recording each conv input's per-channel max-abs.  Runs once, offline,
    on the device of the parameters.
    """
    from repro_torch.core.conv_spec import Epilogue
    from repro_torch.core.im2col import conv2d_direct_1x1, conv2d_im2col
    from repro_torch.core.netplan import layer_op

    device = next(p["w"].device for p in folded_params if "w" in p)
    scales: Dict[int, torch.Tensor] = {}
    outputs: List[Any] = []
    cur = torch.as_tensor(x, dtype=torch.float32, device=device)
    with torch.inference_mode():
        for s in netplan.steps:
            l = s.layer
            p = folded_params[s.index]
            if l.kind == "conv":
                scales[s.index] = activation_scales(cur)
                conv = (conv2d_direct_1x1 if s.spec.kernel_size == (1, 1)
                        else conv2d_im2col)
                cur = conv(cur, p["w"].float(), s.spec,
                           Epilogue(p["b"], l.activation))
            else:
                cur = layer_op(l, p, cur, outputs)
            outputs.append(cur)
    return scales


# ---------------------------------------------------------------------------
# Planner policies


def int8_traffic_ratio(spec, h: int, w: int, batch: int = 1) -> float:
    """int8 / fp32 bytes of this layer's im2col+GEMM."""
    oh, ow = spec.out_hw(h, w)
    args = (oh, ow, spec.in_channels, spec.out_channels, spec.kh, spec.kw)
    return (im2col_gemm_traffic_bytes(*args, batch=batch, dtype_bytes=1)
            / im2col_gemm_traffic_bytes(*args, batch=batch, dtype_bytes=4))


def int8_worthwhile(spec, h: int, w: int, batch: int = 1) -> bool:
    """The traffic gate: quantize only when int8 moves at most
    ``INT8_TRAFFIC_THRESHOLD`` of the fp32 bytes."""
    return int8_traffic_ratio(spec, h, w, batch) <= INT8_TRAFFIC_THRESHOLD


def winograd_transform_amplification() -> float:
    """Worst-case range growth of the F(6,3) input transform: the square
    of the largest absolute row sum of the port's B^T."""
    from repro_torch.core.winograd import BT

    row_sum = float(np.max(np.sum(np.abs(BT), axis=1)))
    return row_sum * row_sum


def winograd_int8_sqnr_estimate_db() -> float:
    """Estimated SQNR of an int8 F(6,3) transform stage: the uniform
    quantizer's 20*log10(127*sqrt(12)/kappa), kappa = 4, less
    20*log10 of the amplification."""
    kappa = 4.0
    base = 20.0 * np.log10(QMAX * np.sqrt(12.0) / kappa)
    return float(base - 20.0 * np.log10(winograd_transform_amplification()))


def winograd_int8_budget_ok() -> bool:
    """Whether int8 Winograd clears ``WINOGRAD_SQNR_BUDGET_DB``: False for
    F(6,3)."""
    return winograd_int8_sqnr_estimate_db() >= WINOGRAD_SQNR_BUDGET_DB

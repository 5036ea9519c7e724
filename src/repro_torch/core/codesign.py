"""The co-design cost model of a conv layer on the card, and the paper's
co-design sweeps on the card's analogues.

The port of ``repro/core/codesign.py``.  ``predict_conv_time`` sums the
model's price (core/smem_model.py) of every launch the dispatcher makes
for one conv under one algorithm: the kernel, its split-K reduce, the 3-pass
pipeline's three kernels, PyTorch's padding, tiling and untiling around a
Winograd conv, and an int8 step's entry quantization.  The planner's
``mode="model"`` picks the algorithm, the Winograd realization and, under
an int8 request, the precision of each layer by it.

The sweeps are the paper's §V/§VI study, model only (nothing here runs on
the card), on the card's analogues of its knobs:

  vector length  ->  the GEMM tile's width bn the card's kernels could take
  L2 size        ->  the shared memory a block may use (up to 227 KB)
  vector lanes   ->  the SM count
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.conv_spec import (
    ConvAlgorithm,
    ConvSpec,
    arithmetic_intensity,
    select_algorithm,
)
from repro_torch.core.smem_model import (
    BlockConfig,
    GemmEstimate,
    GemmShape,
    glue,
    predict_gemm,
    predict_im2col,
    predict_winograd,
    quantize_glue,
    winograd_glue,
)
from repro_torch.hw import H100, ChipSpec

KB = 1024

#: Shared-memory budgets a block may use, up to the card's 227 KB: the
#: paper's 1 MB .. 256 MB L2 sweep.
SMEM_BUDGETS = (16 * KB, 32 * KB, 48 * KB, 64 * KB, 100 * KB, 160 * KB,
                227 * KB)
#: GEMM tile widths: the paper's 512- to 16384-bit vectors.
BLOCK_WIDTHS = (16, 32, 64, 128, 256)
#: SM counts: the paper's vector lanes.
SM_COUNTS = (16, 33, 66, 132)
#: The tile heights and depths the width sweep tries at each width.
SWEEP_BMS = (16, 32, 64, 128, 256)
SWEEP_BKS = (8, 16, 32, 64)


def _channels(cin: int, algorithm: ConvAlgorithm, dtype: str) -> int:
    from repro_torch.kernels.conv_ops import in_channel_multiple
    from repro_torch.util import ceil_to

    return ceil_to(cin, in_channel_multiple(algorithm, dtype))


def conv_estimate(spec: ConvSpec, h: int, w: int, algorithm: ConvAlgorithm,
                  hw: ChipSpec = H100, dtype_bytes: int = 4, batch: int = 1,
                  winograd_fused: bool = True) -> GemmEstimate:
    """Every launch the dispatcher (kernels/conv_ops.py) makes for this
    conv, as the model prices it: the input channels padded to the
    kernel's multiple, the out channels as the layer has them."""
    dtype = "int8" if dtype_bytes == 1 else "float32"
    if spec.dilation != (1, 1):
        raise ValueError(f"the model prices no dilated conv ({spec}): no "
                         f"kernel of the port takes one")
    oh, ow = spec.out_hw(h, w)
    cout = spec.out_channels
    cin = _channels(spec.in_channels, algorithm, dtype)
    est = GemmEstimate(())
    if dtype == "int8":
        if algorithm is ConvAlgorithm.WINOGRAD:
            raise ValueError("the model prices no int8 Winograd: the "
                             "dispatcher has no such kernel")
        est = quantize_glue(batch * h * w * cin, hw)
    if algorithm is ConvAlgorithm.DIRECT:
        if spec.kernel_size != (1, 1):
            raise ValueError(f"direct GEMM for a {spec.kernel_size} kernel")
        (ph, pw), (sh, sw) = spec.padding, spec.stride
        hp, wp = h + 2 * ph, w + 2 * pw
        if ph or pw:
            est = est + glue(hw, dtype_bytes * batch * (h * w + hp * wp) * cin)
        if (sh, sw) != (1, 1):
            est = est + glue(hw, dtype_bytes * batch * 2 * oh * ow * cin)
        return est + predict_gemm(GemmShape(batch * oh * ow, cout, cin),
                                  hw=hw, dtype_bytes=dtype_bytes)
    if algorithm is ConvAlgorithm.WINOGRAD:
        if spec.kernel_size != (3, 3) or spec.stride != (1, 1):
            raise ValueError(f"Winograd F(6,3) for {spec}")
        tiles = batch * -(-oh // 6) * -(-ow // 6)
        return (est + winograd_glue(batch, h, w, cin, cout, spec, hw)
                + predict_winograd(tiles, cin, cout, hw=hw,
                                   fused=winograd_fused))
    if algorithm is ConvAlgorithm.IM2COL_GEMM:
        return est + predict_im2col(spec, h, w, batch, cin, cout, hw,
                                    dtype_bytes)
    raise ValueError(f"the model prices no {algorithm} conv")


def predict_conv_time(spec: ConvSpec, h: int, w: int, algorithm,
                      hw: ChipSpec = H100, dtype_bytes: int = 4,
                      batch: int = 1, winograd_fused: bool = True) -> float:
    """Modeled seconds of one conv layer run with ``algorithm`` (for
    Winograd, the realization ``winograd_fused`` names), in a replayed
    forward: the sum over every launch the dispatcher makes of
    ``launch_s`` + the kernel's fixed time + max(compute, memory) / its
    share of the roofline (``hw.kernel_fit``).
    ``dtype_bytes`` 1 prices the int8 kernels and the entry quantization.
    Raises for an algorithm the dispatcher cannot run here."""
    return conv_estimate(spec, h, w, algorithm, hw, dtype_bytes, batch,
                         winograd_fused).total_s


def cheapest_conv(spec: ConvSpec, h: int, w: int, hw: ChipSpec = H100,
                  dtype_bytes: int = 4, batch: int = 1,
                  winograd_fused: Optional[bool] = None
                  ) -> Tuple[float, ConvAlgorithm, bool]:
    """The model's cheapest way to run one conv: (seconds, algorithm,
    Winograd realization; False off Winograd).  The candidates are the
    spec's forced algorithm, or the paper's rule's and, where the rule
    says Winograd, im2col too; a Winograd candidate in each realization
    ``winograd_fused`` allows (None: both).  The first cheapest wins a
    tie.  The planner's ``mode="model"`` decides an fp32 layer by this."""
    algos = [select_algorithm(spec)]
    if (spec.algorithm is ConvAlgorithm.AUTO
            and algos[0] is ConvAlgorithm.WINOGRAD):
        algos.append(ConvAlgorithm.IM2COL_GEMM)
    realizations = ((True, False) if winograd_fused is None
                    else (winograd_fused,))
    priced = [(predict_conv_time(spec, h, w, algo, hw, dtype_bytes, batch, wf),
               algo, wf)
              for algo in algos
              for wf in (realizations if algo is ConvAlgorithm.WINOGRAD
                         else (False,))]
    return min(priced, key=lambda c: c[0])


def select_algorithm_by_cost(spec: ConvSpec, h: int, w: int,
                             hw: ChipSpec = H100, dtype_bytes: int = 4,
                             winograd_fused: Optional[bool] = True,
                             batch: int = 1) -> ConvAlgorithm:
    """The model's per-layer algorithm (beyond the paper), as
    ``cheapest_conv`` picks it: where the paper's rule says Winograd, the
    faster of im2col and the Winograd realization the planner would run
    (``winograd_fused``; None: the faster of the two); elsewhere the
    paper's rule."""
    return cheapest_conv(spec, h, w, hw, dtype_bytes, batch,
                         winograd_fused)[1]


def layer_roofline(spec: ConvSpec, h: int, w: int, hw: ChipSpec = H100,
                   dtype_bytes: int = 4, batch: int = 1) -> Dict[str, float]:
    """Table IV analogue: the im2col GEMM's arithmetic intensity against
    the card's critical intensity (the peak of the units the layer's
    kernel runs on over the HBM rate), and the share of that peak the
    model predicts for the im2col kernel at this layer."""
    m, n, k = spec.gemm_dims(h, w)
    n *= batch
    ai = arithmetic_intensity(m, n, k, dtype_bytes)
    unit = "int8" if dtype_bytes == 1 else "fp32"
    peak = hw.peak_rate(unit)
    ai_critical = peak / hw.hbm_bandwidth
    est = conv_estimate(spec, h, w, ConvAlgorithm.IM2COL_GEMM, hw,
                        dtype_bytes, batch)
    return {
        "M": m,
        "N": n,
        "K": k,
        "AI": ai,
        "ai_critical": ai_critical,
        "roofline_frac": min(1.0, ai / ai_critical),
        "pct_of_peak": 100.0 * 2.0 * m * n * k / peak / est.total_s,
    }


# ---------------------------------------------------------------------------
# The sweeps (model only)


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    smem_budget: int
    bn: int
    sms: int
    block: BlockConfig
    estimate: GemmEstimate


def _best_block(shape: GemmShape, bn: int, budget: int, sms: int,
                hw: ChipSpec, dtype_bytes: int) -> Optional[SweepPoint]:
    best = None
    for bm in SWEEP_BMS:
        for bk in SWEEP_BKS:
            cfg = BlockConfig(bm, bn, bk)
            if cfg.smem_bytes(dtype_bytes) > budget:
                continue
            est = predict_gemm(shape, cfg, hw, dtype_bytes, sms=sms, splits=1)
            if best is None or est.total_s < best.estimate.total_s:
                best = SweepPoint(budget, bn, sms, cfg, est)
    return best


def sweep_vector_length(shape: GemmShape, smem_budget: int = 100 * KB,
                        sms: Optional[int] = None,
                        widths: Sequence[int] = BLOCK_WIDTHS,
                        hw: ChipSpec = H100,
                        dtype_bytes: int = 4) -> List[SweepPoint]:
    """Fig 6 analogue: at one shared-memory budget, the best tile of each
    width (the widths with no tile under the budget left out)."""
    sms = hw.sm_count if sms is None else sms
    points = [_best_block(shape, bn, smem_budget, sms, hw, dtype_bytes)
              for bn in widths]
    return [p for p in points if p is not None]


def sweep_cache_size(shape: GemmShape,
                     budgets: Sequence[int] = SMEM_BUDGETS,
                     sms: Optional[int] = None, hw: ChipSpec = H100,
                     dtype_bytes: int = 4) -> Dict[int, List[SweepPoint]]:
    """Fig 7/8 analogue: per shared-memory budget, the best tile at each
    width."""
    return {b: sweep_vector_length(shape, b, sms, hw=hw,
                                   dtype_bytes=dtype_bytes)
            for b in budgets}


def sweep_lanes(shape: GemmShape, smem_budget: int = 100 * KB,
                sms: Sequence[int] = SM_COUNTS, hw: ChipSpec = H100,
                dtype_bytes: int = 4) -> List[SweepPoint]:
    """§VI.B.c analogue: the best tile at each SM count."""
    out = []
    for n in sms:
        pts = sweep_vector_length(shape, smem_budget, n, hw=hw,
                                  dtype_bytes=dtype_bytes)
        out.append(min(pts, key=lambda p: p.estimate.total_s))
    return out


# ---------------------------------------------------------------------------
# Candidates by label (the planner's ``ConvPlan.label``)

#: label -> (algorithm, winograd_fused, dtype_bytes)
CANDIDATES: Dict[str, Any] = {
    "direct": (ConvAlgorithm.DIRECT, False, 4),
    "im2col_gemm": (ConvAlgorithm.IM2COL_GEMM, False, 4),
    "winograd_fused": (ConvAlgorithm.WINOGRAD, True, 4),
    "winograd_3pass": (ConvAlgorithm.WINOGRAD, False, 4),
    "direct_int8": (ConvAlgorithm.DIRECT, False, 1),
    "im2col_gemm_int8": (ConvAlgorithm.IM2COL_GEMM, False, 1),
}


def candidate_estimate(spec: ConvSpec, h: int, w: int, batch: int,
                       label: str, hw: ChipSpec = H100,
                       measured_call: bool = False) -> GemmEstimate:
    """``conv_estimate`` of the candidate a plan label names.
    ``measured_call``: as measure mode's call (``planner.candidate_call``)
    runs it, which also copies the pre-transformed Winograd weights
    (``u.contiguous()`` in kernels/conv_ops.py; the forward's weights are
    contiguous already)."""
    algo, wf, dtype_bytes = CANDIDATES[label]
    est = conv_estimate(spec, h, w, algo, hw, dtype_bytes, batch, wf)
    if measured_call and algo is ConvAlgorithm.WINOGRAD:
        cin = _channels(spec.in_channels, algo, "float32")
        est = est + glue(hw, 2 * 4 * 64 * cin * spec.out_channels)
    return est


def spec_of(record: Dict[str, Any]) -> ConvSpec:
    """The ConvSpec of a ``scripts/cost_model_fit.py`` record."""
    return ConvSpec(record["in_channels"], record["out_channels"],
                    tuple(record["kernel_size"]), tuple(record["stride"]),
                    tuple(record["padding"]))

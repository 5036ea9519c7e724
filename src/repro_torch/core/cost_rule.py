"""Cost mode's selection rule: the reference planner's roofline comparison.

The port of the rule ``repro/core/planner.py``'s cost mode decides with
(``_tune_cost_model`` and ``_tune_int8``, on ``codesign.predict_conv_time``
and ``select_algorithm_by_cost``): each candidate's time is
``max(FLOPs / peak, bytes / bandwidth)`` at its operand width, with the
reference's own FLOP and byte counts (``winograd.winograd_flops``,
``smem_model.winograd_traffic_bytes``, ``im2col_gemm_traffic_bytes``).

The rule only compares such times, so only ``peak / bandwidth`` matters:
a time here is ``max(FLOPs / crossover, bytes)``, in bytes, where the
crossover is the reference planner's FLOP-per-byte ratio at the operand
width (``CROSSOVER``).  These are ratios of the reference's rule, which
decide the same splits; they are no speed of any card, and a plan made by
this rule carries no predicted time.  ``mode='model'`` prices this card.
"""
from __future__ import annotations

from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec, select_algorithm

#: FLOPs per byte at which the reference planner's rule turns from bytes
#: to FLOPs, by operand width in bytes: fp32, bf16 and fp16, int8.
FP32_CROSSOVER = 120.26862026862027
HALF_CROSSOVER = 240.53724053724054
INT8_CROSSOVER = 481.07448107448107
CROSSOVER = {4: FP32_CROSSOVER, 2: HALF_CROSSOVER, 1: INT8_CROSSOVER}


def rule_time(spec: ConvSpec, h: int, w: int, algorithm: ConvAlgorithm,
              dtype_bytes: int = 4, batch: int = 1,
              winograd_fused: bool = True) -> float:
    """One conv's time under the rule, in bytes: ``max(FLOPs / crossover,
    bytes)``.  Winograd moves the tiles, the transformed weights and the
    output, and the 3-pass realization V and M both ways too; the direct
    GEMM and im2col move the patch matrix, the weights and the output (an
    int8 output in fp32)."""
    from repro_torch.core.smem_model import (
        im2col_gemm_traffic_bytes,
        winograd_traffic_bytes,
    )
    from repro_torch.core.winograd import winograd_flops

    oh, ow = spec.out_hw(h, w)
    cin, cout = spec.in_channels, spec.out_channels
    crossover = CROSSOVER[dtype_bytes]
    if algorithm is ConvAlgorithm.WINOGRAD:
        flops = batch * winograd_flops(oh, ow, cin, cout)["winograd_flops"]
        moved = winograd_traffic_bytes(oh, ow, cin, cout, batch, dtype_bytes,
                                       fused=winograd_fused)
        return max(flops / crossover, moved)
    flops = 2.0 * batch * oh * ow * spec.kh * spec.kw * cin * cout
    moved = im2col_gemm_traffic_bytes(oh, ow, cin, cout, spec.kh, spec.kw,
                                      batch=batch, dtype_bytes=dtype_bytes)
    return max(flops / crossover, moved)


def select(spec: ConvSpec, h: int, w: int, dtype_bytes: int = 4,
           batch: int = 1, winograd_fused: bool = True) -> ConvAlgorithm:
    """The algorithm of one conv: ``spec.algorithm`` where it is set;
    otherwise the paper's rule, except that a 3x3 stride-1 conv goes to
    Winograd only where the realization that would run
    (``winograd_fused``) is cheaper than im2col."""
    base = select_algorithm(spec)
    if spec.algorithm is not ConvAlgorithm.AUTO or (
            base is not ConvAlgorithm.WINOGRAD):
        return base
    t_wino = rule_time(spec, h, w, ConvAlgorithm.WINOGRAD, dtype_bytes, batch,
                       winograd_fused)
    t_im2col = rule_time(spec, h, w, ConvAlgorithm.IM2COL_GEMM, dtype_bytes,
                         batch)
    return (ConvAlgorithm.WINOGRAD if t_wino < t_im2col
            else ConvAlgorithm.IM2COL_GEMM)


"""Per-layer convolution planner (cost mode, in memory).

The port of ``repro/core/planner.py``'s ``ConvPlan`` and ``Planner``: the
algorithm and kernel blocks of a conv layer are decided once per (layer,
input shape, batch) and reused.  This slice keeps the plans in a dict; the
reference's JSON cache and measure mode are not ported yet.

The algorithm rule stands in for the reference's roofline selection
(``select_algorithm_by_cost``) until a cost model of this card is ported:

- a 3x3 stride-1 conv goes to Winograd when it has at least
  ``WINOGRAD_MIN_TILES`` 6x6 output tiles (B * ceil(OH/6) * ceil(OW/6)),
  and to im2col otherwise;
- a 1x1 stride-1 conv goes to the direct GEMM;
- everything else goes to im2col.

An explicit ``ConvSpec.algorithm`` wins over the rule.  The rule is a
stand-in, not a cost model: its threshold was chosen so that on YOLOv3-tiny
at 416x416, batch 1, it gives the reference planner's split (Winograd on
layers 0, 2, 4, 6, im2col on 8, 10, 12, 14, 20, direct on the 1x1 convs).
Kernel blocks come from each CUDA kernel's own ``pick_blocks``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec

WINOGRAD_MIN_TILES = 64


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One resolved decision for one conv layer at one shape.

    ``kernel_blocks`` is what the kernel wrappers consume: (bm, bn, bk) for
    the direct GEMM, (toh, bc, bo) for the implicit-GEMM conv, (bt, bc, bo)
    for the fused Winograd kernel.
    """

    algorithm: ConvAlgorithm
    impl: str
    kernel_blocks: Tuple[int, int, int]
    source: str = "tile_rule"


def winograd_tiles(spec: ConvSpec, h: int, w: int, batch: int) -> int:
    """6x6 output tiles of a conv: B * ceil(OH/6) * ceil(OW/6)."""
    oh, ow = spec.out_hw(h, w)
    return batch * -(-oh // 6) * -(-ow // 6)


def select_algorithm_by_tiles(spec: ConvSpec, h: int, w: int,
                              batch: int) -> ConvAlgorithm:
    """The tile-count rule of the module docstring."""
    if spec.algorithm is not ConvAlgorithm.AUTO:
        return spec.algorithm
    if spec.kernel_size == (1, 1) and spec.stride == (1, 1):
        return ConvAlgorithm.DIRECT
    if (
        spec.kernel_size == (3, 3)
        and spec.stride == (1, 1)
        and spec.dilation == (1, 1)
        and winograd_tiles(spec, h, w, batch) >= WINOGRAD_MIN_TILES
    ):
        return ConvAlgorithm.WINOGRAD
    return ConvAlgorithm.IM2COL_GEMM


class Planner:
    """Resolves and caches ConvPlans in memory.

    ``stats`` counts ``hits`` and ``tunes`` (misses that ran the rule).
    """

    def __init__(self, impl: str = "cuda"):
        if impl not in ("cuda", "torch"):
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        self.impl = impl
        self._plans: Dict[Any, ConvPlan] = {}
        self.stats = {"hits": 0, "tunes": 0}

    def plan(self, spec: ConvSpec, h: int, w: int, batch: int = 1) -> ConvPlan:
        """The fp32 plan for one layer at one input shape; decides on the
        first miss."""
        key = (spec, h, w, batch)
        cached = self._plans.get(key)
        if cached is not None:
            self.stats["hits"] += 1
            return cached
        self.stats["tunes"] += 1
        algo = select_algorithm_by_tiles(spec, h, w, batch)
        plan = ConvPlan(algorithm=algo, impl=self.impl,
                        kernel_blocks=kernel_blocks(spec, algo, h, w, batch))
        self._plans[key] = plan
        return plan


def kernel_blocks(spec: ConvSpec, algo: ConvAlgorithm, h: int, w: int,
                  batch: int) -> Tuple[int, int, int]:
    """The kernel block tuple for one algorithm choice, from the kernel."""
    oh, ow = spec.out_hw(h, w)
    if algo is ConvAlgorithm.DIRECT:
        from repro_torch.kernels.gemm.ops import default_block

        return default_block(batch * oh * ow, spec.out_channels,
                             spec.in_channels)
    if algo is ConvAlgorithm.WINOGRAD:
        from repro_torch.kernels.winograd.ops import pick_blocks

        return pick_blocks(winograd_tiles(spec, h, w, batch),
                           spec.in_channels, spec.out_channels)
    from repro_torch.kernels.im2col_gemm.ops import pick_blocks

    return pick_blocks(oh, ow)

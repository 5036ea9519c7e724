"""Public convolution API with per-layer algorithm dispatch.

The port of ``repro/core/conv2d.py``.  Routing comes from an explicit
``ConvPlan`` (the planner's decision: algorithm, impl and kernel blocks)
or, without one, the per-call selector in core/conv_spec.py.  A planned
conv, an int8 conv, or any conv under ``impl='cuda'``, runs through the
kernel dispatch (kernels/conv_ops.py), where ``impl`` picks the
hand-written CUDA kernels or their plain versions; an unplanned fp32 conv
under ``impl='torch'`` runs the plain algorithms of core/ directly.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import (
    ConvAlgorithm,
    ConvSpec,
    Epilogue,
    select_algorithm,
)
from repro_torch.core.im2col import conv2d_direct_1x1, conv2d_im2col
from repro_torch.core.winograd import conv2d_winograd

if TYPE_CHECKING:
    from repro_torch.core.netplan import Layout
    from repro_torch.core.planner import ConvPlan


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    impl: str = "cuda",
    plan: Optional["ConvPlan"] = None,
    epilogue: Optional[Epilogue] = None,
    in_layout: Optional["Layout"] = None,
    out_layout: Optional["Layout"] = None,
    pretransformed: bool = False,
) -> torch.Tensor:
    """Convolve ``x`` (B,H,W,C) with ``w`` (kh,kw,C,O) per ``spec``.

    impl: 'cuda' (hand-written kernels; CUDA tensors only) or 'torch'
    (plain PyTorch, any device).  A ``plan`` overrides both the
    algorithm and ``impl``.  ``epilogue``
    (bias + activation) is fused into the output stage of whichever path
    runs.  ``in_layout``/``out_layout`` are the network executor's channel
    layout contract (see kernels/conv_ops.py).  ``pretransformed`` declares
    that ``w`` already carries the offline Winograd transform (8, 8, C, O);
    it is never inferred from the weight shape.
    """
    if plan is not None:
        algo = plan.algorithm
        impl = plan.impl
    else:
        algo = select_algorithm(spec)
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    if impl == "cuda" or plan is not None or in_layout is not None \
            or out_layout is not None or x.dtype == torch.int8:
        from repro_torch.kernels import conv_ops

        return conv_ops.conv2d_cuda(
            x, w, spec, algo, plan=plan, epilogue=epilogue,
            in_layout=in_layout, out_layout=out_layout,
            pretransformed=pretransformed, impl=impl,
        )
    if algo is ConvAlgorithm.DIRECT:
        return conv2d_direct_1x1(x, w, spec, epilogue=epilogue)
    if algo is ConvAlgorithm.WINOGRAD:
        return conv2d_winograd(
            x, w, spec, pretransformed=pretransformed, epilogue=epilogue,
        )
    return conv2d_im2col(x, w, spec, epilogue=epilogue)


def conv2d_reference(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """``F.conv2d`` in full fp32 with NHWC/HWIO at the interface.

    A test oracle only: no path of the port calls it.  cuDNN's TF32 is off
    inside the call, because on the card a float32 convolution otherwise
    runs in TF32 by default and keeps only about three digits.
    """
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
            stride=spec.stride, padding=spec.padding, dilation=spec.dilation,
        )
    return y.permute(0, 2, 3, 1)

"""Kernel-level conv dispatch used by core.conv2d for planned convs.

The port of ``repro/kernels/conv_ops.py``: 1x1 stride-1 -> the GEMM
kernel (direct), 3x3 stride-1 -> Winograd (the fused kernel, or the three
3-pass kernels when the plan says ``winograd_fused=False``), everything
else -> the implicit-GEMM conv kernel, each with bias + activation fused in
its output stage.  An int8 input (an int8 plan's step, quantized at entry)
runs the int8 GEMM or the int8 implicit-GEMM conv kernel, with the dequant
scale fused before the bias; int8 never runs Winograd.  A bf16 or fp16
input (a 16-bit plan's step, whose prepared weights are of its type) runs
the 16-bit kernel of the same algorithm, summed in fp32 and rounded to
that type; a 16-bit tensor never reaches an fp32 kernel.  ``impl='cuda'``
runs the hand-written kernels, ``impl='torch'`` their plain versions
through the same layouts, so the two differ only inside the kernels.

With an explicit ``Layout`` pair (core/netplan.py) the dispatcher runs the
network executor's contract: the input activation and the offline-prepared
weights/bias already carry the padded channels the kernel needs, so no
channel pad happens here.  The kernels mask out channels themselves and
emit exactly the weights' out channels: zero pad channels that the next
conv needs stay in the output, and no crop happens here either.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import ConvAlgorithm, ConvSpec, Epilogue
from repro_torch.util import HALF_DTYPES, ceil_to

if TYPE_CHECKING:
    from repro_torch.core.netplan import Layout
    from repro_torch.core.planner import ConvPlan


def in_channel_multiple(algo: ConvAlgorithm, dtype: str = "float32") -> int:
    """The input-channel multiple the algorithm's kernel takes.

    The fp32 GEMM kernel masks its K edge, so fp32 direct convs take any
    C; the Winograd and fp32 implicit-GEMM kernels reduce in steps of 8
    channels with 16-byte loads, so their C is padded to a multiple of 8.
    Both int8 kernels load 16 channels (16 bytes) at a time: each
    wrapper's own multiple.  Every 16-bit kernel copies 8 values (16
    bytes) at a time, its channel multiple.
    """
    if dtype in HALF_DTYPES:
        from repro_torch.kernels.gemm.ops import K_MULTIPLE_16

        return K_MULTIPLE_16
    if algo is ConvAlgorithm.DIRECT:
        if dtype == "int8":
            from repro_torch.kernels.gemm.ops import K_MULTIPLE_Q8

            return K_MULTIPLE_Q8
        return 1
    if dtype == "int8":
        from repro_torch.kernels.im2col_gemm.ops import BC_Q8

        return BC_Q8
    if algo is ConvAlgorithm.WINOGRAD:
        from repro_torch.kernels.winograd.ops import BC
    else:
        from repro_torch.kernels.im2col_gemm.ops import BC
    return BC


def plan_kernels(plan: "ConvPlan") -> Tuple[str, ...]:
    """The CUDA kernels one planned conv step launches, once each."""
    q8 = "_q8" if plan.dtype == "int8" else ""
    h = "_16" if plan.dtype in HALF_DTYPES else ""
    if plan.algorithm is ConvAlgorithm.DIRECT:
        return ("gemm" + q8 + h,)
    if plan.algorithm is ConvAlgorithm.WINOGRAD:
        if plan.winograd_fused:
            return ("winograd_fused" + h,)
        return ("input_transform" + h, "tuple_multiply" + h,
                "output_transform" + h)
    return ("im2col_conv" + q8 + h,)


def kernel_wrappers() -> Dict[str, Callable]:
    """Every CUDA kernel's wrapper by kernel name (the names of
    ``plan_kernels``); each counts the launches of its kernel in its
    ``launches`` attribute."""
    from repro_torch.kernels.gemm.ops import (
        matmul16_bias_act,
        matmul_bias_act,
        matmul_q8_bias_act,
    )
    from repro_torch.kernels.im2col_gemm.ops import (
        im2col_conv,
        im2col_conv16,
        im2col_conv_q8,
    )
    from repro_torch.kernels.winograd.ops import (
        fused_winograd,
        fused_winograd16,
        input_transform,
        input_transform16,
        output_transform,
        output_transform16,
        tuple_multiply,
        tuple_multiply16,
    )

    return {"gemm": matmul_bias_act, "gemm_q8": matmul_q8_bias_act,
            "im2col_conv": im2col_conv, "im2col_conv_q8": im2col_conv_q8,
            "winograd_fused": fused_winograd,
            "input_transform": input_transform,
            "tuple_multiply": tuple_multiply,
            "output_transform": output_transform,
            "gemm_16": matmul16_bias_act,
            "im2col_conv_16": im2col_conv16,
            "winograd_fused_16": fused_winograd16,
            "input_transform_16": input_transform16,
            "tuple_multiply_16": tuple_multiply16,
            "output_transform_16": output_transform16}


def conv2d_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    algo: ConvAlgorithm,
    plan: Optional["ConvPlan"] = None,
    epilogue: Optional[Epilogue] = None,
    in_layout: Optional["Layout"] = None,
    out_layout: Optional["Layout"] = None,
    pretransformed: bool = False,
    impl: str = "cuda",
) -> torch.Tensor:
    """x (B,H,W,C), w (kh,kw,C,O) [or (8,8,C,O) pretransformed] ->
    (B,OH,OW,O) through the kernels.

    Without layouts the call is self-contained: it pads the input channels
    (and the weights) to the kernel's multiple itself.  ``pretransformed``
    declares offline Winograd-transformed weights; it is an explicit
    contract, never inferred from the weight shape.
    """
    if in_layout is None and out_layout is None:
        from repro_torch.core.netplan import Layout

        c = x.shape[-1]
        dtype = str(x.dtype).split(".")[-1]
        cp = ceil_to(c, in_channel_multiple(algo, dtype))
        if cp != c:
            x = F.pad(x, (0, cp - c))
            w = F.pad(w, (0, 0, 0, cp - c))
        in_layout = Layout(c, cp - c)
    return _conv2d_cuda_laidout(x, w, spec, algo, plan, epilogue, in_layout,
                                out_layout, pretransformed, impl)


def _conv2d_cuda_laidout(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    algo: ConvAlgorithm,
    plan: Optional["ConvPlan"],
    epilogue: Optional[Epilogue],
    in_layout: Optional["Layout"],
    out_layout: Optional["Layout"],
    pretransformed: bool,
    impl: str,
) -> torch.Tensor:
    """Executor path: channels pre-padded in, out channels as the weights'.

    Contract (enforced by core/netplan): ``x``'s channel count equals
    ``in_layout.phys_c`` and is a multiple of the kernel's channel step;
    ``w``/``bias`` were padded offline to (in phys, out phys).
    """
    blocks = plan.kernel_blocks if plan is not None else None
    bias = epilogue.bias if epilogue is not None else None
    activation = epilogue.activation if epilogue is not None else "linear"
    scale = epilogue.scale if epilogue is not None else None
    if in_layout is not None:
        assert x.shape[-1] == in_layout.phys_c, (x.shape, in_layout)
    assert w.shape[2] == x.shape[-1], (w.shape, x.shape)
    if out_layout is not None:
        assert w.shape[-1] == out_layout.phys_c, (w.shape, out_layout)
    quantized = x.dtype == torch.int8
    half = str(x.dtype).split(".")[-1] in HALF_DTYPES
    if quantized:
        if algo is ConvAlgorithm.WINOGRAD:
            raise ValueError("int8 never routes to Winograd "
                             "(transform-stage error budget)")
        if scale is None:
            raise ValueError("an int8 conv needs the epilogue's dequant scale")

    if algo is ConvAlgorithm.DIRECT:
        from repro_torch.kernels.gemm.ops import (
            matmul16_bias_act,
            matmul_bias_act,
            matmul_q8_bias_act,
        )

        sh, sw = spec.stride
        ph, pw = spec.padding
        # Pad BEFORE subsampling, exactly like core.im2col.conv2d_direct_1x1.
        if ph or pw:
            x = F.pad(x, (0, 0, pw, pw, ph, ph))
        if (sh, sw) != (1, 1):
            x = x[:, ::sh, ::sw, :]
        b, oh, ow, cp = x.shape
        o = w.shape[-1]
        a, wm = x.reshape(b * oh * ow, cp), w.reshape(cp, o)
        if quantized:
            out = matmul_q8_bias_act(a.contiguous(), wm, scale, bias,
                                     activation, impl=impl)
        elif half:
            out = matmul16_bias_act(a.contiguous(), wm, bias=bias,
                                    activation=activation, impl=impl)
        else:
            out = matmul_bias_act(a, wm, bias=bias, activation=activation,
                                  impl=impl)
        return out.reshape(b, oh, ow, o)

    if algo is ConvAlgorithm.WINOGRAD:
        from repro_torch.core.winograd import (
            split_transformed,
            transform_weights,
        )
        from repro_torch.kernels.winograd.ops import conv2d_winograd_padded_call

        _, h, ww, _ = x.shape
        oh, ow = spec.out_hw(h, ww)
        ph, pw = spec.padding
        if ph or pw:
            x = F.pad(x, (0, 0, pw, pw, ph, ph))
        u = w if pretransformed else transform_weights(w.float())
        if half and not pretransformed:
            # The transform runs in fp32; the 16-bit kernels take it split.
            u = split_transformed(u, x.dtype)
        # The self-contained path (no plan) runs the fused kernel.
        return conv2d_winograd_padded_call(
            x, u.contiguous(), oh, ow, blocks, bias=bias,
            activation=activation, impl=impl,
            fused=plan.winograd_fused if plan is not None else True,
        )

    from repro_torch.kernels.im2col_gemm.ops import (
        im2col_conv,
        im2col_conv16,
        im2col_conv_q8,
    )

    if half:
        return im2col_conv16(x.contiguous(), w.contiguous(), spec, blocks,
                             bias=bias, activation=activation, impl=impl)
    if quantized:
        return im2col_conv_q8(x.contiguous(), w.contiguous(), spec, scale,
                              blocks, bias=bias, activation=activation,
                              impl=impl)
    return im2col_conv(x.contiguous(), w.contiguous(), spec, blocks,
                       bias=bias, activation=activation, impl=impl)

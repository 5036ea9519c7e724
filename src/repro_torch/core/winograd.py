"""Winograd F(6x6, 3x3) convolution in plain torch (NHWC layout).

The port of ``repro/core/winograd.py``: the standard Lavin/Cook-Toom F(6,3)
transform set with interpolation points (0, ±1, ±2, ±1/2, ∞).  Channels
stay minormost in every transform operand, and the tuple multiplication is
a batched GEMM over the 64 transform positions:
    M[p] = V[p] @ U[p],  p in 0..63,  V[p]: (tiles, Cin), U[p]: (Cin, Cout)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import ConvSpec, Epilogue, apply_epilogue

TILE = 8          # input tile
OUT_TILE = 6      # output tile of F(6,3)
R = 3             # filter size

# B^T (8x8): input transform.  V = B^T d B.
BT = np.array(
    [
        [1, 0, -21 / 4, 0, 21 / 4, 0, -1, 0],
        [0, 1, 1, -17 / 4, -17 / 4, 1, 1, 0],
        [0, -1, 1, 17 / 4, -17 / 4, -1, 1, 0],
        [0, 1 / 2, 1 / 4, -5 / 2, -5 / 4, 2, 1, 0],
        [0, -1 / 2, 1 / 4, 5 / 2, -5 / 4, -2, 1, 0],
        [0, 2, 4, -5 / 2, -5, 1 / 2, 1, 0],
        [0, -2, 4, 5 / 2, -5, -1 / 2, 1, 0],
        [0, -1, 0, 21 / 4, 0, -21 / 4, 0, 1],
    ],
    dtype=np.float64,
)

# G (8x3): weight transform.  U = G g G^T.
G = np.array(
    [
        [1, 0, 0],
        [-2 / 9, -2 / 9, -2 / 9],
        [-2 / 9, 2 / 9, -2 / 9],
        [1 / 90, 1 / 45, 2 / 45],
        [1 / 90, -1 / 45, 2 / 45],
        [32 / 45, 16 / 45, 8 / 45],
        [32 / 45, -16 / 45, 8 / 45],
        [0, 0, 1],
    ],
    dtype=np.float64,
)

# A^T (6x8): output transform.  Y = A^T M A.
AT = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 0],
        [0, 1, -1, 2, -2, 1 / 2, -1 / 2, 0],
        [0, 1, 1, 4, 4, 1 / 4, 1 / 4, 0],
        [0, 1, -1, 8, -8, 1 / 8, -1 / 8, 0],
        [0, 1, 1, 16, 16, 1 / 16, 1 / 16, 0],
        [0, 1, -1, 32, -32, 1 / 32, -1 / 32, 1],
    ],
    dtype=np.float64,
)


_CONSTS: Dict[Tuple[int, torch.dtype, torch.device], torch.Tensor] = {}


def _const(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The transform matrix ``m`` in ``like``'s dtype and on its device,
    made once per (matrix, dtype, device): a copy from pageable host memory
    synchronizes the host with the card, so no call may make one."""
    key = (id(m), like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        # A plain tensor even when first asked for under inference_mode.
        with torch.inference_mode(False):
            t = _CONSTS[key] = torch.as_tensor(m, dtype=like.dtype,
                                               device=like.device)
    return t


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """U = G w G^T per (cin, cout) pair: (3, 3, Cin, Cout) -> (8, 8, Cin, Cout).

    Done once, offline, for inference (paper §VII.A).
    """
    g = _const(G, w)
    return torch.einsum("ai,bj,ijco->abco", g, g, w)


@dataclasses.dataclass(frozen=True)
class SplitWeights:
    """Transformed Winograd weights for the 16-bit kernels.

    ``hl`` (2, 8, 8, C, O), of one 16-bit type: the hi and lo parts of
    U[p] * 2^k[p], hi = round(U * 2^k), lo = round(U * 2^k - hi), so hi +
    lo holds about 16 significant bits of U in bf16 and 22 in fp16;
    ``inv_scale`` (64,) fp32: 2^-k[p], which the kernels apply to M[p]
    (exact).  k[p] brings position p's largest |U| into [1, 2), which
    keeps fp16's lo parts out of its subnormals.  F(6,3) needs the split:
    U rounded to bf16 costs a 64-channel layer about 8 % of its largest
    output (the reference multiplies by fp32 U).  ``shape`` and ``dtype``
    are U's, so the dispatcher checks them as it checks a tensor's.
    """

    hl: torch.Tensor
    inv_scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.hl.shape[1:]

    @property
    def dtype(self) -> torch.dtype:
        return self.hl.dtype

    def contiguous(self) -> "SplitWeights":
        return SplitWeights(self.hl.contiguous(), self.inv_scale.contiguous())


def split_transformed(u: torch.Tensor, dtype: torch.dtype) -> SplitWeights:
    """fp32 U (8, 8, C, O) -> ``SplitWeights`` of ``dtype``."""
    _, e = torch.frexp(u.abs().amax(dim=(2, 3)))          # max = m 2^e
    e = e.to(torch.int32)
    scaled = torch.ldexp(u, (1 - e)[..., None, None].to(u.dtype))
    hi = scaled.to(dtype)
    lo = (scaled - hi.float()).to(dtype)
    inv = torch.ldexp(torch.ones((), dtype=torch.float32, device=u.device),
                      (e - 1).reshape(TILE * TILE).float())
    return SplitWeights(torch.stack([hi, lo]).contiguous(), inv.contiguous())


def _tile_input(x: torch.Tensor, oh: int, ow: int) -> Tuple[torch.Tensor, int, int]:
    """Pad + extract overlapping 8x8 input tiles with stride 6.

    Args:
      x: (B, H, W, C) *already padded* with the conv's own padding.
    Returns:
      tiles (B, nTH, nTW, 8, 8, C), and the tile grid (nTH, nTW).
    """
    _, h, w, _ = x.shape
    nth = -(-oh // OUT_TILE)
    ntw = -(-ow // OUT_TILE)
    need_h = nth * OUT_TILE + R - 1
    need_w = ntw * OUT_TILE + R - 1
    x = F.pad(x, (0, 0, 0, need_w - w, 0, need_h - h))
    # unfold: (B, nTH, W', C, 8) -> (B, nTH, nTW, C, 8, 8) [rows, cols]
    tiles = x.unfold(1, TILE, OUT_TILE).unfold(2, TILE, OUT_TILE)
    return tiles.permute(0, 1, 2, 4, 5, 3), nth, ntw


def input_transform(tiles: torch.Tensor) -> torch.Tensor:
    """V = B^T d B: (B, nTH, nTW, 8, 8, C) -> (8, 8, B*nTH*nTW, C)."""
    bt = _const(BT, tiles)
    b, nth, ntw = tiles.shape[:3]
    v = torch.einsum("ai,bj,Btuijc->abBtuc", bt, bt, tiles)
    return v.reshape(TILE, TILE, b * nth * ntw, tiles.shape[-1])


def tuple_multiply(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """M[a,b] = V[a,b] @ U[a,b]: (8,8,T,Cin) x (8,8,Cin,Cout) -> (8,8,T,Cout)."""
    return torch.matmul(v, u)


def output_transform(m: torch.Tensor, b: int, nth: int, ntw: int) -> torch.Tensor:
    """Y = A^T M A: (8, 8, B*nTH*nTW, Cout) -> (B, nTH*6, nTW*6, Cout)."""
    at = _const(AT, m)
    cout = m.shape[-1]
    m = m.reshape(TILE, TILE, b, nth, ntw, cout)
    y = torch.einsum("xa,yb,abBtuc->Btxuyc", at, at, m)
    return y.reshape(b, nth * OUT_TILE, ntw * OUT_TILE, cout)


def conv2d_winograd(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    pretransformed: bool = False,
    epilogue: Optional[Epilogue] = None,
) -> torch.Tensor:
    """Full Winograd F(6,3) convolution, stride 1, 3x3 kernels.

    x (B, H, W, Cin); w (3, 3, Cin, Cout) raw, or (8, 8, Cin, Cout) when
    ``pretransformed`` -> (B, OH, OW, Cout).
    """
    assert spec.kernel_size == (3, 3) and spec.stride == (1, 1), (
        "Winograd F(6,3) requires 3x3 stride-1"
    )
    bsz, h, ww, _ = x.shape
    oh, ow = spec.out_hw(h, ww)
    ph, pw = spec.padding
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    u = w if pretransformed else transform_weights(w)
    tiles, nth, ntw = _tile_input(x, oh, ow)
    v = input_transform(tiles)
    m = tuple_multiply(v, u)
    y = output_transform(m, bsz, nth, ntw)
    # bias + activation are elementwise, so applying before the crop is exact
    return apply_epilogue(y, epilogue)[:, :oh, :ow, :]


def winograd_flops(oh: int, ow: int, cin: int, cout: int) -> dict:
    """FLOP counts of F(6,3) against a direct 3x3 conv, per image: the
    paper's 2.4x source.

    Per 6x6 output tile: direct 36*9*Cin*Cout MACs; the tuple multiply
    64*Cin*Cout MACs (5.06x fewer), plus the transforms, counted as dense
    8x8 products (B^T d B: two 8x8 @ 8x8 per tile and channel; A^T M A:
    6x8 @ 8x8 + 6x8 @ 8x6 per tile and out channel).
    """
    nth, ntw = -(-oh // OUT_TILE), -(-ow // OUT_TILE)
    tiles = nth * ntw
    direct = 2 * oh * ow * 9 * cin * cout
    tuple_mult = 2 * tiles * 64 * cin * cout
    in_tf = tiles * cin * 2 * (8 * 8 * 8) * 2
    out_tf = tiles * cout * 2 * (6 * 8 * 8 + 6 * 8 * 6)
    return {
        "direct_flops": direct,
        "winograd_flops": tuple_mult + in_tf + out_tf,
        "tuple_flops": tuple_mult,
        "transform_flops": in_tf + out_tf,
        "mult_reduction": direct / tuple_mult,
    }

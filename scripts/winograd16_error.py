"""How far F(6,3) Winograd in bf16 and fp16 lands from fp32, by where it
rounds, on the CPU.

One 3x3 conv (26 x 26 input, C -> C channels, weights N(0, 1/(9 C)),
inputs N(0, 1) rounded to the 16-bit type) through the port's plain
Winograd functions, against the fp32 conv of the same rounded input:

  U rounded   the transformed weights rounded to the type, V in fp32
  V rounded   V rounded to the type, U in fp32
  both        U and V rounded
  split       what the 16-bit fused kernel computes: U as hi + lo parts
              (core/winograd.py::split_transformed) and V split the same
              way, three products a product (kernels/winograd/ref.py::
              fused_winograd16_ref)
  3-pass      what the 16-bit 3-pass pipeline computes: V and M rounded,
              as the reference stores them, U split

Each line prints the max-abs error over the largest |output|.

    PYTHONPATH=src python scripts/winograd16_error.py
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.winograd import (
    OUT_TILE,
    TILE,
    _tile_input,
    split_transformed,
    transform_weights,
)
from repro_torch.kernels.im2col_gemm.ref import im2col_conv_ref
from repro_torch.kernels.winograd.ref import (
    fused_winograd16_ref,
    input_transform16_ref,
    input_transform_ref,
    output_transform16_ref,
    output_transform_ref,
    tuple_multiply16_ref,
    tuple_multiply_ref,
)

HW = 26


def errors(dtype: torch.dtype, c: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((1, HW, HW, c)).astype(np.float32))
    w = torch.tensor((rng.standard_normal((3, 3, c, c))
                      / np.sqrt(9 * c)).astype(np.float32))
    x16 = x.to(dtype)
    y32 = im2col_conv_ref(x16.float(), w, ConvSpec(c, c))
    tiles, nth, ntw = _tile_input(F.pad(x16, (0, 0, 1, 1, 1, 1)), HW, HW)
    tiles = tiles.reshape(-1, TILE, TILE, c)
    t = tiles.shape[0]
    u = transform_weights(w)
    u64 = u.reshape(TILE * TILE, c, c)
    v32 = input_transform_ref(tiles.float()).reshape(TILE * TILE, t, c)
    v16 = v32.to(dtype).float()
    u16 = u64.to(dtype).float()
    split = split_transformed(u, dtype)

    def out(m):
        return output_transform_ref(m.reshape(TILE, TILE, t, c))

    ys = {
        "U rounded": out(tuple_multiply_ref(v32, u16)),
        "V rounded": out(tuple_multiply_ref(v16, u64)),
        "both": out(tuple_multiply_ref(v16, u16)),
        "split": fused_winograd16_ref(tiles, split.hl, split.inv_scale),
        "3-pass": output_transform16_ref(tuple_multiply16_ref(
            input_transform16_ref(tiles).reshape(TILE * TILE, t, c),
            split.hl.reshape(2, TILE * TILE, c, c),
            split.inv_scale).reshape(TILE, TILE, t, c)),
    }
    scale = float(y32.abs().max())
    res = {}
    for name, y in ys.items():
        y = y.float().reshape(1, nth, ntw, OUT_TILE, OUT_TILE, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(
            1, nth * OUT_TILE, ntw * OUT_TILE, c)[:, :HW, :HW]
        res[name] = float((y - y32).abs().max()) / scale
    return res


def main() -> None:
    for dtype in (torch.bfloat16, torch.float16):
        for c in (64, 256):
            res = errors(dtype, c)
            print(f"{str(dtype).split('.')[-1]} C={c}: " + ", ".join(
                f"{k} {v * 100:.3f} %" for k, v in res.items())
                + " of max|fp32 output|")


if __name__ == "__main__":
    main()

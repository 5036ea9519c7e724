#!/usr/bin/env python3
"""Time the fp32 flash-attention kernel (3xTF32 tensor cores) against
variants of its own source and, with ``--parent DIR``, an earlier
commit's kernel, on one NVIDIA GPU.

Each variant is a copy of ``kernels/flash_attention/csrc`` with a few
lines of ``flash_attention_fp32.cuh`` replaced, built by nvcc with the
port's flags into its own library under ``build/flash_fp32_variants/``
(``scripts/flash_bf16_variants.py``'s ``build``):

  as built          32 query rows a warp (two m16 tiles), 4 warps; K and
                    V staged as fp32 by cp.async, 32-key tiles (16 at hd
                    128); each warp splits the Q, K and V values it loads
                    from shared memory into hi and lo (split_tf32) at each
                    use; P.V summed 16 keys at a time into a zeroed
                    fragment, then added to O in fp32; two blocks an SM;
  split at staging  K and V split once a tile for the block: after the
                    tile lands, every thread splits its share of it into
                    hi and lo planes in shared memory (one more barrier a
                    tile, twice the K/V shared memory); the warps load
                    both planes and split no K or V value;
  Q in registers    each warp's Q fragments split once into hi and lo
                    registers (2 x 2 x hd / 2 registers), not read and
                    split at each tile;
  16 rows a warp    one m16 tile a warp (64 rows a block), 64-key tiles
                    (32 at hd 128);
  one accumulator   P.V summed by the tensor cores straight into O, as
                    in the first design: mma.sync truncates each sum, and
                    over a long row the error grows with its keys (its
                    error is printed, gated the same);
  three blocks an SM  __launch_bounds__ asking for 3 (at most 168
                    registers a thread: ptxas spills);
  truncated split   hi = x with its 13 low bits cleared and lo = x - hi
                    passed whole (the tensor core reads a TF32 operand's
                    top 19 bits): 1 integer instruction a value, not 4,
                    and no longer split_tf32's rounding (gated all the
                    same);
  parent            with ``--parent DIR`` (the root of a checkout of an
                    earlier commit, e.g. ``git archive`` of the parent
                    unpacked into a git-ignored directory): that tree's
                    flash_attention.cu and its headers as they are.

At Llama-3.2-1B's attention (S 4096, H 32, KV 8, hd 64, causal) and
Gemma2-27B's (S 8192, H 32, KV 16, hd 128, softcap 50, with and without
the 4096 window), every build is held against the plain version
(``attention_ref``: each element within 2e-4 of max(1, max|ref|), each
query row within 1e-4 of its norm) and timed in turns (A B C ... C B A),
each call on its own cold copy of q, k and v.  Prints the card's name and
power limit first, and ptxas' registers and spills of each fp32 kernel.
With ``--prefill``, then the Llama-3.2-1B fp32 prefill forward (full
width, S 4096, B 1, random weights from seed 0, run eagerly) with the
as-built kernel and, with ``--parent``, the parent's, in turns (A B B
A), 3 forwards each after a warm-up: ms per forward, host clock ending
in a synchronize.

    PYTHONPATH=src python scripts/flash_fp32_variants.py [--parent DIR] [--prefill]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from flash_bf16_variants import build, card_header, time_variants  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

OUT = _build.BUILD_DIR.parent / "flash_fp32_variants"
FP32 = "flash_attention_fp32.cuh"
# After tile t lands, the block splits it into K hi, K lo, V hi, V lo
# planes past the ring; the warps read hi at p and lo a plane further on.
SPLIT_PASS = """    tc::cp_async_commit();
    {  // tile t split once for the block into hi and lo planes
      const float* raw = KVs + stage * 2 * BK * LD;
      float* planes = KVs + 4 * BK * LD;
      for (int e = tid; e < 2 * BK * LD; e += C::THREADS) {
        uint32_t hi, lo;
        tc::split_tf32(raw[e], hi, lo);
        const int kv = e / (BK * LD), r = e % (BK * LD);
        planes[2 * kv * BK * LD + r] = __uint_as_float(hi);
        planes[(2 * kv + 1) * BK * LD + r] = __uint_as_float(lo);
      }
      __syncthreads();
    }

    // An m-tile"""
B_FRAG_PRE = """__device__ __forceinline__ void b_frag_pre(const float* p, int stride,
                                           int plane, uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) {
  bh[0] = __float_as_uint(p[0]);
  bh[1] = __float_as_uint(p[stride]);
  bl[0] = __float_as_uint(p[plane]);
  bl[1] = __float_as_uint(p[plane + stride]);
}

template <int HD>
__global__ void"""
VARIANTS = {
    "as built": [],
    "split at staging": [
        (FP32, "SMEM = (BQ + 4 * BK) * LD * 4;",
         "SMEM = (BQ + 8 * BK) * LD * 4;"),
        (FP32, "    tc::cp_async_commit();\n\n    // An m-tile", SPLIT_PASS),
        (FP32, "template <int HD>\n__global__ void", B_FRAG_PRE),
        (FP32, "    const float* Ks = KVs + stage * 2 * BK * LD;\n"
               "    const float* Vs = Ks + BK * LD;",
         "    const float* Ks = KVs + 4 * BK * LD;\n"
         "    const float* Vs = Ks + 2 * BK * LD;"),
        (FP32, "b_frag(kp + j * 8 * LD, 4, bh, bl);",
         "b_frag_pre(kp + j * 8 * LD, 4, BK * LD, bh, bl);"),
        (FP32, "b_frag(vp + jc * 8 * LD + d * 8, LD, bh, bl);",
         "b_frag_pre(vp + jc * 8 * LD + d * 8, LD, BK * LD, bh, bl);"),
    ],
    "Q in registers": [
        (FP32, "  const float* qw = Qs + (warp * 16 * MT + g) * LD + t4;\n",
         """  const float* qw = Qs + (warp * 16 * MT + g) * LD + t4;
  uint32_t qh[MT][KS][4], ql[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tc::split_tf32(qw[(16 * mt + (e & 1) * 8) * LD + kk * 8 + (e >> 1) * 4],
                       qh[mt][kk][e], ql[mt][kk][e]);
"""),
        (FP32, """          tc::split_tf32(qw[(16 * mt + (e & 1) * 8) * LD + kk * 8 + (e >> 1) * 4],
                         ah[mt][e], al[mt][e]);""",
         """          ah[mt][e] = qh[mt][kk][e], al[mt][e] = ql[mt][kk][e];"""),
    ],
    "16 rows a warp": [
        (FP32, "static constexpr int MT = 2;", "static constexpr int MT = 1;"),
        (FP32, "int BK = HD <= 64 ? 32 : 16;", "int BK = HD <= 64 ? 64 : 32;"),
    ],
    "one accumulator": [
        (FP32, "mma_3xtf32(part[mt], ah[jc][mt], al[jc][mt], bh, bl);",
         "mma_3xtf32(acc[mt][d], ah[jc][mt], al[jc][mt], bh, bl);"),
        (FP32, "for (int e = 0; e < 4; ++e) acc[mt][d][e] += part[mt][e];",
         "for (int e = 0; e < 4; ++e) (void)part[mt][e];"),
    ],
    "three blocks an SM": [
        (FP32, "int MIN_BLOCKS = 2;", "int MIN_BLOCKS = 3;"),
    ],
    "truncated split": [(FP32, "namespace tc = sgemm_tc;", """namespace tcv {
using namespace sgemm_tc;
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
}  // namespace tcv
namespace tc = tcv;""")],
}


def prefill_ms(fns: dict) -> None:
    """The Llama-3.2-1B fp32 prefill forward with each build's C entry in
    place of the port's library, in turns."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import transformer as tf

    cfg = configs.get_config("llama3.2-1b")
    g = torch.Generator(device="cuda").manual_seed(0)
    # chip_smoke.py's fp32 forward: the config's weights cast to fp32.
    params = tf.tree_map(lambda t: t.float(), tf.init_params(cfg, g))
    toks = torch.randint(0, cfg.vocab_size, (1, 4096), generator=g,
                         device="cuda")
    lm = repro_torch.compile(dataclasses.replace(cfg, dtype="float32"), params)
    load = _build.load
    times = {name: [] for name in fns}
    try:
        for name in [*fns, *reversed(fns)]:
            _build.load = lambda *a, fn=fns[name]: fn
            flash_ops.flash_attention.launches = 0
            lm.eager(toks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                lm.eager(toks)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / 3)
            if flash_ops.flash_attention.launches != 4 * cfg.num_layers:
                raise AssertionError(f"{name}: flash launches "
                                     f"{flash_ops.flash_attention.launches}")
    finally:
        _build.load = load
    for name, ms in times.items():
        print(f"llama3.2-1b fp32 prefill S4096 {name}: ms_per_forward "
              f"{ms[0]:.3f} {ms[1]:.3f} (in turns)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of a checkout of an earlier commit")
    ap.add_argument("--prefill", action="store_true",
                    help="then time the Llama-3.2-1B fp32 prefill forward")
    args = ap.parse_args()
    if not card_header():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(VARIANTS, OUT, args.parent, skip="bf16")
    time_variants(fns, torch.float32, 2e-4, 1e-4)
    if args.prefill:
        prefill_ms({name: fn for name, fn in fns.items()
                    if name in ("as built", "parent")})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Analytical model of the port's CUDA conv kernels on the H100.

The port of ``repro/core/vmem_model.py``.  The reference models Pallas
kernels on a TPU core: the VMEM footprint of blocks it autotunes, HBM
traffic, and a per-grid-step overhead.  The port's kernels compile their
tiles (``kernels/*/ops.py``), so nothing is autotuned here: the model takes
each kernel's compiled tile, the split-K count its wrapper will choose
(``kernels/_splitk.py``), and prices every launch that runs, reduce
kernels and PyTorch's copies around a conv included:

  grid      blocks of the launch: the tile grid times the split
  waves     ceil(grid / slots), slots = SMs x the kernel's resident blocks
            (its ``__launch_bounds__`` minimum; one for the fused Winograd
            kernel, whose 214 KB of shared memory fill an SM): a wave
            that is partly full takes as long as a full one
  compute   waves x slots x one block's work at the peak of the units it
            runs on (``ChipSpec.peak_rate``: 3xTF32, fp32 CUDA cores, s8
            tensor cores); the transforms, which stream one (tile,
            channel) pair a thread, at their total work
  memory    ideal-reuse bytes over the HBM rate: each operand read once,
            the output written once, a split's partial sums written by
            the kernel and read by its reduce
  time      ``launch_s`` (a graph node's start) + the kernel's fixed time
            + max(compute, memory) / the kernel's share of its roofline

The fixed times and shares are the card's, fit to its per-call times by
``scripts/cost_model_fit.py`` (``fit``); ``hw.H100.kernel_fit`` holds
them.
The counts that do not depend on the chip (``winograd_traffic_bytes``,
``im2col_gemm_traffic_bytes``) are the reference's, copied.

Shared memory per block (``smem_bytes``) is each kernel's own allocation,
the footprint VMEM's is in the reference; it decides the resident blocks
of the hypothetical tiles the co-design sweeps try (core/codesign.py).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.hw import H100, ChipSpec

#: The CUDA function of each kernel the model prices, as the profiler
#: names it (a substring of the name); no value holds another.
CUDA_FUNCTIONS: Dict[str, str] = {
    "gemm": "gemm_bias_act_kernel",
    "gemm_q8": "gemm_q8_bias_act_kernel",
    "im2col_conv": "im2col_conv_kernel",
    "im2col_conv_q8": "im2col_conv_q8_kernel",
    "winograd_fused": "winograd_fused_kernel",
    "input_transform": "winograd_input_transform_kernel",
    "tuple_multiply": "winograd_tuple_multiply_kernel",
    "output_transform": "winograd_output_transform_kernel",
    "gemm_reduce": "gemm_splitk_reduce_kernel",
    "gemm_q8_reduce": "gemm_q8_splitk_reduce_kernel",
    "im2col_conv_reduce": "im2col_conv_splitk_reduce_kernel",
    "im2col_conv_q8_reduce": "im2col_conv_q8_splitk_reduce_kernel",
    "gemm_16": "hgemm16_bias_act_kernel",
    "im2col_conv_16": "im2col16_conv_kernel",
    "winograd_fused_16": "winograd16_fused_kernel",
    "input_transform_16": "winograd16_input_transform_kernel",
    "tuple_multiply_16": "winograd16_tuple_multiply_kernel",
    "output_transform_16": "winograd16_output_transform_kernel",
    "winograd_fused_16_reduce": "winograd16_split_reduce_kernel",
}
#: Every kind of launch the model prices: the kernels and PyTorch's own,
#: fit apart around fp32 and int8 convs ('glue') and around 16-bit ones
#: ('glue_16'), so that neither moves the other's constants.
KERNELS: Tuple[str, ...] = (*CUDA_FUNCTIONS, "glue", "glue_16")

F32 = 4            # bytes of an fp32 (and an int32) element
HALF = 2           # bytes of a bf16 or fp16 element
#: The fp32 GEMM core's ring (csrc/sgemm_3xtf32.cuh): STAGES chunks of A
#: (BM x (BK + 4)) and B (BK x (BN + 8)).
SGEMM_STAGES = 3
#: The int8 GEMM's ring (csrc/gemm_q8.cu): STAGES stages of 128 K bytes.
Q8_STAGES, Q8_KS = 3, 128
#: The fused Winograd kernel's shared memory (csrc/winograd_fused.cu,
#: SMEM_FLOATS = 2 U stages + raw tiles + V).
FUSED_SMEM_BYTES = (2 * 64 * 8 * 32 + 16 * 8 * 72 + 64 * 200) * F32
#: The 16-bit fused Winograd kernel's shared memory
#: (csrc/winograd_fused_16.cu, SMEM_BYTES: the ring of 3 U stages, V hi
#: and lo in rows of 528 bytes a position, the tiles in rows of 288 bytes,
#: 3 mbarriers and counters, 512 bytes to align the ring).
FUSED16_SMEM_BYTES = (3 * 2 * 16 * 16 * 32 * 2 + 2 * 64 * (16 * 32 + 16)
                      + 16 * 8 * 288 + 3 * 12 + 512)
#: Resident blocks of the fused Winograd kernel on one SM: its shared
#: memory leaves room for one.
RESIDENT_BLOCKS_FUSED = 1
#: Shared memory a block the card keeps for itself beside a kernel's own.
SMEM_RESERVED_PER_BLOCK = 1024


def tuple16_smem_bytes(n: int) -> int:
    """The 16-bit tuple multiply's shared memory at item width ``n``
    (csrc/winograd_3pass_16.cu, TmTile<N>::SMEM): 2 stages of the 64 x 64
    V slab and U's hi and lo rows (64 x n each), the staging of M (two
    buffers, one at n = 128), 4 mbarriers, 1 KB to align."""
    stage = 64 * 64 * HALF + 2 * 64 * n * HALF
    return 2 * stage + (1 if n == 128 else 2) * 64 * n * HALF + 32 + 1024


def tuple16_resident(n: int, hw: ChipSpec = H100) -> int:
    """Resident blocks of the 16-bit tuple multiply at width ``n``: what
    an SM's shared memory holds (TmTile<N>::RESIDENT)."""
    return hw.smem_per_sm_bytes // (tuple16_smem_bytes(n)
                                    + SMEM_RESERVED_PER_BLOCK)


@dataclasses.dataclass(frozen=True)
class GemmShape:
    m: int
    n: int
    k: int

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """A GEMM tile (bm, bn, bk): the compiled 64 x 64 x 16 of the fp32
    GEMM, or one the sweeps try."""

    bm: int
    bn: int
    bk: int

    def smem_bytes(self, dtype_bytes: int = F32) -> int:
        """Shared memory of the fp32 GEMM core's ring at this tile, with its
        padded rows (for int8, the s8 kernel's ring of 128-byte K lines and
        its staging of B; for 2-byte types, the 16-bit GEMM's ring of
        swizzled, unpadded rows, csrc/gemm_16.cu)."""
        if dtype_bytes == 1:
            return Q8_STAGES * (self.bm + self.bn) * Q8_KS + self.bn * Q8_KS
        if dtype_bytes == 2:
            # Up to MAX_STAGES_16 chunks of A (BM x BK) and B (BK x BN),
            # unpadded (TMA's 128-byte swizzle).
            from repro_torch.kernels.gemm.ops import MAX_STAGES_16

            return MAX_STAGES_16 * (self.bm * self.bk
                                    + self.bk * self.bn) * dtype_bytes
        return SGEMM_STAGES * (self.bm * (self.bk + 4)
                               + self.bk * (self.bn + 8)) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One launch as the model prices it: ``time_s`` = ``launch_s`` + the
    kernel's fixed time + max(compute, memory) / its share."""

    kernel: str
    compute_s: float
    memory_s: float
    hbm_bytes: int
    time_s: float
    grid: int = 1
    splits: int = 1
    waves: int = 1
    smem_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class GemmEstimate:
    """The launches of one wrapper call (a kernel, its reduce, the copies
    around it)."""

    parts: Tuple[KernelCost, ...]

    @property
    def launches(self) -> int:
        return len(self.parts)

    @property
    def total_s(self) -> float:
        return sum(p.time_s for p in self.parts)

    def __add__(self, other: "GemmEstimate") -> "GemmEstimate":
        return GemmEstimate(self.parts + other.parts)


def peak_flops(hw: ChipSpec, dtype_bytes: int) -> float:
    """The peak a GEMM of this element size runs at on the port's kernels:
    fp32 as 3xTF32 on the tensor cores, bf16 and fp16 (2 bytes) at the
    dense 16-bit tensor-core rate, int8 on the s8 tensor cores."""
    return hw.peak_rate({1: "int8", 2: "bf16"}.get(dtype_bytes, "tf32x3"))


def _cost(kernel: str, hw: ChipSpec, compute_s: float, hbm_bytes: float,
          grid: int = 1, splits: int = 1, waves: int = 1,
          smem_bytes: int = 0) -> KernelCost:
    memory_s = hbm_bytes / hw.hbm_bandwidth
    fixed_s, share = hw.kernel_cost(kernel)
    return KernelCost(
        kernel=kernel, compute_s=compute_s, memory_s=memory_s,
        hbm_bytes=int(hbm_bytes),
        time_s=hw.launch_s + fixed_s + max(compute_s, memory_s) / share,
        grid=grid, splits=splits, waves=waves, smem_bytes=smem_bytes)


def _waved(block_work: float, grid: int, resident: int, peak: float,
           hw: ChipSpec, sms: Optional[int] = None) -> Tuple[float, int]:
    """(compute seconds, waves) of ``grid`` blocks of ``block_work``
    operations each, ``resident`` a SM, on ``sms`` SMs (the card's by
    default), each SM at the card's ``peak`` over its SM count."""
    sms = hw.sm_count if sms is None else sms
    waves = -(-grid // (sms * resident))
    per_slot = peak / hw.sm_count / resident
    return waves * block_work / per_slot, waves


def _reduce(kernel: str, splits: int, outputs: int, hw: ChipSpec
            ) -> List[KernelCost]:
    """The split-K reduce: reads ``splits`` partial tiles, writes one."""
    if splits <= 1:
        return []
    return [_cost(kernel, hw, 0.0, F32 * (splits + 1) * outputs)]


def predict_gemm(shape: GemmShape, block: Optional[BlockConfig] = None,
                 hw: ChipSpec = H100, dtype_bytes: int = F32,
                 sms: Optional[int] = None,
                 splits: Optional[int] = None) -> GemmEstimate:
    """One GEMM wrapper call, act(A @ B + bias): the kernel and, where it
    splits K, its reduce.  ``dtype_bytes`` 4 is the fp32 kernel (3xTF32),
    1 the int8 one (s8, fp32 out), 2 the 16-bit one (bf16 or fp16 in and
    out).

    ``block`` None, ``sms`` None and ``splits`` None price what the wrapper
    runs: its compiled tile and its split.  The sweeps pass a tile the
    card's kernels could take, its resident blocks from its shared memory,
    and ``sms`` and ``splits`` (1) as they set them.
    """
    from repro_torch.kernels.gemm import ops

    m, n, k = shape.m, shape.n, shape.k
    q8, half = dtype_bytes == 1, dtype_bytes == HALF
    name = "gemm_q8" if q8 else "gemm_16" if half else "gemm"
    most = (ops.RESIDENT_BLOCKS_Q8 if q8 else ops.RESIDENT_BLOCKS_16 if half
            else ops.RESIDENT_BLOCKS)
    if block is None:
        bm, bn, bk = (ops.tile_q8(n) + (ops.CHUNK_Q8,) if q8
                      else ops.TILE_16 if half else ops.TILE)
        resident = most
    else:
        bm, bn, bk = block.bm, block.bn, block.bk
        smem = block.smem_bytes(dtype_bytes)
        resident = max(1, min(most, hw.smem_per_sm_bytes // smem))
    if splits is None:
        splits = (ops.call_splits_q8 if q8 else ops.call_splits_16 if half
                  else ops.call_splits)(m, n, k)
    chunks = -(-k // bk)
    tiles = -(-m // bm) * -(-n // bn)
    grid = tiles * splits
    block_work = 2 * bm * bn * bk * -(-chunks // splits)
    compute_s, waves = _waved(block_work, grid, resident,
                              peak_flops(hw, dtype_bytes), hw, sms)
    # The 16-bit kernel sums a tile's splits in its cluster: no partial
    # sums through device memory and no reduce launch.
    out_bytes = (F32 * m * n * splits if splits > 1 and not half
                 else (HALF if half else F32) * m * n)
    hbm = dtype_bytes * (m * k + k * n) + out_bytes + F32 * n * (2 if q8 else 1)
    smem = (ops.gemm16_smem_bytes(k, splits) if half and block is None
            else BlockConfig(bm, bn, bk).smem_bytes(dtype_bytes))
    parts = [_cost(name, hw, compute_s, hbm, grid, splits, waves, smem)]
    if not half:
        parts += _reduce(name + "_reduce", splits, m * n, hw)
    return GemmEstimate(tuple(parts))


def winograd_traffic_bytes(
    oh: int, ow: int, cin: int, cout: int, batch: int = 1, dtype_bytes: int = 4,
    fused: bool = False,
) -> int:
    """Ideal-reuse device-memory traffic of the Winograd pipeline: the
    tile reads, the pre-transformed weights once and the output, and for
    the 3-pass realization (``fused=False``) V and M written and read back
    between its kernels.  The reference's count, copied."""
    nth, ntw = -(-oh // 6), -(-ow // 6)
    tiles = batch * nth * ntw
    x_bytes = tiles * 64 * cin            # overlapping 8x8 reads
    u_bytes = 64 * cin * cout             # pre-transformed weights, read once
    y_bytes = tiles * 36 * cout           # output write
    if fused:
        return dtype_bytes * (x_bytes + u_bytes + y_bytes)
    v_bytes = 2 * tiles * 64 * cin        # V write + read
    m_bytes = 2 * tiles * 64 * cout       # M write + read
    return dtype_bytes * (x_bytes + v_bytes + u_bytes + m_bytes + y_bytes)


def im2col_gemm_traffic_bytes(
    oh: int, ow: int, cin: int, cout: int, kh: int = 3, kw: int = 3,
    batch: int = 1, dtype_bytes: int = 4, out_dtype_bytes: Optional[int] = None,
) -> int:
    """Ideal-reuse traffic of one im2col+GEMM conv: the logical patch
    matrix and the weights at ``dtype_bytes``, the output at
    ``out_dtype_bytes`` (fp32 for int8 operands: the dequant epilogue
    writes fp32).  The reference's count, copied; the int8 traffic gate
    (core/quant.py) compares it."""
    if out_dtype_bytes is None:
        out_dtype_bytes = F32 if dtype_bytes == 1 else dtype_bytes
    rows = batch * oh * ow
    taps = kh * kw
    return (
        dtype_bytes * (rows * taps * cin + taps * cin * cout)
        + out_dtype_bytes * rows * cout
    )


def predict_im2col(spec, h: int, w: int, batch: int, cin: int, cout: int,
                   hw: ChipSpec = H100, dtype_bytes: int = F32,
                   toh: Optional[int] = None) -> GemmEstimate:
    """One implicit-GEMM conv call on ``cin`` (padded) input channels: the
    kernel at the row tile a network plan runs (``pick_blocks`` snapped
    as ``snap_row_tile`` does) and its split, and its reduce."""
    from repro_torch.kernels.im2col_gemm import ops

    q8, half = dtype_bytes == 1, dtype_bytes == HALF
    oh, ow = spec.out_hw(h, w)
    if half:
        return _predict_im2col16(spec, h, w, batch, cin, cout, hw)
    if toh is None:
        toh = ops.snap_row_tile(ops.pick_blocks(oh, ow)[0], oh)
    tow = ops.tile_width(toh, ow)
    grid0 = ops.grid_blocks(batch, oh, ow, cout, toh)
    (sh, sw), taps = spec.stride, spec.kh * spec.kw
    win_px = ((toh - 1) * sh + spec.kh) * ((tow - 1) * sw + spec.kw)
    if q8:
        splits = ops.call_splits_q8(batch, oh, ow, cin, cout, toh)
        chunk, chunks, resident = ops.CHUNK_Q8, -(-cin // ops.CHUNK_Q8), \
            ops.RESIDENT_BLOCKS_Q8
        smem = 2 * (win_px + taps * ops.BO) * ops.CHUNK_Q8
    else:
        splits = ops.call_splits(batch, oh, ow, cin, cout, toh)
        chunk, chunks, resident = ops.BC, cin // ops.BC, ops.RESIDENT_BLOCKS
        smem = 2 * (win_px * ops.BC + taps * ops.BC * ops.BO) * F32
    grid = grid0 * splits
    block_work = 2 * toh * tow * ops.BO * taps * chunk * -(-chunks // splits)
    compute_s, waves = _waved(
        block_work, grid, resident,
        hw.peak_rate("int8" if q8 else "bf16" if half else "fp32"), hw)
    outputs = batch * oh * ow * cout
    hbm = (dtype_bytes * (batch * h * w * cin + taps * cin * cout)
           + (F32 * outputs * splits if splits > 1
              else (HALF if half else F32) * outputs)
           + F32 * cout * (2 if q8 else 1))
    name = "im2col_conv_q8" if q8 else "im2col_conv"
    parts = [_cost(name, hw, compute_s, hbm, grid, splits, waves, smem)]
    parts += _reduce(name + "_reduce", splits, outputs, hw)
    return GemmEstimate(tuple(parts))


def _predict_im2col16(spec, h: int, w: int, batch: int, cin: int, cout: int,
                      hw: ChipSpec) -> GemmEstimate:
    """``predict_im2col`` of the 16-bit kernel: tiles of ``PIXELS_16``
    consecutive output pixels by ``BO_16`` out channels, chunks of
    ``CHUNK_16`` channels, its shared memory from ``conv16_geometry``; one
    launch, the splits summed in their cluster."""
    from repro_torch.kernels.im2col_gemm import ops

    oh, ow = spec.out_hw(h, w)
    (sh, sw), taps = spec.stride, spec.kh * spec.kw
    splits = ops.call_splits_16(batch, oh, ow, cin, cout)
    geom = ops.conv16_geometry(cin, cout, oh, ow, spec.kh, spec.kw,
                               sh, sw, splits)
    chunks = -(-cin // ops.CHUNK_16)
    grid = batch * geom["tiles_img"] * geom["o_blocks"] * splits
    block_work = (2 * ops.PIXELS_16 * ops.BO_16 * taps * ops.CHUNK_16
                  * -(-chunks // splits))
    compute_s, waves = _waved(block_work, grid, ops.RESIDENT_BLOCKS_16,
                              hw.peak_rate("bf16"), hw)
    hbm = (HALF * (batch * h * w * cin + taps * cin * cout
                   + batch * oh * ow * cout) + F32 * cout)
    return GemmEstimate((_cost("im2col_conv_16", hw, compute_s, hbm, grid,
                               splits, waves, geom["smem"]),))


def predict_winograd(tiles: int, cin: int, cout: int,
                     blocks: Optional[Tuple[int, int, int]] = None,
                     hw: ChipSpec = H100, dtype_bytes: int = F32,
                     fused: bool = True) -> GemmEstimate:
    """The Winograd kernels of one conv on ``tiles`` 8x8 tiles and ``cin``
    (padded) channels: the fused kernel, or the 3-pass pipeline's three
    (``blocks`` is the realization's compiled tile; only it runs).
    ``dtype_bytes`` 2 prices the 16-bit kernels: U comes as hi and lo
    parts, so the fused kernel's products are three 16-bit products each
    (V split too) and the tuple multiply's two; the fused kernel splits C
    as its wrapper does (``call_splits_16``), with its reduce, and the
    tuple multiply's persistent blocks walk 64 x N work items."""
    from repro_torch.kernels.winograd.ops import (
        FUSED_BLOCKS,
        FUSED_BLOCKS_16,
        THREE_PASS_BLOCKS,
        call_splits_16,
        three_pass_blocks_16,
    )

    half = dtype_bytes == HALF
    if dtype_bytes not in (F32, HALF):
        raise ValueError("the Winograd kernels run fp32, bf16 and fp16 only")
    if half:
        want = FUSED_BLOCKS_16 if fused else three_pass_blocks_16(cout)
        sfx, unit, elem = "_16", "bf16", HALF
    else:
        want = FUSED_BLOCKS if fused else THREE_PASS_BLOCKS
        sfx, unit, elem = "", "tf32x3", F32
    if blocks is not None and tuple(blocks) != want:
        raise ValueError(f"Winograd blocks {tuple(blocks)}: the "
                         f"{'fused' if fused else '3-pass'} kernel runs {want}")
    in_tf = 2 * (8 * 8 * 8) * 2                   # flops a tile and channel
    out_tf = 2 * (6 * 8 * 8 + 6 * 8 * 6)          # a tile and out channel
    x_bytes = elem * tiles * 64 * cin
    u_bytes = (2 if half else 1) * elem * 64 * cin * cout
    y_bytes = elem * tiles * 36 * cout + F32 * cout
    if fused:
        bt, bc, bo = want
        splits = call_splits_16(tiles, cin, cout) if half else 1
        # One split's channels: its share of the 16-bit kernel's chunks.
        chunks = -(-cin // bc)
        cin_s = bc * -(-chunks // splits) if half else cin
        grid = -(-tiles // bt) * -(-cout // bo) * splits
        waves = -(-grid // (hw.sm_count * RESIDENT_BLOCKS_FUSED))
        # One block's products (tensor cores) and transforms (CUDA cores)
        # at one SM's peak, shared by the blocks resident on it.
        block_s = hw.sm_count * RESIDENT_BLOCKS_FUSED * (
            (3 if half else 1) * 2 * bt * bo * 64 * cin_s / hw.peak_rate(unit)
            + (bt * cin_s * in_tf + bt * bo * out_tf) / hw.peak_rate("fp32"))
        smem = FUSED16_SMEM_BYTES if half else FUSED_SMEM_BYTES
        outputs = tiles * 36 * cout
        out_bytes = (F32 * outputs * splits + F32 * cout if splits > 1
                     else y_bytes)
        part = _cost("winograd_fused" + sfx, hw, waves * block_s,
                     x_bytes + u_bytes + out_bytes, grid, splits, waves, smem)
        return GemmEstimate((part,) + tuple(_reduce(
            "winograd_fused" + sfx + "_reduce", splits, outputs, hw)))
    from repro_torch.kernels.gemm.ops import RESIDENT_BLOCKS

    bt, bk, bo = want
    v_bytes, m_bytes = elem * tiles * 64 * cin, elem * tiles * 64 * cout
    if half:
        # The tuple multiply: persistent blocks over 64 x N work items,
        # both parts of U a stage.
        items = 64 * -(-tiles // bt) * -(-cout // bo)
        resident = tuple16_resident(bo, hw)
        compute_s, waves = _waved(2 * 2 * bt * bo * bk * -(-cin // bk), items,
                                  resident, hw.peak_rate(unit), hw)
        grid, smem = min(items, hw.sm_count * resident), tuple16_smem_bytes(bo)
    else:
        # The tuple multiply: 64 position GEMMs in one grid, on the GEMM's
        # core at its tile, unsplit.
        grid = 64 * -(-tiles // bt) * -(-cout // bo)
        compute_s, waves = _waved(2 * bt * bo * bk * -(-cin // bk), grid,
                                  RESIDENT_BLOCKS, hw.peak_rate(unit), hw)
        smem = BlockConfig(bt, bo, bk).smem_bytes(elem)
    parts = (
        _cost("input_transform" + sfx, hw,
              tiles * cin * in_tf / hw.peak_rate("fp32"), x_bytes + v_bytes),
        _cost("tuple_multiply" + sfx, hw, compute_s,
              v_bytes + u_bytes + m_bytes, grid, 1, waves, smem),
        _cost("output_transform" + sfx, hw,
              tiles * cout * out_tf / hw.peak_rate("fp32"), m_bytes + y_bytes),
    )
    return GemmEstimate(parts)


# ---------------------------------------------------------------------------
# PyTorch's copies around a conv


def glue(hw: ChipSpec, *byte_counts: float,
         kernel: str = "glue") -> GemmEstimate:
    """PyTorch launches of the dispatcher (padding, tiling, untiling,
    quantization), one per entry of ``byte_counts`` (bytes it moves);
    ``kernel`` 'glue_16' around a 16-bit conv."""
    return GemmEstimate(tuple(_cost(kernel, hw, 0.0, b) for b in byte_counts))


def winograd_glue(batch: int, h: int, w: int, cin: int, cout: int,
                  spec, hw: ChipSpec = H100,
                  dtype_bytes: int = F32) -> GemmEstimate:
    """The copies a Winograd conv makes around its kernels
    (kernels/winograd/ops.py), two launches to a zero pad (a fill, then
    the copy of the input into it): the conv's spatial pad, the pad to
    whole tiles, the overlapping 8x8 tiles gathered, and the 6x6 tiles
    put back in place."""
    oh, ow = spec.out_hw(h, w)
    ph, pw = spec.padding
    nth, ntw = -(-oh // 6), -(-ow // 6)
    tiles = batch * nth * ntw
    padded = batch * (h + 2 * ph) * (w + 2 * pw) * cin
    need = batch * (nth * 6 + 2) * (ntw * 6 + 2) * cin
    e = dtype_bytes
    moves = []
    if ph or pw:
        moves += [e * padded, e * 2 * batch * h * w * cin]
    moves += [e * need, e * 2 * padded,
              e * 2 * tiles * 64 * cin,               # gather the tiles
              e * 2 * tiles * 36 * cout]              # untile
    return glue(hw, *moves,
                kernel="glue_16" if dtype_bytes == HALF else "glue")


def quantize_glue(elements: int, hw: ChipSpec = H100) -> GemmEstimate:
    """An int8 step's entry quantization (``quant.quantize_activation``):
    divide, round, clamp (fp32 in and out), then the int8 cast."""
    return glue(hw, 2 * F32 * elements, 2 * F32 * elements,
                2 * F32 * elements, (F32 + 1) * elements)


# ---------------------------------------------------------------------------
# Fitting the card's constants


def raw_parts(parts: Iterable[KernelCost]) -> Dict[str, Tuple[float, int]]:
    """{kernel: (sum of max(compute, memory), launches)} of ``parts``."""
    out: Dict[str, Tuple[float, int]] = {}
    for p in parts:
        s, n = out.get(p.kernel, (0.0, 0))
        out[p.kernel] = (s + max(p.compute_s, p.memory_s), n + 1)
    return out


def kernel_samples(records: Sequence[Dict],
                   log: Callable[[str], None] = print,
                   hw: ChipSpec = H100
                   ) -> Dict[str, List[Tuple[float, int, float, str]]]:
    """{kernel: [(sum of max(compute, memory), launches, measured seconds,
    the record's name)]} of ``records``, as ``fit`` weighs them: a
    kernel's measured time is its mean duration a launch times the
    launches the model counts (the profiler may lose records; a record
    whose profile lost a kernel altogether is left out, and logged).  A
    record is priced as measure mode's call runs it (``measured_call``)."""
    from repro_torch.core.codesign import candidate_estimate, spec_of

    probe = dataclasses.replace(
        hw, launch_s=0.0, kernel_fit=tuple((k, 0.0, 1.0) for k in KERNELS))
    samples: Dict[str, List[Tuple[float, int, float, str]]] = {
        k: [] for k in KERNELS}
    for rec in records:
        est = candidate_estimate(spec_of(rec), rec["h"], rec["w"],
                                 rec["batch"], rec["candidate"], probe,
                                 measured_call=True)
        raw = raw_parts(est.parts)
        got = {k: v for k, v in rec["kernels"].items() if v[0] > 0}
        if not set(got) <= set(raw):
            raise ValueError(f"{rec['cell']} L{rec['layer']} "
                             f"{rec['candidate']}: the model launches "
                             f"{sorted(raw)}, the card {sorted(got)}")
        if set(got) != set(raw):
            log(f"fit: {rec['cell']} L{rec['layer']} {rec['candidate']} "
                f"left out: its profile lost {sorted(set(raw) - set(got))}")
            continue
        for k, (r, n) in raw.items():
            us, launches = got[k]
            samples[k].append((r, n, us / launches * n * 1e-6,
                               f"{rec['cell']} L{rec['layer']} "
                               f"{rec['candidate']}"))
    return samples


def fit(records: Sequence[Dict], log: Callable[[str], None] = print,
        hw: ChipSpec = H100) -> Dict[str, Tuple[float, float]]:
    """Each kernel's fixed seconds a launch and share of its roofline that
    best fit ``records`` (``scripts/cost_model_fit.py``: one per
    candidate, each kernel's profiled microseconds and launches a call):
    the pair that minimizes the squared log of predicted over measured
    duration.  Prints each pair with the median and the worst predicted /
    measured ratio of its kernel, and returns {kernel: (fixed s, share)}
    for each kernel ``records`` launch (``kernel_samples`` says how a
    record is weighed)."""
    import numpy as np

    samples = kernel_samples(records, log, hw)
    shares = np.exp(np.linspace(np.log(0.005), np.log(4.0), 300))
    fixed = np.arange(0.0, 20.01e-6, 0.1e-6)
    out = {}
    for k, rows in samples.items():
        if not rows:
            continue
        r, n, t = (np.array(c, dtype=float) for c in list(zip(*rows))[:3])
        pred = (n[None, None, :] * fixed[:, None, None]
                + r[None, None, :] / shares[None, :, None])
        err = np.sum(np.log(pred / t) ** 2, axis=2)
        i, j = np.unravel_index(int(np.argmin(err)), err.shape)
        out[k] = (float(fixed[i]), float(shares[j]))
        ratios = (pred[i, j] / t).tolist()
        w = max(range(len(rows)), key=lambda q: abs(math.log(ratios[q])))
        log(f"fit: {k} fixed {fixed[i] * 1e6:.1f} us share {shares[j]:.4f} "
            f"over {len(rows)} calls: predicted / measured median "
            f"{statistics.median(ratios):.3f} worst {ratios[w]:.3f} "
            f"({rows[w][3]}: {t[w] * 1e6:.2f} us)")
    return out

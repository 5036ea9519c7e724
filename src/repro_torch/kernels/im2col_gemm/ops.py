"""Wrappers of the hand-written implicit-GEMM conv kernels
(csrc/im2col_conv.cu, csrc/im2col_conv_16.cu, csrc/im2col_conv_q8.cu).

``im2col_conv`` computes act(conv(x, w) + bias) on NHWC input whose channel
count is a multiple of ``BC``; ``im2col_conv16`` the same on bf16 or fp16
input and weights whose channel count is a multiple of ``BC_16``, summed
in fp32 on the tensor cores (``wgmma``, chunks of ``CHUNK_16`` channels,
tiles of ``PIXELS_16`` consecutive output pixels) and rounded to their
type; ``im2col_conv_q8`` computes
act(float(conv(x_q, w_q)) * scale + bias) on int8 input whose channel
count is a multiple of ``BC_Q8``, with an exact int32 sum (on the int8
tensor cores, in chunks of ``CHUNK_Q8`` channels).  The conv's spatial
zero padding is applied inside the kernels, and out channels and ragged
row/column tiles are masked there, so the only layout the caller owns is
the channel multiple.  The kernels split their reduction over the
channel chunks across blocks where the grid alone would leave the card
half empty (``split_k``, each over its own kernel's resident blocks): the
fp32 and int8 kernels sum the splits in a second kernel, the 16-bit one
across a thread block cluster in the same launch.  One wrapper call is
one conv, whatever the number of CUDA kernels it launches.
``impl='cuda'`` launches the kernel on CUDA tensors and raises on anything
else; ``impl='torch'`` runs the plain version (ref.py).  ``im2col_launches``
gives the launch descriptors of one call (kernels/_launch.py) from its
shapes; each wrapper takes its split count and its output and workspace
from them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES, ConvSpec
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (
    LaunchDescriptor,
    Operand,
    Read,
    Write,
    emit,
    flat_boxes,
    k_ranges,
    kernel_wrapper,
    persistent_grid,
    reduce_launch,
)
from repro_torch.kernels._splitk import split_k, split_ranges  # noqa: F401
from repro_torch.kernels.gemm.ops import tma_rows16
from repro_torch.kernels.im2col_gemm.ref import (
    im2col_conv16_ref,
    im2col_conv_q8_ref,
    im2col_conv_ref,
)
from repro_torch.util import HALF_DTYPES

BC = 8          # in channels per reduction step: C must be a multiple
BC_16 = 8       # the 16-bit kernel's channel multiple (TMA's 16-byte strides)
CHUNK_16 = 32   # the 16-bit kernel's chunk: two k16 steps per tap (CK)
BO_16 = 64      # the 16-bit kernel's out channels per block (BN)
PIXELS_16 = 128  # the 16-bit kernel's output pixels per block (BM)
RUN_16 = 64     # ... in runs of 64 of one row where OW > PIXELS_16 (RUN)
BC_Q8 = 16      # the int8 kernel's channel multiple (16-byte copies)
CHUNK_Q8 = 32   # the int8 kernel's chunk: one m16n8k32 step per tap
BO = 64         # out channels per block
PIXELS = 64     # output pixels per block: toh * tow <= PIXELS
#: Blocks of the fp32 kernel resident on one SM (its launch bounds).
RESIDENT_BLOCKS = 2
#: Threads of the fp32 and int8 kernels' blocks, and of the 16-bit one's
#: (two consumer warpgroups and the producer warp).
THREADS = 256
THREADS_16 = 288
#: Blocks of the int8 kernel resident on one SM (its launch bounds'
#: MIN_BLOCKS).
RESIDENT_BLOCKS_Q8 = 2
#: Blocks of the 16-bit kernel resident on one SM (its launch bounds'
#: MIN_BLOCKS: its ring fills most of an SM's shared memory).
RESIDENT_BLOCKS_16 = 1
#: The most K splits of one 16-bit tile: the blocks of a portable thread
#: block cluster, which sums them (``MAX_SPLITS`` in
#: csrc/im2col_conv_16.cu).
MAX_SPLITS_16 = 8
#: The 16-bit kernel's ring: at most ``MAX_STAGES_16`` stages in
#: ``MAX_SMEM_16`` bytes of dynamic shared memory, TMA boxes of at most
#: ``MAX_BOX_16`` window columns, the fp32 partial tile's rows of
#: ``RED_LD_16`` floats.
MAX_STAGES_16 = 2
MAX_SMEM_16 = 232448
MAX_BOX_16 = 256
RED_LD_16 = 72

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
_ARGTYPES_Q8 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
_ARGTYPES_16 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_void_p]


def pick_blocks(oh: int, ow: int, dtype: str = "float32") -> Tuple[int, int, int]:
    """(toh, bc, bo) for an OH x OW output map, for the fp32 or the int8
    kernel (which differ only in bc, the channel multiple); for the 16-bit
    kernel its compiled tile (``PIXELS_16``, ``CHUNK_16``, ``BO_16``): a
    block's consecutive output pixels, channels a chunk, out channels.

    A block computes a toh x tow tile of 64 output pixels: whole rows when a
    row fits (tow = OW, toh = 64 // OW), else 8 x 8 tiles.  The input window
    a tile needs, halo included, is what the block stages in shared memory —
    ((toh-1)*sh + kh) x ((tow-1)*sw + kw) x bc values, at most 12 KB here —
    instead of the whole padded image the TPU kernel holds.
    """
    if dtype in HALF_DTYPES:
        return PIXELS_16, CHUNK_16, BO_16
    toh = min(oh, PIXELS // ow) if ow <= PIXELS else 8
    bc = BC_Q8 if dtype == "int8" else BC
    return max(toh, 1), bc, BO


def snap_row_tile(toh: int, oh: int) -> int:
    """The row tile a network plan runs (core/netplan.py): the largest
    divisor of OH no bigger than ``toh``, where it keeps at least half the
    tile (a prime OH must not explode the grid into one block per output
    row); else ``toh`` as it is, whose ragged last tile the kernel masks."""
    snapped = min(toh, oh)
    while oh % snapped:
        snapped -= 1
    return toh if snapped < min(toh, oh) / 2 else snapped


def tile_width(toh: int, ow: int) -> int:
    """Output columns per block for a row tile of ``toh`` rows."""
    return min(ow, PIXELS // toh)


def grid_blocks(batch: int, oh: int, ow: int, o: int, toh: int) -> int:
    """Blocks of one conv call (fp32 or int8) before any split: output
    tiles times 64-channel blocks times images."""
    tow = tile_width(toh, ow)
    return batch * -(-oh // toh) * -(-ow // tow) * -(-o // BO)


def call_splits(batch: int, oh: int, ow: int, c: int, o: int,
                toh: int) -> int:
    """``split_k`` for one fp32 conv call: its grid and C / BC chunks."""
    return split_k(grid_blocks(batch, oh, ow, o, toh), c // BC, RESIDENT_BLOCKS)


def pixel_tiles_16(oh: int, ow: int) -> List[Tuple[Tuple[int, int, int], ...]]:
    """The 16-bit kernel's pixel tiles of one image, each as its runs of
    one output row (row, first column, pixels): ``PIXELS_16`` consecutive
    pixels of the map in raster order where a row fits (OW <= PIXELS_16;
    the last tile ragged), else two runs of ``RUN_16`` pixels of a row (a
    warpgroup's rows each; the last run of a row ragged, the last tile's
    second run empty where the map has an odd number of runs)."""
    tiles = []
    if ow <= PIXELS_16:
        n = oh * ow
        for p0 in range(0, n, PIXELS_16):
            runs, p = [], p0
            while p < min(p0 + PIXELS_16, n):
                k = min(ow - p % ow, p0 + PIXELS_16 - p, n - p)
                runs.append((p // ow, p % ow, k))
                p += k
            tiles.append(tuple(runs))
        return tiles
    runs = [(r, c, min(RUN_16, ow - c)) for r in range(oh)
            for c in range(0, ow, RUN_16)]
    return [tuple(runs[i:i + 2]) for i in range(0, len(runs), 2)]


def conv16_geometry(c: int, o: int, oh: int, ow: int, kh: int, kw: int,
                    sh: int, sw: int, splits: int = 1) -> Dict[str, int]:
    """One 16-bit conv launch's layout, as csrc/im2col_conv_16.cu's
    ``geom_for`` computes it: the pixel tiles of an image, the window a
    stage holds (``segs`` segments of ``seg_h`` rows of ``win_w`` pixels,
    ``ncb`` TMA boxes of ``box_w`` columns a row, 64 bytes a pixel), the
    weights (taps x 32 x 64 values), the stage and the ring's stages (at
    most ``MAX_STAGES_16``, and no more than a split's chunks), the fp32
    partial tile (after the ring where blocks are persistent, splits == 1;
    over it otherwise), the dynamic shared memory; raises where one stage
    does not fit."""
    raster = ow <= PIXELS_16
    if raster:
        span = (ow - 1 + PIXELS_16 - 1) // ow + 1
        segs, seg_h, cols = 1, (span - 1) * sh + kh, (ow - 1) * sw + kw
    else:
        segs, seg_h, cols = 2, kh, (RUN_16 - 1) * sw + kw
    ncb = -(-cols // MAX_BOX_16)
    box_w = -(-(-(-cols // ncb)) // 8) * 8
    win_w = ncb * box_w
    w_bytes = kh * kw * CHUNK_16 * BO_16 * 2
    win_bytes = segs * seg_h * win_w * CHUNK_16 * 2
    stage = -(-(w_bytes + win_bytes) // 1024) * 1024
    red = PIXELS_16 * RED_LD_16 * 4
    room = (MAX_SMEM_16 - 1024 - 2 * MAX_STAGES_16 * 8
            - (red if splits == 1 else 0))
    per_split = -(-(-(-c // CHUNK_16)) // splits)
    stages = min(MAX_STAGES_16, per_split, room // stage)
    if stages < 1:
        raise ValueError(f"im2col_conv_16: a stage of {stage} bytes does not "
                         f"fit in {MAX_SMEM_16} bytes of shared memory")
    ring = stages * stage
    bar_off = ring + red if splits == 1 else max(ring, red)
    return dict(raster=int(raster), tiles_img=len(pixel_tiles_16(oh, ow)),
                o_blocks=-(-o // BO_16), segs=segs, seg_h=seg_h,
                box_w=box_w, ncb=ncb, win_w=win_w, w_bytes=w_bytes,
                stage_bytes=stage, stages=stages,
                tx_bytes=w_bytes + win_bytes,
                red_off=ring if splits == 1 else 0, bar_off=bar_off,
                smem=bar_off + 2 * MAX_STAGES_16 * 8 + 1024)


def call_splits_16(batch: int, oh: int, ow: int, c: int, o: int) -> int:
    """``split_k`` for one 16-bit conv call: its grid (pixel tiles times
    64-channel blocks times images) and ceil(C / CHUNK_16) chunks, over
    ``RESIDENT_BLOCKS_16``, at most ``MAX_SPLITS_16`` (one cluster a
    tile)."""
    grid = batch * len(pixel_tiles_16(oh, ow)) * -(-o // BO_16)
    return split_k(grid, -(-c // CHUNK_16), RESIDENT_BLOCKS_16, MAX_SPLITS_16)


def call_splits_q8(batch: int, oh: int, ow: int, c: int, o: int,
                   toh: int) -> int:
    """``split_k`` for one int8 conv call: its grid and ceil(C / CHUNK_Q8)
    chunks, over ``RESIDENT_BLOCKS_Q8``."""
    return split_k(grid_blocks(batch, oh, ow, o, toh), -(-c // CHUNK_Q8),
                   RESIDENT_BLOCKS_Q8)


def im2col_launches(batch: int, h: int, w: int, c: int, o: int,
                    spec: ConvSpec, toh: Optional[int] = None,
                    dtype: str = "float32", bias: bool = True,
                    ldw: Optional[int] = None,
                    bo: int = BO) -> List[LaunchDescriptor]:
    """The launches of one conv wrapper call on a (batch, h, w, c) input
    and (kh, kw, c, o) weights in ``dtype``: the kernel, with the split
    its wrapper takes (``call_splits``, ``call_splits_q8``,
    ``call_splits_16``), and where the fp32 or int8 kernel splits, the
    reduce after it.  ``toh``: the fp32 or int8 row tile (``pick_blocks``'s
    by default); ``ldw``: the 16-bit weights' row stride (O rounded up to
    8, as ``gemm.ops.tma_rows16`` lays them out, by default); ``bo``: the
    fp32 or int8 block's out channels, the compiled ``BO`` unless a plan
    declares another (which the wrapper refuses, and the verifier
    prices)."""
    oh, ow = spec.out_hw(h, w)
    (sh, sw), (ph, pw), (kh, kw) = spec.stride, spec.padding, spec.kernel_size
    if dtype in HALF_DTYPES:
        return [_conv16_launch(batch, h, w, c, o, oh, ow, spec, dtype, bias,
                               ldw)]
    q8 = dtype == "int8"
    toh = pick_blocks(oh, ow)[0] if toh is None else toh
    tow = tile_width(toh, ow)
    if q8:
        chunk, chunks = CHUNK_Q8, -(-c // CHUNK_Q8)
        splits = call_splits_q8(batch, oh, ow, c, o, toh)
    else:
        chunk, chunks = BC, c // BC
        splits = call_splits(batch, oh, ow, c, o, toh)
    win_px = ((toh - 1) * sh + kh) * ((tow - 1) * sw + kw)
    smem = (2 * (win_px + kh * kw * bo) * CHUNK_Q8 if q8
            else 2 * (win_px * BC + kh * kw * BC * bo) * 4)
    aux = ([Operand("scale", "in", (o,), "float32", data=False)] if q8
           else []) + ([Operand("bias", "in", (o,), "float32", data=False)]
                       if bias else [])
    operands = [Operand("x", "in", (batch, h, w, c), dtype),
                Operand("w", "in", (kh, kw, c, o), dtype)]
    if splits == 1:
        operands += aux + [Operand("out", "out", (batch, oh, ow, o),
                                   "float32")]
    else:
        operands.append(Operand("ws", "out", (splits, batch, oh, ow, o),
                                "int32" if q8 else "float32"))
    name = "im2col_conv_q8" if q8 else "im2col_conv"
    row_tiles, col_tiles = -(-oh // toh), -(-ow // tow)
    main = LaunchDescriptor(
        kernel=name, function=name + "_kernel", library=name, which=0,
        args=(batch, h, w, c, o, oh, ow, kh, kw, sh, sw, ph, pw, toh, tow,
              splits),
        dtype=dtype, operands=tuple(operands), threads=THREADS,
        grid=(row_tiles * col_tiles, -(-o // bo), batch * splits),
        tile_map=_conv_tiles, windows=_conv_windows,
        dynamic_smem_bytes=smem, stages=2, splits=splits, k_chunks=chunks,
        k_ranges=k_ranges(chunks, splits),
        sum_site="reduce" if splits > 1 else "none",
        sum_order=tuple(range(splits)) if splits > 1 else (),
        k_elems=kh * kw * c if q8 else None,
        geometry=(("oh", oh), ("ow", ow), ("o", o), ("c", c), ("toh", toh),
                  ("tow", tow), ("col_tiles", col_tiles), ("kh", kh),
                  ("kw", kw), ("sh", sh), ("sw", sw), ("ph", ph),
                  ("pw", pw), ("chunk", chunk), ("bo", bo)),
        items=row_tiles * col_tiles * -(-o // bo) * batch)
    if splits == 1:
        return [main]
    return [main, reduce_launch(main, (batch, oh, ow, o), "float32", aux)]


def _conv16_launch(batch: int, h: int, w: int, c: int, o: int, oh: int,
                   ow: int, spec: ConvSpec, dtype: str, bias: bool,
                   ldw: Optional[int]) -> LaunchDescriptor:
    (sh, sw), (ph, pw), (kh, kw) = spec.stride, spec.padding, spec.kernel_size
    splits = call_splits_16(batch, oh, ow, c, o)
    geom = conv16_geometry(c, o, oh, ow, kh, kw, sh, sw, splits)
    chunks = -(-c // CHUNK_16)
    items = batch * geom["o_blocks"] * geom["tiles_img"]
    ldw = -(-o // 8) * 8 if ldw is None else ldw
    return LaunchDescriptor(
        kernel="im2col_conv_16", function="im2col16_conv_kernel",
        library="im2col_conv_16", which=0,
        args=(batch, h, w, c, o, ldw, oh, ow, kh, kw, sh, sw, ph, pw, splits,
              _build.DTYPE16_CODES[HALF_DTYPES[dtype]]),
        dtype=dtype,
        operands=(Operand("x", "in", (batch, h, w, c), dtype, tma=True),
                  Operand("w", "in", (kh, kw, c, o), dtype,
                          (kw * c * ldw, c * ldw, ldw, 1), tma=True),
                  *([Operand("bias", "in", (o,), "float32", data=False)]
                    if bias else []),
                  Operand("out", "out", (batch, oh, ow, o), dtype)),
        threads=THREADS_16,
        grid=(persistent_grid(items, RESIDENT_BLOCKS_16) if splits == 1
              else (items * splits, 1, 1)),
        tile_map=_conv16_tiles, windows=_conv16_windows,
        cluster=(splits, 1, 1), dynamic_smem_bytes=geom["smem"],
        stages=geom["stages"], splits=splits, k_chunks=chunks,
        k_ranges=k_ranges(chunks, splits),
        sum_site="cluster" if splits > 1 else "none",
        sum_order=tuple(range(splits)) if splits > 1 else (),
        persistent=splits == 1, items=items,
        geometry=(("oh", oh), ("ow", ow), ("o", o), ("kh", kh), ("kw", kw),
                  ("sh", sh), ("sw", sw), ("ph", ph), ("pw", pw),
                  ("raster", geom["raster"]),
                  ("tiles_img", geom["tiles_img"]),
                  ("o_blocks", geom["o_blocks"]), ("seg_h", geom["seg_h"]),
                  ("win_w", geom["win_w"])))


def _conv_block(d: LaunchDescriptor, x: int, y: int, z: int):
    g = d.geom
    oh0 = (x // g["col_tiles"]) * g["toh"]
    ow0 = (x % g["col_tiles"]) * g["tow"]
    return z // d.splits, z % d.splits, oh0, ow0, y * g["bo"]


def _conv_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """A block (x, y, z) writes a toh x tow tile of output pixels (row tile
    x / col_tiles, column tile x % col_tiles) by 64 out channels (y) of
    image z / splits, or of split z % splits's slice of the workspace."""
    g = d.geom
    gx, gy, gz = d.grid
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                b, s, oh0, ow0, o0 = _conv_block(d, x, y, z)
                box = ((b, b + 1), (oh0, min(g["oh"], oh0 + g["toh"])),
                       (ow0, min(g["ow"], ow0 + g["tow"])),
                       (o0, min(g["o"], o0 + g["bo"])))
                block = x + gx * (y + gy * z)
                if d.splits == 1:
                    yield Write(block, 0, "out", box)
                else:
                    yield Write(block, s, "ws", ((s, s + 1),) + box)


def _conv_windows(d: LaunchDescriptor) -> Iterator[Read]:
    """A block stages, chunk by chunk of its split, the input window of its
    tile ((toh - 1) sh + kh rows, (tow - 1) sw + kw columns from the
    tile's top-left pixel less the padding), which the copies zero-fill
    where it leaves the image, and its chunks' weight rows for 64 out
    channels (masked at O)."""
    g = d.geom
    gx, gy, gz = d.grid
    win_h = (g["toh"] - 1) * g["sh"] + g["kh"]
    win_w = (g["tow"] - 1) * g["sw"] + g["kw"]
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                b, s, oh0, ow0, o0 = _conv_block(d, x, y, z)
                lo, hi = d.k_ranges[s]
                ch = (lo * g["chunk"], min(g["c"], hi * g["chunk"]))
                ih0, iw0 = oh0 * g["sh"] - g["ph"], ow0 * g["sw"] - g["pw"]
                block = x + gx * (y + gy * z)
                yield Read(block, "x", ((b, b + 1), (ih0, ih0 + win_h),
                                        (iw0, iw0 + win_w), ch), (1, 2))
                yield Read(block, "w", ((0, g["kh"]), (0, g["kw"]), ch,
                                        (o0, o0 + g["bo"])), (3,))


def _conv16_item(d: LaunchDescriptor, t: int):
    """Work item t's image, first out channel and pixel runs (row, first
    column, pixels), as csrc/im2col_conv_16.cu's ``tile_of`` lays them
    out: raster tiles of ``PIXELS_16`` consecutive pixels, else two runs of
    ``RUN_16`` pixels of a row (a run past the map has none)."""
    g = d.geom
    pt, rest = t % g["tiles_img"], t // g["tiles_img"]
    o0, b = (rest % g["o_blocks"]) * BO_16, rest // g["o_blocks"]
    if g["raster"]:
        return b, o0, pt * PIXELS_16, ()
    rpr = -(-g["ow"] // RUN_16)
    runs = []
    for j in range(2):
        r = 2 * pt + j
        row, c0 = r // rpr, (r % rpr) * RUN_16
        runs.append((row, c0, min(RUN_16, g["ow"] - c0)
                     if row < g["oh"] else 0))
    return b, o0, pt * PIXELS_16, tuple(runs)


def _conv16_rows(d: LaunchDescriptor, t: int, lo: int, hi: int):
    """Output boxes of rows [lo, hi) of work item t's tile."""
    g = d.geom
    b, o0, p0, runs = _conv16_item(d, t)
    oc = (o0, min(g["o"], o0 + BO_16))
    if g["raster"]:
        end = min(p0 + hi, g["oh"] * g["ow"])
        for pix in flat_boxes(p0 + lo, end, (g["oh"], g["ow"])):
            yield ((b, b + 1),) + pix + (oc,)
        return
    for j, (row, c0, n) in enumerate(runs):
        k0, k1 = max(lo, RUN_16 * j) - RUN_16 * j, min(hi, RUN_16 * (j + 1)) \
            - RUN_16 * j
        k1 = min(k1, n)
        if k0 < k1:
            yield ((b, b + 1), (row, row + 1), (c0 + k0, c0 + k1), oc)


def _conv16_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """Unsplit, the persistent scheduler: block b takes work items b,
    b + G, ... (G the grid).  Split, block b is rank b % splits of item b /
    splits's cluster and stores rows [128 r / splits, 128 (r + 1) /
    splits) of the item's sum."""
    s = d.splits
    if s == 1:
        step = d.grid[0]
        for b in range(step):
            for t in range(b, d.items, step):
                for box in _conv16_rows(d, t, 0, PIXELS_16):
                    yield Write(b, 0, "out", box)
        return
    for b in range(d.grid[0]):
        t, r = divmod(b, s)
        for box in _conv16_rows(d, t, PIXELS_16 * r // s,
                                PIXELS_16 * (r + 1) // s):
            yield Write(b, r, "out", box)


def _conv16_windows(d: LaunchDescriptor) -> Iterator[Read]:
    """The TMA boxes of a work item's window segments (from the top-left
    input pixel less the padding, ``seg_h`` rows of ``win_w`` columns) and
    of its weights, over its split's chunks of 32 channels: the copy engine
    fills what lies outside the input with zeros (the conv's padding, and
    the empty run past the map)."""
    g, s = d.geom, d.splits
    step = d.grid[0] // s
    for bl in range(d.grid[0]):
        lo, hi = d.k_ranges[bl % s]
        ch = (lo * CHUNK_16, hi * CHUNK_16)
        for t in range(bl // s, d.items, step):
            b, o0, p0, runs = _conv16_item(d, t)
            starts = ([(p0 // g["ow"], 0)] if g["raster"]
                      else [(row, c0) for row, c0, _ in runs])
            for row, c0 in starts:
                ih0 = row * g["sh"] - g["ph"]
                iw0 = c0 * g["sw"] - g["pw"]
                yield Read(bl, "x", ((b, b + 1), (ih0, ih0 + g["seg_h"]),
                                     (iw0, iw0 + g["win_w"]), ch))
            yield Read(bl, "w", ((0, g["kh"]), (0, g["kw"]), ch,
                                 (o0, o0 + BO_16)))


def _conv_geometry(what: str, x: torch.Tensor, w: torch.Tensor,
                   spec: ConvSpec, blocks: Optional[Tuple[int, int, int]],
                   bc: int, half: bool = False) -> Tuple[int, int, int]:
    """(OH, OW, toh) of one call; raises on what the kernel does not take
    (a 16-bit call's blocks must be the 16-bit kernel's compiled tile)."""
    c = x.shape[-1]
    kh, kw, wc, _ = w.shape
    if (kh, kw) != spec.kernel_size or wc != c or c % bc:
        raise ValueError(f"{what}: x {tuple(x.shape)}, w {tuple(w.shape)}"
                         f" for {spec} (C must be a multiple of {bc})")
    if spec.dilation != (1, 1):
        raise ValueError(f"{what}: dilation is not supported")
    oh, ow = spec.out_hw(x.shape[1], x.shape[2])
    if half:
        want = pick_blocks(oh, ow, "bfloat16")
        if blocks is not None and tuple(blocks) != want:
            raise ValueError(f"{what}: blocks {blocks} (kernel takes {want})")
        return oh, ow, want[0]
    toh = blocks[0] if blocks is not None else pick_blocks(oh, ow)[0]
    if (blocks is not None and tuple(blocks[1:]) != (bc, BO)) or not 1 <= toh <= PIXELS:
        raise ValueError(f"{what}: blocks {blocks} (kernel takes "
                         f"(toh <= {PIXELS}, {bc}, {BO}))")
    return oh, ow, toh


@kernel_wrapper
def im2col_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """x (B, H, W, C), w (kh, kw, C, O) -> (B, OH, OW, O); C % BC == 0.

    ``blocks`` is a (toh, bc, bo) plan tuple; only toh is free (bc and bo
    are the kernel's compiled BC and BO).  With ``split_k(...) > 1`` the
    partial sums go through a workspace of ``splits * B * OH * OW * O``
    floats from PyTorch's caching allocator.
    """
    oh, ow, toh = _conv_geometry("im2col_conv", x, w, spec, blocks, BC)
    _build.require_dtype("im2col_conv", torch.float32, x, w, bias)
    b, h, ww, c = x.shape
    kh, kw, _, o = w.shape
    descs = (im2col_launches(b, h, ww, c, o, spec, toh, "float32",
                             bias is not None) if b * oh * ow * o else [])
    if impl == "torch":
        emit(descs)
        return im2col_conv_ref(x, w, spec, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("im2col_conv", x, w, bias)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("im2col_conv: x and w must be 16-byte aligned")
    if not descs:
        return torch.empty((b, oh, ow, o), device=x.device,
                           dtype=torch.float32)
    out = descs[-1].alloc("out", x.device)
    main = descs[0]
    ws = main.alloc("ws", x.device) if main.splits > 1 else None
    fn = _build.load("im2col_conv", "repro_im2col_conv", _ARGTYPES)
    (sh, sw), (ph, pw) = spec.stride, spec.padding
    err = fn(x.data_ptr(), w.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), ws.data_ptr() if ws is not None else None,
             b, h, ww, c, o, oh, ow, kh, kw, sh, sw, ph, pw, toh,
             main.geom["tow"], ACTIVATION_CODES[activation], main.splits,
             _build.stream_handle(x))
    _build.check(err, "im2col_conv")
    im2col_conv.launches += 1
    emit(descs)
    return out


#: Kernel launches since the count was last set to 0.
im2col_conv.launches = 0


@kernel_wrapper
def im2col_conv16(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ConvSpec,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """bf16 or fp16 x (B, H, W, C), w (kh, kw, C, O) -> (B, OH, OW, O) in
    x's type = act(conv(x, w) + bias), summed in fp32 and rounded once;
    C % BC_16 == 0, ``bias`` fp32 (O,) or None.

    ``blocks`` is the plan's tuple, ``pick_blocks``'s for 16 bits
    (``PIXELS_16``, ``CHUNK_16``, ``BO_16``).  Under ``impl='cuda'`` the
    weights go through ``gemm.ops.tma_rows16`` (a copy unless they are laid
    out so already, as ``core/netplan.py`` keeps them).  One launch, split
    or not (``call_splits_16``): the splits of a tile are summed in its
    thread block cluster, with no workspace.
    """
    oh, ow, toh = _conv_geometry("im2col_conv_16", x, w, spec, blocks, BC_16,
                                 half=True)
    dtype = _build.require_16bit("im2col_conv_16", x, w)
    _build.require_dtype("im2col_conv_16", torch.float32, bias)
    name = str(dtype).split(".")[-1]
    b, h, ww, c = x.shape
    kh, kw, _, o = w.shape
    if impl == "torch":
        emit(im2col_launches(b, h, ww, c, o, spec, dtype=name,
                             bias=bias is not None) if b * oh * ow * o
             else [])
        return im2col_conv16_ref(x, w, spec, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("im2col_conv_16", x, dtype=dtype)
    _build.require_cuda_operands("im2col_conv_16", bias)
    if w.device != x.device:
        raise ValueError("im2col_conv_16: w must lie on x's card")
    w = tma_rows16(w)
    if x.data_ptr() % 16:
        raise ValueError("im2col_conv_16: x must be 16-byte aligned")
    if not b * oh * ow * o:
        return torch.empty((b, oh, ow, o), device=x.device, dtype=dtype)
    descs = im2col_launches(b, h, ww, c, o, spec, dtype=name,
                            bias=bias is not None, ldw=w.stride(2))
    (main,) = descs
    out = main.alloc("out", x.device)
    fn = _build.load("im2col_conv_16", "repro_im2col_conv16", _ARGTYPES_16)
    (sh, sw), (ph, pw) = spec.stride, spec.padding
    err = fn(x.data_ptr(), w.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), b, h, ww, c, o, w.stride(2), oh, ow, kh, kw,
             sh, sw, ph, pw, ACTIVATION_CODES[activation], main.splits,
             _build.DTYPE16_CODES[dtype], _build.stream_handle(x))
    _build.check(err, "im2col_conv_16")
    im2col_conv16.launches += 1
    emit(descs)
    return out


#: Kernel launches since the count was last set to 0.
im2col_conv16.launches = 0


@kernel_wrapper
def im2col_conv_q8(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    spec: ConvSpec,
    scale: torch.Tensor,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """int8 x_q (B, H, W, C), w_q (kh, kw, C, O) -> fp32 (B, OH, OW, O) =
    act(float(conv) * scale + bias); C % BC_Q8 == 0, ``scale`` (O,).

    ``blocks`` is a (toh, BC_Q8, BO) plan tuple.  Raises when
    K = kh * kw * C could overflow the int32 sum (K * 127^2 >= 2^31).  With
    ``call_splits_q8(...) > 1`` the int32 partial sums go through a
    workspace of ``splits * B * OH * OW * O`` int32 from PyTorch's caching
    allocator.
    """
    oh, ow, toh = _conv_geometry("im2col_conv_q8", x_q, w_q, spec, blocks,
                                 BC_Q8)
    b, h, ww, c = x_q.shape
    kh, kw, _, o = w_q.shape
    if scale.shape != (o,) or (bias is not None and bias.shape != (o,)):
        raise ValueError(f"im2col_conv_q8: scale {tuple(scale.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)} for "
                         f"{o} out channels")
    _build.require_int32_exact("im2col_conv_q8", kh * kw * c)
    descs = (im2col_launches(b, h, ww, c, o, spec, toh, "int8",
                             bias is not None) if b * oh * ow * o else [])
    if impl == "torch":
        emit(descs)
        return im2col_conv_q8_ref(x_q, w_q, spec, scale, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("im2col_conv_q8", x_q, w_q, dtype=torch.int8)
    _build.require_cuda_operands("im2col_conv_q8", scale, bias)
    if x_q.data_ptr() % 16:
        raise ValueError("im2col_conv_q8: x must be 16-byte aligned")
    if not descs:
        return torch.empty((b, oh, ow, o), device=x_q.device,
                           dtype=torch.float32)
    out = descs[-1].alloc("out", x_q.device)
    main = descs[0]
    ws = main.alloc("ws", x_q.device) if main.splits > 1 else None
    fn = _build.load("im2col_conv_q8", "repro_im2col_conv_q8", _ARGTYPES_Q8)
    (sh, sw), (ph, pw) = spec.stride, spec.padding
    err = fn(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), ws.data_ptr() if ws is not None else None,
             b, h, ww, c, o, oh, ow, kh, kw, sh, sw, ph, pw, toh,
             main.geom["tow"], ACTIVATION_CODES[activation], main.splits,
             _build.stream_handle(x_q))
    _build.check(err, "im2col_conv_q8")
    im2col_conv_q8.launches += 1
    emit(descs)
    return out


#: Kernel launches since the count was last set to 0.
im2col_conv_q8.launches = 0

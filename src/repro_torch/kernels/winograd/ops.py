"""Wrappers of the hand-written Winograd F(6,3) kernels, and the conv
around them.

Pipeline (paper §IV.B): tile -> input transform -> tuple multiply ->
output transform (+ bias, activation) -> untile, in one of two
realizations: the fused kernel (csrc/winograd_fused.cu: V and M never
leave the chip) or the 3-pass pipeline (csrc/winograd_3pass.cu: one kernel
per stage, V and M through device memory).  bf16 and fp16 operands run
their own kernels (csrc/winograd_fused_16.cu, csrc/winograd_3pass_16.cu:
the transforms in fp32, the products on the 16-bit tensor cores), through
the wrappers whose names end in 16; each wrapper takes its own operand
types and raises on any other.  The overlapping 8x8 tile
extraction and the untiling stay plain torch data movement here, as in the
reference (``repro/kernels/winograd/ops.py``); the offline weight
transform is ``core/winograd.transform_weights``.  ``impl='cuda'``
launches the kernels on CUDA tensors and raises on anything else;
``impl='torch'`` runs the plain versions (ref.py).  ``winograd_launches``
gives the launch descriptors of one conv's kernels (kernels/_launch.py)
from its shapes; each wrapper takes its split count and its outputs from
them.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.core.conv_spec import ACTIVATION_CODES
from repro_torch.core.winograd import OUT_TILE, TILE, SplitWeights, _tile_input
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (
    LaunchDescriptor,
    Operand,
    Read,
    Write,
    emit,
    flat_boxes,
    kernel_wrapper,
    persistent_grid,
    reduce_launch,
    k_ranges,
)
from repro_torch.kernels._splitk import split_k
from repro_torch.kernels.winograd.ref import (
    fused_winograd16_ref,
    fused_winograd_ref,
    input_transform16_ref,
    input_transform_ref,
    output_transform16_ref,
    output_transform_ref,
    tuple_multiply16_ref,
    tuple_multiply_ref,
)
from repro_torch.util import HALF_DTYPES

BC = 8            # fused kernel: in channels per reduction step (C % BC == 0)
#: The fused kernel's compiled tile (bt, bc, bo): 16 tiles x 32 out
#: channels per block (512 threads, one (tile, out channel) pair each in
#: the output transform), in-channel steps of 8.
FUSED_BLOCKS: Tuple[int, int, int] = (16, BC, 32)
#: The 3-pass tuple multiply's compiled tile (bt, bc, bo): 64 tiles x 64
#: out channels per block, in-channel steps of 16.
THREE_PASS_BLOCKS: Tuple[int, int, int] = (64, 16, 64)
#: The 16-bit kernels' channel multiple (16-byte copies of 8 values).
BC_16 = 8
#: The 16-bit fused kernel's compiled tile: 16 tiles x 32 out channels per
#: block, in-channel steps of 16 (one m16n8k16 step).
FUSED_BLOCKS_16: Tuple[int, int, int] = (16, 16, 32)
#: Resident blocks of the 16-bit fused kernel on one SM (its 199,728 bytes
#: of shared memory leave room for one): what its split rule counts.
RESIDENT_BLOCKS_FUSED_16 = 1
#: The 16-bit tuple multiply's work item: 64 tiles x N out channels, in
#: stages of 64 channels (csrc/winograd_3pass_16.cu, wgmma m64nNk16); N is
#: the first of these that holds all of O, else the last.
TUPLE_WIDTHS_16: Tuple[int, ...] = (64, 128, 256)

#: The fused kernel's threads and its shared memory (csrc/winograd_fused.cu,
#: SMEM_FLOATS: 2 stages of U, 64 positions x 8 channels x 32 out channels
#: each, the raw tiles, 16 x 8 rows of 72 floats, and V, 64 positions of
#: 200 floats).
FUSED_THREADS = 512
FUSED_SMEM_BYTES = (2 * 64 * 8 * 32 + 16 * 8 * 72 + 64 * 200) * 4
#: The 16-bit fused kernel's shared memory (csrc/winograd_fused_16.cu,
#: SMEM_BYTES): 3 stages of U's hi and lo parts (16 positions x 16
#: channels x 32 out channels of 2 bytes each), V's hi and lo parts (64
#: positions of 16 x 32 + 16 bytes), the tiles (16 x 8 rows of 288
#: bytes), 3 mbarriers and counters, 512 bytes to align the ring.
FUSED_STAGES_16 = 3
FUSED_SMEM_BYTES_16 = (FUSED_STAGES_16 * 2 * 16 * 16 * 32 * 2
                       + 2 * 64 * (16 * 32 + 16) + 16 * 8 * 288
                       + FUSED_STAGES_16 * 12 + 512)
#: Threads of a transform's block: a (tile, channel) pair each.
TRANSFORM_THREADS = 256
#: The 16-bit tuple multiply's threads (a consumer warpgroup and the
#: producer warp) and ring stages.
TUPLE_THREADS_16 = 160
TUPLE_STAGES_16 = 2

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
_INPUT_ARGTYPES = [_P, _P, _I, _I, _P]
_TUPLE_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]
_OUTPUT_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]
_ARGTYPES_16 = [_P] * 6 + [_I] * 8 + [_P]
_INPUT_ARGTYPES_16 = [_P, _P, _I, _I, _I, _P]
_TUPLE_ARGTYPES_16 = [_P] * 4 + [_I] * 4 + [_P]
_OUTPUT_ARGTYPES_16 = [_P, _P, _P, _I, _I, _I, _I, _P]


def three_pass_blocks_16(o: int) -> Tuple[int, int, int]:
    """The 16-bit tuple multiply's tile (bt, bc, bo) for O out channels:
    64 tiles, 64-channel stages, the width of ``TUPLE_WIDTHS_16`` that
    holds all of O (the widest past it)."""
    n = next((w for w in TUPLE_WIDTHS_16 if o <= w), TUPLE_WIDTHS_16[-1])
    return (64, 64, n)


def pick_blocks(t: int, c: int, o: int, fused: bool = True,
                dtype: str = "float32") -> Tuple[int, int, int]:
    """(bt, bc, bo) for T tiles and C -> O channels, for the realization
    that runs in ``dtype``: each kernel's compiled tile (in bf16 and fp16
    ``FUSED_BLOCKS_16``, and the tuple multiply's ``three_pass_blocks_16``,
    whose width follows O).

    Fused: ``FUSED_BLOCKS``; the block keeps the 64 positions' M of its
    16 x 32 (tile, out channel) pairs as tensor-core accumulators and
    stages each chunk of U once for its 16 tiles.  3-pass: the tuple
    multiply's tile, ``THREE_PASS_BLOCKS``; the two transforms take one
    (tile, channel) pair per thread and no block.
    """
    if dtype in HALF_DTYPES:
        return FUSED_BLOCKS_16 if fused else three_pass_blocks_16(o)
    return FUSED_BLOCKS if fused else THREE_PASS_BLOCKS


def call_splits_16(t: int, c: int, o: int) -> int:
    """How many ranges of its 16-channel chunks the 16-bit fused kernel
    cuts C into for T tiles and C -> O channels (C the padded count):
    ``kernels/_splitk.py::split_k`` over its grid of ceil(T / 16) x
    ceil(O / 32) blocks, one resident a SM.  1 where the grid fills the
    card; each split is a block of its own over its chunks, and the
    partial outputs are summed in split order by the reduce kernel."""
    bt, bc, bo = FUSED_BLOCKS_16
    return split_k(-(-t // bt) * -(-o // bo), -(-c // bc),
                   RESIDENT_BLOCKS_FUSED_16)


def tuple16_smem_bytes(n: int) -> int:
    """The 16-bit tuple multiply's shared memory at item width ``n``
    (TmTile<N>::SMEM): 2 stages of the 64 x 64 V slab and U's hi and lo
    64 x n, M staged in two buffers (one at n = 128), 2 mbarriers a stage,
    1 KB to align."""
    stage = 64 * 64 * 2 + 2 * 64 * n * 2
    return (TUPLE_STAGES_16 * stage + (1 if n == 128 else 2) * 64 * n * 2
            + 2 * TUPLE_STAGES_16 * 8 + 1024)


def tuple16_resident(n: int) -> int:
    """Blocks of the 16-bit tuple multiply a SM at width ``n``
    (TmTile<N>::RESIDENT: what 228 KB hold, 1 KB a block kept by the
    card), the persistent grid's multiple."""
    return 233472 // (tuple16_smem_bytes(n) + 1024)


def winograd_launches(t: int, c: int, o: int, dtype: str = "float32",
                      fused: bool = True, bias: bool = True
                      ) -> List[LaunchDescriptor]:
    """The launches of one Winograd conv's kernels on ``t`` tiles and
    C -> O channels in ``dtype``: the fused kernel (and in 16 bits, where
    it splits C (``call_splits_16``), its reduce), or the 3-pass
    pipeline's three kernels."""
    half = dtype in HALF_DTYPES
    if fused:
        return _fused16_launches(t, c, o, dtype, bias) if half else \
            [_fused_launch(t, c, o, bias)]
    return _three_pass_launches(t, c, o, dtype, bias)


def _bias(o: int, bias: bool) -> List[Operand]:
    return [Operand("bias", "in", (o,), "float32", data=False)] if bias else []


def _fused_launch(t: int, c: int, o: int, bias: bool) -> LaunchDescriptor:
    bt, bc, bo = FUSED_BLOCKS
    return LaunchDescriptor(
        kernel="winograd_fused", function="winograd_fused_kernel",
        library="winograd_fused", which=0, args=(t, c, o), dtype="float32",
        operands=(Operand("tiles", "in", (t, TILE, TILE, c), "float32"),
                  Operand("u", "in", (TILE, TILE, c, o), "float32"),
                  *_bias(o, bias),
                  Operand("out", "out", (t, OUT_TILE, OUT_TILE, o),
                          "float32")),
        threads=FUSED_THREADS, grid=(-(-t // bt), -(-o // bo), 1),
        tile_map=_fused_tiles, windows=_fused_windows,
        dynamic_smem_bytes=FUSED_SMEM_BYTES, stages=2, k_chunks=c // bc,
        k_ranges=((0, c // bc),),
        geometry=(("t", t), ("c", c), ("o", o), ("bt", bt), ("bo", bo)),
        items=-(-t // bt) * -(-o // bo))


def _fused16_launches(t: int, c: int, o: int, dtype: str,
                      bias: bool) -> List[LaunchDescriptor]:
    bt, bc, bo = FUSED_BLOCKS_16
    splits = call_splits_16(t, c, o)
    chunks = -(-c // bc)
    o8 = -(-o // 8) * 8
    out = (Operand("out", "out", (t, OUT_TILE, OUT_TILE, o), dtype)
           if splits == 1 else
           Operand("ws", "out", (splits, t, OUT_TILE, OUT_TILE, o),
                   "float32"))
    main = LaunchDescriptor(
        kernel="winograd_fused_16", function="winograd16_fused_kernel",
        library="winograd_fused_16", which=0,
        args=(t, c, o, splits, _build.DTYPE16_CODES[HALF_DTYPES[dtype]]),
        dtype=dtype,
        operands=(Operand("tiles", "in", (t, TILE, TILE, c), dtype),
                  Operand("u", "in", (2, TILE, TILE, c, o8), dtype,
                          tma=True),
                  Operand("inv_scale", "in", (TILE * TILE,), "float32",
                          data=False),
                  *(_bias(o, bias) if splits == 1 else []), out),
        threads=FUSED_THREADS, grid=(-(-t // bt), -(-o // bo), splits),
        tile_map=_fused_tiles, windows=_fused_windows,
        dynamic_smem_bytes=FUSED_SMEM_BYTES_16, stages=FUSED_STAGES_16,
        splits=splits, k_chunks=chunks, k_ranges=k_ranges(chunks, splits),
        sum_site="reduce" if splits > 1 else "none",
        sum_order=tuple(range(splits)) if splits > 1 else (),
        geometry=(("t", t), ("c", c), ("o", o), ("bt", bt), ("bo", bo),
                  ("bc", bc)),
        items=-(-t // bt) * -(-o // bo))
    if splits == 1:
        return [main]
    return [main, reduce_launch(main, (t, OUT_TILE, OUT_TILE, o), dtype,
                                _bias(o, bias))]


def _three_pass_launches(t: int, c: int, o: int, dtype: str,
                         bias: bool) -> List[LaunchDescriptor]:
    return [input_transform_launch(t, c, dtype),
            tuple_multiply_launch(t, c, o, dtype),
            output_transform_launch(t, o, dtype, bias)]


def _three_pass_names(dtype: str):
    """(suffix, library, CUDA function prefix, describe's dtype args)."""
    if dtype in HALF_DTYPES:
        return ("_16", "winograd_3pass_16", "winograd16_",
                (_build.DTYPE16_CODES[HALF_DTYPES[dtype]],))
    return "", "winograd_3pass", "winograd_", ()


def input_transform_launch(t: int, c: int,
                           dtype: str = "float32") -> LaunchDescriptor:
    """The 3-pass input transform's launch: a thread a (tile, channel)
    pair."""
    sfx, lib, fn, code = _three_pass_names(dtype)
    return LaunchDescriptor(
        kernel="input_transform" + sfx, function=fn + "input_transform_kernel",
        library=lib, which=0, args=(t, c) + code, dtype=dtype,
        operands=(Operand("tiles", "in", (t, TILE, TILE, c), dtype),
                  Operand("v", "out", (TILE, TILE, t, c), dtype)),
        threads=TRANSFORM_THREADS, grid=(-(-t * c // TRANSFORM_THREADS), 1, 1),
        tile_map=_transform_tiles, windows=_transform_windows,
        geometry=(("t", t), ("n", c)), items=t * c)


def tuple_multiply_launch(t: int, c: int, o: int,
                          dtype: str = "float32") -> LaunchDescriptor:
    """The 3-pass tuple multiply's launch: in fp32 a 64 x 64 tile of one
    position's product a block; in 16 bits persistent blocks over 64 x N
    work items at O rounded up to 8 (``three_pass_blocks_16``), as many as
    the SMs hold at ``tuple16_resident(N)`` each."""
    sfx, lib, fn, code = _three_pass_names(dtype)
    if sfx:
        o8 = -(-o // 8) * 8
        bt, bk, n = three_pass_blocks_16(o8)
        items = 64 * -(-t // bt) * -(-o8 // n)
        resident = tuple16_resident(n)
        return LaunchDescriptor(
            kernel="tuple_multiply_16",
            function="winograd16_tuple_multiply_kernel", library=lib,
            which=1, args=(t, c, o8) + code, dtype=dtype,
            operands=(Operand("v", "in", (TILE * TILE, t, c), dtype,
                              tma=True),
                      Operand("u", "in", (2, TILE * TILE, c, o8), dtype,
                              tma=True),
                      Operand("inv_scale", "in", (TILE * TILE,), "float32",
                              data=False),
                      Operand("m", "out", (TILE * TILE, t, o8), dtype,
                              tma=True)),
            threads=TUPLE_THREADS_16, grid=persistent_grid(items, resident),
            tile_map=_tuple16_tiles, windows=_tuple16_windows,
            dynamic_smem_bytes=tuple16_smem_bytes(n), stages=TUPLE_STAGES_16,
            k_chunks=-(-c // bk), k_ranges=((0, -(-c // bk)),),
            persistent=True, items=items, resident=resident,
            geometry=(("t", t), ("c", c), ("o", o8), ("bt", bt), ("n", n)))
    from repro_torch.kernels.gemm.ops import SMEM_BYTES, STAGES, THREADS

    bt, bk, bo = THREE_PASS_BLOCKS
    return LaunchDescriptor(
        kernel="tuple_multiply", function="winograd_tuple_multiply_kernel",
        library=lib, which=1, args=(t, c, o), dtype=dtype,
        operands=(Operand("v", "in", (TILE * TILE, t, c), dtype),
                  Operand("u", "in", (TILE * TILE, c, o), dtype),
                  Operand("m", "out", (TILE * TILE, t, o), dtype)),
        threads=THREADS, grid=(-(-t // bt), -(-o // bo), TILE * TILE),
        tile_map=_tuple_tiles, windows=_tuple_windows,
        static_smem_bytes=SMEM_BYTES, stages=STAGES,
        k_chunks=-(-c // bk), k_ranges=((0, -(-c // bk)),),
        geometry=(("t", t), ("c", c), ("o", o), ("bt", bt), ("bo", bo)),
        items=-(-t // bt) * -(-o // bo) * TILE * TILE)


def output_transform_launch(t: int, o: int, dtype: str = "float32",
                            bias: bool = True) -> LaunchDescriptor:
    """The 3-pass output transform's launch: a thread a (tile, out
    channel) pair."""
    sfx, lib, fn, code = _three_pass_names(dtype)
    return LaunchDescriptor(
        kernel="output_transform" + sfx,
        function=fn + "output_transform_kernel", library=lib, which=2,
        args=(t, o) + code, dtype=dtype,
        operands=(Operand("m", "in", (TILE, TILE, t, o), dtype),
                  *_bias(o, bias),
                  Operand("out", "out", (t, OUT_TILE, OUT_TILE, o), dtype)),
        threads=TRANSFORM_THREADS, grid=(-(-t * o // TRANSFORM_THREADS), 1, 1),
        tile_map=_transform_tiles, windows=_transform_windows,
        geometry=(("t", t), ("n", o)), items=t * o)


def _fused_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """A block (x, y, s) writes the 6x6 outputs of tiles [16 x, 16 x + 16)
    and out channels [32 y, 32 y + 32), or split s's partial of them."""
    g = d.geom
    gx, gy, gz = d.grid
    for s in range(gz):
        for y in range(gy):
            for x in range(gx):
                box = ((x * g["bt"], min(g["t"], (x + 1) * g["bt"])),
                       (0, OUT_TILE), (0, OUT_TILE),
                       (y * g["bo"], min(g["o"], (y + 1) * g["bo"])))
                block = x + gx * (y + gy * s)
                if d.splits == 1:
                    yield Write(block, 0, "out", box)
                else:
                    yield Write(block, s, "ws", ((s, s + 1),) + box)


def _fused_windows(d: LaunchDescriptor) -> Iterator[Read]:
    """A block reads its 16 tiles (masked past T) over its split's
    channels, and U's rows of its 32 out channels (masked past O; by TMA
    in 16 bits)."""
    g = d.geom
    gx, gy, gz = d.grid
    bc = g.get("bc", BC)
    for s in range(gz):
        lo, hi = d.k_ranges[s]
        ch = (lo * bc, min(g["c"], hi * bc))
        for y in range(gy):
            for x in range(gx):
                block = x + gx * (y + gy * s)
                yield Read(block, "tiles", ((x * g["bt"], (x + 1) * g["bt"]),
                                            (0, TILE), (0, TILE), ch), (0,))
                o_box = (y * g["bo"], (y + 1) * g["bo"])
                if d.has("inv_scale"):
                    yield Read(block, "u", ((0, 2), (0, TILE), (0, TILE),
                                            ch, o_box))
                else:
                    yield Read(block, "u", ((0, TILE), (0, TILE), ch, o_box),
                               (3,))


def _pair_boxes(d: LaunchDescriptor, b: int):
    g = d.geom
    lo = b * d.threads
    return flat_boxes(lo, min(g["t"] * g["n"], lo + d.threads),
                      (g["t"], g["n"]))


def _transform_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """A thread a (tile, channel) pair, block b the pairs [256 b, 256 b +
    256): the input transform writes the pair's 64 positions of V, the
    output transform the pair's 6x6 outputs."""
    for b in range(d.grid[0]):
        for (t, n) in _pair_boxes(d, b):
            if d.has("v"):
                yield Write(b, 0, "v", ((0, TILE), (0, TILE), t, n))
            else:
                yield Write(b, 0, "out", (t, (0, OUT_TILE), (0, OUT_TILE), n))


def _transform_windows(d: LaunchDescriptor) -> Iterator[Read]:
    for b in range(d.grid[0]):
        for (t, n) in _pair_boxes(d, b):
            if d.has("v"):
                yield Read(b, "tiles", (t, (0, TILE), (0, TILE), n))
            else:
                yield Read(b, "m", ((0, TILE), (0, TILE), t, n))


def _tuple_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """A block (x, y, p) writes position p's 64 x 64 tile of M at tiles
    64 x, out channels 64 y."""
    g = d.geom
    gx, gy, gz = d.grid
    for p in range(gz):
        for y in range(gy):
            for x in range(gx):
                yield Write(x + gx * (y + gy * p), 0, "m", (
                    (p, p + 1), (x * g["bt"], min(g["t"], (x + 1) * g["bt"])),
                    (y * g["bo"], min(g["o"], (y + 1) * g["bo"]))))


def _tuple_windows(d: LaunchDescriptor) -> Iterator[Read]:
    g = d.geom
    gx, gy, gz = d.grid
    for p in range(gz):
        for y in range(gy):
            for x in range(gx):
                block = x + gx * (y + gy * p)
                yield Read(block, "v", ((p, p + 1),
                                        (x * g["bt"], (x + 1) * g["bt"]),
                                        (0, g["c"])), (1,))
                yield Read(block, "u", ((p, p + 1), (0, g["c"]),
                                        (y * g["bo"], (y + 1) * g["bo"])),
                           (2,))


def _tuple16_item(d: LaunchDescriptor, item: int) -> Tuple[int, int, int]:
    g = d.geom
    nblocks = -(-g["o"] // g["n"])
    slabs = -(-g["t"] // g["bt"])
    p, rem = divmod(item, slabs * nblocks)
    return p, (rem // nblocks) * g["bt"], (rem % nblocks) * g["n"]


def _tuple16_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """The persistent scheduler: block b takes items b, b + G, ... (G the
    grid), item i position p = i / (slabs x nblocks), 64 tiles by N out
    channels of M, stored by TMA boxes cut at M's edges."""
    g = d.geom
    step = d.grid[0]
    for b in range(step):
        for item in range(b, d.items, step):
            p, t0, o0 = _tuple16_item(d, item)
            yield Write(b, 0, "m", ((p, p + 1), (t0, min(g["t"], t0 + g["bt"])),
                                    (o0, min(g["o"], o0 + g["n"]))))


def _tuple16_windows(d: LaunchDescriptor) -> Iterator[Read]:
    g = d.geom
    step = d.grid[0]
    for b in range(step):
        for item in range(b, d.items, step):
            p, t0, o0 = _tuple16_item(d, item)
            yield Read(b, "v", ((p, p + 1), (t0, t0 + g["bt"]), (0, g["c"])))
            yield Read(b, "u", ((0, 2), (p, p + 1), (0, g["c"]),
                                (o0, o0 + g["n"])))


def _check_impl(impl: str) -> None:
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")


@kernel_wrapper
def fused_winograd(
    tiles: torch.Tensor,
    u: torch.Tensor,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(T, 8, 8, C) x (8, 8, C, O) -> (T, 6, 6, O); C % BC == 0, C > 0.

    ``blocks`` is ``FUSED_BLOCKS`` (or None); the products run as 3xTF32
    on the tensor cores.
    """
    t, _, _, c = tiles.shape
    o = u.shape[-1]
    if tiles.shape[1:3] != (TILE, TILE) or u.shape[:3] != (TILE, TILE, c) or c % BC:
        raise ValueError(f"fused_winograd: tiles {tuple(tiles.shape)}, "
                         f"u {tuple(u.shape)} (C must be a multiple of {BC})")
    bt, bc, bo = blocks if blocks is not None else pick_blocks(t, c, o)
    if (bt, bc, bo) != FUSED_BLOCKS:
        raise ValueError(f"fused_winograd: blocks {(bt, bc, bo)} (the kernel "
                         f"takes its compiled tile {FUSED_BLOCKS})")
    _check_impl(impl)
    _build.require_dtype("fused_winograd", torch.float32, tiles, u, bias)
    descs = (winograd_launches(t, c, o, bias=bias is not None) if t * o
             else [])
    if impl == "torch":
        emit(descs)
        return fused_winograd_ref(tiles, u, bias, activation)
    _build.require_cuda_operands("fused_winograd", tiles, u, bias)
    if tiles.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("fused_winograd: tiles and u must be 16-byte aligned")
    if not descs:
        return torch.empty((t, OUT_TILE, OUT_TILE, o), device=tiles.device,
                           dtype=torch.float32)
    out = descs[-1].alloc("out", tiles.device)
    fn = _build.load("winograd_fused", "repro_winograd_fused", _ARGTYPES)
    err = fn(tiles.data_ptr(), u.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), t, c, o, bt, bo, ACTIVATION_CODES[activation],
             _build.stream_handle(tiles))
    _build.check(err, "fused_winograd")
    fused_winograd.launches += 1
    emit(descs)
    return out


#: Kernel launches since the count was last set to 0.
fused_winograd.launches = 0


@kernel_wrapper
def input_transform(tiles: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """V = B^T d B: (T, 8, 8, C) -> (8, 8, T, C), position-major."""
    t, _, _, c = tiles.shape
    if tiles.shape[1:3] != (TILE, TILE):
        raise ValueError(f"input_transform: tiles {tuple(tiles.shape)}")
    _check_impl(impl)
    _build.require_dtype("input_transform", torch.float32, tiles)
    descs = [input_transform_launch(t, c)] if t * c else []
    if impl == "torch":
        emit(descs)
        return input_transform_ref(tiles)
    _build.require_cuda_operands("input_transform", tiles)
    if not descs:
        return torch.empty((TILE, TILE, t, c), device=tiles.device,
                           dtype=torch.float32)
    v = descs[0].alloc("v", tiles.device)
    fn = _build.load("winograd_3pass", "repro_winograd_input_transform",
                     _INPUT_ARGTYPES)
    err = fn(tiles.data_ptr(), v.data_ptr(), t, c,
             _build.stream_handle(tiles))
    _build.check(err, "input_transform")
    input_transform.launches += 1
    emit(descs)
    return v


@kernel_wrapper
def tuple_multiply(v: torch.Tensor, u: torch.Tensor,
                   impl: str = "cuda") -> torch.Tensor:
    """M[p] = V[p] @ U[p]: (64, T, C) x (64, C, O) -> (64, T, O), in the
    kernel's compiled tile ``THREE_PASS_BLOCKS``."""
    p, t, c = v.shape
    o = u.shape[-1]
    if p != TILE * TILE or u.shape[:2] != (p, c):
        raise ValueError(f"tuple_multiply: v {tuple(v.shape)}, "
                         f"u {tuple(u.shape)}")
    _check_impl(impl)
    _build.require_dtype("tuple_multiply", torch.float32, v, u)
    descs = [tuple_multiply_launch(t, c, o)] if t * o else []
    if impl == "torch":
        emit(descs)
        return tuple_multiply_ref(v, u)
    _build.require_cuda_operands("tuple_multiply", v, u)
    if not descs:
        return torch.empty((p, t, o), device=v.device, dtype=torch.float32)
    m = descs[0].alloc("m", v.device)
    fn = _build.load("winograd_3pass", "repro_winograd_tuple_multiply",
                     _TUPLE_ARGTYPES)
    err = fn(v.data_ptr(), u.data_ptr(), m.data_ptr(), t, c, o,
             _build.stream_handle(v))
    _build.check(err, "tuple_multiply")
    tuple_multiply.launches += 1
    emit(descs)
    return m


@kernel_wrapper
def output_transform(
    m: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """Y = act(A^T M A + bias): (8, 8, T, O) -> (T, 6, 6, O)."""
    _, _, t, o = m.shape
    if m.shape[:2] != (TILE, TILE) or (bias is not None and bias.shape != (o,)):
        raise ValueError(f"output_transform: m {tuple(m.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    _check_impl(impl)
    _build.require_dtype("output_transform", torch.float32, m, bias)
    descs = ([output_transform_launch(t, o, bias=bias is not None)] if t * o
             else [])
    if impl == "torch":
        emit(descs)
        return output_transform_ref(m, bias, activation)
    _build.require_cuda_operands("output_transform", m, bias)
    if not descs:
        return torch.empty((t, OUT_TILE, OUT_TILE, o), device=m.device,
                           dtype=torch.float32)
    y = descs[0].alloc("out", m.device)
    fn = _build.load("winograd_3pass", "repro_winograd_output_transform",
                     _OUTPUT_ARGTYPES)
    err = fn(m.data_ptr(), bias.data_ptr() if bias is not None else None,
             y.data_ptr(), t, o, ACTIVATION_CODES[activation],
             _build.stream_handle(m))
    _build.check(err, "output_transform")
    output_transform.launches += 1
    emit(descs)
    return y


#: Kernel launches since the count was last set to 0.
input_transform.launches = 0
tuple_multiply.launches = 0
output_transform.launches = 0


@kernel_wrapper
def fused_winograd16(
    tiles: torch.Tensor,
    u: torch.Tensor,
    inv_scale: torch.Tensor,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """bf16 or fp16 (T, 8, 8, C) x split U (2, 8, 8, C, O) -> (T, 6, 6, O)
    in their type; C % BC_16 == 0, C > 0, ``inv_scale`` fp32 (64,),
    ``bias`` fp32 (O,) or None (core/winograd.py::split_transformed makes
    ``u`` and ``inv_scale``).

    ``blocks`` is ``FUSED_BLOCKS_16`` (or None).  V is split into hi and lo
    parts of the operands' type and each product is three 16-bit products
    summed in fp32 on the tensor cores; the output is rounded once.  With
    ``call_splits_16(T, C, O) > 1`` the blocks split C, their fp32 partial
    outputs go through a workspace of ``splits * T * 36 * O`` floats from
    PyTorch's caching allocator, and a second kernel sums them in split
    order, adds the bias and the activation and rounds; the plain version
    sums the same partials in the same order.
    """
    t, _, _, c = tiles.shape
    o = u.shape[-1]
    if (tiles.shape[1:3] != (TILE, TILE)
            or u.shape[:4] != (2, TILE, TILE, c) or c % BC_16 or not c
            or inv_scale.shape != (TILE * TILE,)):
        raise ValueError(f"fused_winograd_16: tiles {tuple(tiles.shape)}, u "
                         f"{tuple(u.shape)}, inv_scale "
                         f"{tuple(inv_scale.shape)} (C must be a positive "
                         f"multiple of {BC_16})")
    if blocks is not None and tuple(blocks) != FUSED_BLOCKS_16:
        raise ValueError(f"fused_winograd_16: blocks {tuple(blocks)} (the "
                         f"kernel takes its compiled tile {FUSED_BLOCKS_16})")
    _check_impl(impl)
    dtype = _build.require_16bit("fused_winograd_16", tiles, u)
    _build.require_dtype("fused_winograd_16", torch.float32, inv_scale, bias)
    descs = (winograd_launches(t, c, o, str(dtype).split(".")[-1],
                               bias=bias is not None) if t * o else [])
    splits = descs[0].splits if descs else 1
    if impl == "torch":
        emit(descs)
        return fused_winograd16_ref(tiles, u, inv_scale, bias, activation,
                                    splits)
    _build.require_cuda_operands("fused_winograd_16", tiles, u, dtype=dtype)
    _build.require_cuda_operands("fused_winograd_16", inv_scale, bias)
    if o % 8:
        # U's rows go by TMA, whose strides are multiples of 16 bytes.
        u = torch.nn.functional.pad(u, (0, 8 - o % 8)).contiguous()
    if tiles.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("fused_winograd_16: tiles and u must be 16-byte "
                         "aligned")
    if not descs:
        return torch.empty((t, OUT_TILE, OUT_TILE, o), device=tiles.device,
                           dtype=dtype)
    out = descs[-1].alloc("out", tiles.device)
    bt, _, bo = FUSED_BLOCKS_16
    ws = descs[0].alloc("ws", tiles.device) if splits > 1 else None
    fn = _build.load("winograd_fused_16", "repro_winograd16_fused",
                     _ARGTYPES_16)
    err = fn(tiles.data_ptr(), u.data_ptr(), inv_scale.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), ws.data_ptr() if ws is not None else None,
             t, c, o, bt, bo, ACTIVATION_CODES[activation], splits,
             _build.DTYPE16_CODES[dtype], _build.stream_handle(tiles))
    _build.check(err, "fused_winograd_16")
    fused_winograd16.launches += 1
    emit(descs)
    return out


@kernel_wrapper
def input_transform16(tiles: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """V = B^T d B in fp32 on bf16 or fp16 tiles: (T, 8, 8, C) -> (8, 8,
    T, C), rounded to their type."""
    t, _, _, c = tiles.shape
    if tiles.shape[1:3] != (TILE, TILE):
        raise ValueError(f"input_transform_16: tiles {tuple(tiles.shape)}")
    _check_impl(impl)
    dtype = _build.require_16bit("input_transform_16", tiles)
    descs = ([input_transform_launch(t, c, str(dtype).split(".")[-1])]
             if t * c else [])
    if impl == "torch":
        emit(descs)
        return input_transform16_ref(tiles)
    _build.require_cuda_operands("input_transform_16", tiles, dtype=dtype)
    if not descs:
        return torch.empty((TILE, TILE, t, c), device=tiles.device,
                           dtype=dtype)
    v = descs[0].alloc("v", tiles.device)
    fn = _build.load("winograd_3pass_16", "repro_winograd16_input_transform",
                     _INPUT_ARGTYPES_16)
    err = fn(tiles.data_ptr(), v.data_ptr(), t, c,
             _build.DTYPE16_CODES[dtype], _build.stream_handle(tiles))
    _build.check(err, "input_transform_16")
    input_transform16.launches += 1
    emit(descs)
    return v


@kernel_wrapper
def tuple_multiply16(v: torch.Tensor, u: torch.Tensor,
                     inv_scale: torch.Tensor,
                     impl: str = "cuda") -> torch.Tensor:
    """M[p] = V[p] @ U[p] on bf16 or fp16 V (64, T, C) and split U (2, 64,
    C, O) (hi and lo of U * 2^k, ``inv_scale`` (64,) = 2^-k), the two
    products summed in fp32, scaled back and rounded to V's type: (64, T,
    O), in the kernel's tile ``three_pass_blocks_16(O)``; C % BC_16 == 0
    under ``impl='cuda'`` (an O that is not a multiple of 8 runs padded
    to one: the kernel's copies move 16-byte rows)."""
    p, t, c = v.shape
    o = u.shape[-1]
    if (p != TILE * TILE or u.shape[:3] != (2, p, c)
            or inv_scale.shape != (p,)):
        raise ValueError(f"tuple_multiply_16: v {tuple(v.shape)}, "
                         f"u {tuple(u.shape)}, inv_scale "
                         f"{tuple(inv_scale.shape)}")
    _check_impl(impl)
    dtype = _build.require_16bit("tuple_multiply_16", v, u)
    _build.require_dtype("tuple_multiply_16", torch.float32, inv_scale)
    descs = ([tuple_multiply_launch(t, c, o, str(dtype).split(".")[-1])]
             if t * o else [])
    if impl == "torch":
        emit(descs)
        return tuple_multiply16_ref(v, u, inv_scale)
    _build.require_cuda_operands("tuple_multiply_16", v, u, dtype=dtype)
    _build.require_cuda_operands("tuple_multiply_16", inv_scale)
    o8 = -(-o // 8) * 8
    if o8 != o:
        u = torch.nn.functional.pad(u, (0, o8 - o)).contiguous()
    if c % BC_16 or v.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError(f"tuple_multiply_16: C must be a multiple of "
                         f"{BC_16} and V and U 16-byte aligned, got C = {c}")
    if not descs:
        return torch.empty((p, t, o), device=v.device, dtype=dtype)
    m = descs[0].alloc("m", v.device)
    fn = _build.load("winograd_3pass_16", "repro_winograd16_tuple_multiply",
                     _TUPLE_ARGTYPES_16)
    err = fn(v.data_ptr(), u.data_ptr(), inv_scale.data_ptr(),
             m.data_ptr(), t, c, o8, _build.DTYPE16_CODES[dtype],
             _build.stream_handle(v))
    _build.check(err, "tuple_multiply_16")
    tuple_multiply16.launches += 1
    emit(descs)
    return m if o8 == o else m[..., :o].contiguous()


@kernel_wrapper
def output_transform16(
    m: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """Y = act(A^T M A + bias) in fp32 on bf16 or fp16 M: (8, 8, T, O) ->
    (T, 6, 6, O), rounded to its type; ``bias`` fp32 (O,) or None."""
    _, _, t, o = m.shape
    if m.shape[:2] != (TILE, TILE) or (bias is not None and bias.shape != (o,)):
        raise ValueError(f"output_transform_16: m {tuple(m.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    _check_impl(impl)
    dtype = _build.require_16bit("output_transform_16", m)
    _build.require_dtype("output_transform_16", torch.float32, bias)
    descs = ([output_transform_launch(t, o, str(dtype).split(".")[-1],
                                      bias is not None)] if t * o else [])
    if impl == "torch":
        emit(descs)
        return output_transform16_ref(m, bias, activation)
    _build.require_cuda_operands("output_transform_16", m, dtype=dtype)
    _build.require_cuda_operands("output_transform_16", bias)
    if not descs:
        return torch.empty((t, OUT_TILE, OUT_TILE, o), device=m.device,
                           dtype=dtype)
    y = descs[0].alloc("out", m.device)
    fn = _build.load("winograd_3pass_16",
                     "repro_winograd16_output_transform",
                     _OUTPUT_ARGTYPES_16)
    err = fn(m.data_ptr(), bias.data_ptr() if bias is not None else None,
             y.data_ptr(), t, o, ACTIVATION_CODES[activation],
             _build.DTYPE16_CODES[dtype], _build.stream_handle(m))
    _build.check(err, "output_transform_16")
    output_transform16.launches += 1
    emit(descs)
    return y


#: Kernel launches since the count was last set to 0.
fused_winograd16.launches = 0
input_transform16.launches = 0
tuple_multiply16.launches = 0
output_transform16.launches = 0


def conv2d_winograd_padded_call(
    x_sp: torch.Tensor,
    u: torch.Tensor,
    oh: int,
    ow: int,
    blocks: Optional[Tuple[int, int, int]] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
    fused: bool = True,
) -> torch.Tensor:
    """The Winograd conv on spatially padded, channel-aligned input.

    ``x_sp`` (B, H+2ph, W+2pw, Cp) carries the conv's spatial padding and
    Cp % BC == 0; ``u`` (8, 8, Cp, O) is the transformed weight (for bf16
    or fp16 ``x_sp``, which runs the 16-bit kernels, a ``SplitWeights`` of
    its type).  ``fused`` picks the realization: the fused kernel, or the
    three 3-pass kernels (``blocks`` is then that realization's compiled
    tile or None).  Returns
    (B, OH, OW, O): the 6-multiple tail rows and columns hold act(bias), not
    conv output, so they are cropped here.
    """
    b, cp = x_sp.shape[0], x_sp.shape[-1]
    o = u.shape[-1]
    tiles, nth, ntw = _tile_input(x_sp, oh, ow)      # (B, nTH, nTW, 8, 8, Cp)
    t = b * nth * ntw
    tiles = tiles.reshape(t, TILE, TILE, cp)
    half = x_sp.dtype in _build.DTYPE16_CODES
    if half and not isinstance(u, SplitWeights):
        raise ValueError("16-bit Winograd takes split weights "
                         "(core/winograd.py::split_transformed)")
    if fused and half:
        y = fused_winograd16(tiles, u.hl, u.inv_scale, blocks, bias,
                             activation, impl)
    elif fused:
        y = fused_winograd(tiles, u, blocks, bias, activation, impl)
    else:
        want = three_pass_blocks_16(o) if half else THREE_PASS_BLOCKS
        if blocks is not None and tuple(blocks) != want:
            raise ValueError(f"3-pass Winograd: blocks {tuple(blocks)} (the "
                             f"tuple multiply takes {want})")
        if half:
            v = input_transform16(tiles, impl)           # (8, 8, T, Cp)
            m = tuple_multiply16(v.reshape(TILE * TILE, t, cp),
                                 u.hl.reshape(2, TILE * TILE, cp, o),
                                 u.inv_scale, impl)
            y = output_transform16(m.reshape(TILE, TILE, t, o), bias,
                                   activation, impl)
        else:
            v = input_transform(tiles, impl)             # (8, 8, T, Cp)
            m = tuple_multiply(v.reshape(TILE * TILE, t, cp),
                               u.reshape(TILE * TILE, cp, o), impl)
            y = output_transform(m.reshape(TILE, TILE, t, o), bias,
                                 activation, impl)
    y = y.reshape(b, nth, ntw, OUT_TILE, OUT_TILE, o).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, nth * OUT_TILE, ntw * OUT_TILE, o)
    return y[:, :oh, :ow, :]

"""Wrappers of the hand-written GEMM kernels (csrc/gemm.cu, csrc/gemm_16.cu,
csrc/gemm_q8.cu).

``matmul_bias_act`` computes act(a @ b + bias) in fp32;
``matmul16_bias_act`` the same on bf16 or fp16 operands, summed in fp32
and rounded to their type; ``matmul_q8_bias_act`` computes act(float(a_q @ b_q) * scale + bias) from
int8 operands with an exact int32 sum.  ``impl='cuda'`` launches the
kernel on CUDA tensors and raises on anything else; ``impl='torch'`` runs
the plain version (ref.py), on any device.  The kernels mask the ragged
M, N and K edges themselves (the int8 one takes K in multiples of 16), so
no operand is padded here.  Both kernels run on the tensor cores (the
fp32 one as 3xTF32, the int8 one as s8 ``mma.sync``, the 16-bit one as
``wgmma``) and split their reduction over their K chunks (16, 32 and 64
deep) across blocks where their grid alone would leave the card's block
slots empty (``call_splits``, ``call_splits_q8``, ``call_splits_16``);
the fp32 and int8 kernels sum the splits in a second kernel, the 16-bit
one across a thread block cluster in the same launch.  One wrapper call
is one product, whatever the number of CUDA kernels it launches.

``gemm_launches`` gives the launch descriptors of one call
(kernels/_launch.py) from its shapes alone; each wrapper builds them
first and takes its split count and its output and workspace from them,
and the verifier (repro_torch/analysis) builds the same from a plan.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_spec import ACTIVATION_CODES
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (
    LaunchDescriptor,
    Operand,
    Read,
    Write,
    emit,
    kernel_wrapper,
    persistent_grid,
    reduce_launch,
    k_ranges,
)
from repro_torch.kernels._splitk import split_k
from repro_torch.kernels.gemm.ref import matmul16_ref, matmul_q8_ref, matmul_ref
from repro_torch.util import HALF_DTYPES

#: The kernel's compiled tile: 64x64 outputs per block, K steps of 16.
TILE: Tuple[int, int, int] = (64, 64, 16)
#: Blocks of the fp32 kernel resident on one SM: its launch bounds'
#: minimum, ``MIN_BLOCKS`` in csrc/sgemm_3xtf32.cuh.
RESIDENT_BLOCKS = 4
#: The fp32 kernel's threads (``sgemm_tc::THREADS``), its ring's stages
#: (``STAGES``) and its static shared memory, ``sizeof(sgemm_tc::Smem)``:
#: STAGES chunks of A (64 rows of 16 + 4 floats) and of B (16 rows of 64 +
#: 8 floats).  The 3-pass tuple multiply runs the same core.
THREADS = 128
STAGES = 3
SMEM_BYTES = STAGES * (64 * (16 + 4) + 16 * (64 + 8)) * 4

#: The 16-bit kernel's compiled tile (csrc/gemm_16.cu, BM, BN, BK): 64x64
#: outputs per block (one wgmma m64n64 warpgroup), K chunks of 64 (128-byte
#: rows, four k16 steps).
TILE_16: Tuple[int, int, int] = (64, 64, 64)
#: Blocks of the 16-bit kernel resident on one SM: its launch bounds'
#: minimum, ``MIN_BLOCKS`` in csrc/gemm_16.cu.
RESIDENT_BLOCKS_16 = 3
#: The 16-bit kernel's K multiple (TMA wants 16-byte row strides of A).
K_MULTIPLE_16 = 8
#: The most K splits of one 16-bit tile: the blocks of a portable thread
#: block cluster, which sums them (``MAX_SPLITS`` in csrc/gemm_16.cu).
MAX_SPLITS_16 = 8
#: What adding a split tile's partials across its cluster costs the 16-bit
#: kernel, in chunk steps a split (``split_k``'s ``sum_steps``): its
#: distributed-shared-memory reads take about as long as a chunk of 64 a
#: partial (scripts/conv16_variants.py on an NVIDIA H100 80GB HBM3 at
#: 700 W).
SUM_STEPS_16 = 1
#: Stages of the 16-bit kernel's ring at most (``MAX_STAGES``); a call
#: with fewer chunks of K takes one a chunk.
MAX_STAGES_16 = 3
#: The 16-bit kernel's fp32 partial tile: 64 rows of 64 + 8 floats
#: (``wgmma16::RED_LD`` in csrc/wgmma16.cuh).
RED_LD_16 = 72
#: The 16-bit kernel's threads: one consumer warpgroup and the producer
#: warp (``THREADS`` in csrc/gemm_16.cu).
THREADS_16 = 160

#: The int8 kernel's K multiple (A's rows go as 16-byte copies).
K_MULTIPLE_Q8 = 16
#: The int8 kernel's K chunk: one m16n8k32 step.
CHUNK_Q8 = 32
#: The int8 kernel's compiled tiles (bm, bn): 64 x 64, and 128 x 32 for
#: N <= 32, where a 64-wide tile would mask half its columns.
TILES_Q8: Tuple[Tuple[int, int], ...] = ((64, 64), (128, 32))
#: Blocks of the int8 kernel resident on one SM: its launch bounds'
#: minimum, ``MIN_BLOCKS`` in csrc/gemm_q8.cu.
RESIDENT_BLOCKS_Q8 = 2
#: The int8 kernel's threads, its ring's stages of K lines of 128 bytes.
THREADS_Q8 = 256
STAGES_Q8, KS_Q8 = 3, 128

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGTYPES_Q8 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_16 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def default_block(m: int, n: int, k: int,
                  dtype: str = "float32") -> Tuple[int, int, int]:
    """(bm, bn, bk) for an (m, k) x (k, n) product: the compiled tile of
    the kernel that runs ``dtype`` (``TILE_16`` for bf16 and fp16, else
    ``TILE``).

    Ragged edges are masked in the kernel, so the tile does not depend on
    the shape; the arguments keep the reference's signature.
    """
    return TILE_16 if dtype in HALF_DTYPES else TILE


def call_splits(m: int, n: int, k: int) -> int:
    """``split_k`` for one fp32 GEMM call: its grid of 64x64 tiles and its
    ceil(K / 16) chunks, over the kernel's ``RESIDENT_BLOCKS`` a SM."""
    bm, bn, bk = TILE
    return split_k(-(-m // bm) * -(-n // bn), -(-k // bk), RESIDENT_BLOCKS)


def call_splits_16(m: int, n: int, k: int) -> int:
    """``split_k`` for one 16-bit GEMM call: its grid of 64x64 tiles and its
    ceil(K / 64) chunks, over the kernel's ``RESIDENT_BLOCKS_16`` a SM, at
    most ``MAX_SPLITS_16`` (one cluster a tile), the cluster's sum priced
    at ``SUM_STEPS_16``."""
    bm, bn, bk = TILE_16
    return split_k(-(-m // bm) * -(-n // bn), -(-k // bk), RESIDENT_BLOCKS_16,
                   MAX_SPLITS_16, SUM_STEPS_16)


def tma_rows16(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., N) 16-bit weights (a GEMM's B, a conv's HWIO) as the
    16-bit GEMM and conv kernels read them by TMA: rows of N contiguous
    values a multiple of 8 apart (16 bytes), the dimensions before them
    packed, 16-byte aligned.  ``w`` itself where it is so laid out, else a
    view of the first N columns of a copy with rows padded with zeros to a
    multiple of 8 (YOLOv3's heads have N = 255).  The network plan makes
    it once, where the weights are prepared; the wrappers pass anything
    else through it on each call."""
    if _tma_rows(w):
        return w
    n = w.shape[-1]
    return F.pad(w, (0, -(-n // 8) * 8 - n)).contiguous()[..., :n]


def _tma_rows(w: torch.Tensor) -> bool:
    """Whether ``w`` is laid out as ``tma_rows16`` returns it."""
    if w.dim() < 2 or w.stride(-1) != 1 or w.data_ptr() % 16:
        return False
    ld = w.stride(-2)
    if ld % 8 or ld < w.shape[-1]:
        return False
    step = ld * w.shape[-2]
    for size, stride in zip(reversed(w.shape[:-2]), reversed(w.stride()[:-2])):
        if size != 1 and stride != step:
            return False
        step *= size
    return True


def gemm16_smem_bytes(k: int, splits: int = 1) -> int:
    """Dynamic shared memory of one 16-bit GEMM launch with K = ``k`` cut
    into ``splits`` (``smem_bytes(stages_for(K, splits), splits)`` in
    csrc/gemm_16.cu): a stage a chunk of 64 of a split, at most
    ``MAX_STAGES_16``, each A's and B's 64 x 64 boxes; the fp32 partial
    tile after the ring (persistent blocks, splits == 1) or over it; two
    8-byte mbarriers a stage of the most, and 1 KB to align the ring."""
    bm, bn, bk = TILE_16
    stages = max(1, min(MAX_STAGES_16, -(-(-(-k // bk)) // splits)))
    ring, red = stages * (bm * bk + bk * bn) * 2, bm * RED_LD_16 * 4
    body = ring + red if splits == 1 else max(ring, red)
    return body + 2 * MAX_STAGES_16 * 8 + 1024


def tile_q8(n: int) -> Tuple[int, int]:
    """(bm, bn): the int8 kernel's tile for an N-wide product."""
    return TILES_Q8[1] if n <= TILES_Q8[1][1] else TILES_Q8[0]


def call_splits_q8(m: int, n: int, k: int) -> int:
    """``split_k`` for one int8 GEMM call: its grid of ``tile_q8(n)``
    tiles and its ceil(K / 32) chunks, over ``RESIDENT_BLOCKS_Q8`` a SM."""
    bm, bn = tile_q8(n)
    return split_k(-(-m // bm) * -(-n // bn), -(-k // CHUNK_Q8),
                   RESIDENT_BLOCKS_Q8)


def stages_16(k: int, splits: int = 1) -> int:
    """The 16-bit kernel's ring stages (``stages_for`` in
    csrc/gemm_16.cu): one a chunk of 64 of a split, at most
    ``MAX_STAGES_16``."""
    per_split = -(-(-(-k // TILE_16[2])) // splits)
    return max(1, min(MAX_STAGES_16, per_split))


def gemm_launches(m: int, n: int, k: int, dtype: str = "float32",
                  bias: bool = True, ldb: Optional[int] = None
                  ) -> List[LaunchDescriptor]:
    """The launches of one (M, K) x (K, N) wrapper call in ``dtype``
    ('float32', 'int8', 'bfloat16' or 'float16'): the kernel, with the
    split count its wrapper takes (``call_splits``, ``call_splits_q8``,
    ``call_splits_16``), and where the fp32 or int8 kernel splits K, the
    reduce after it.  ``ldb``: the 16-bit B's row stride (``tma_rows16``'s,
    N rounded up to 8, by default)."""
    if dtype in HALF_DTYPES:
        return [_gemm16_launch(m, n, k, dtype, bias, ldb)]
    q8 = dtype == "int8"
    if q8:
        (bm, bn), bk = tile_q8(n), CHUNK_Q8
        splits = call_splits_q8(m, n, k)
    else:
        bm, bn, bk = TILE
        splits = call_splits(m, n, k)
    chunks = max(1, -(-k // bk))
    aux = ([Operand("scale", "in", (n,), "float32", data=False)] if q8
           else []) + ([Operand("bias", "in", (n,), "float32", data=False)]
                       if bias else [])
    operands = [Operand("a", "in", (m, k), dtype),
                Operand("b", "in", (k, n), dtype)]
    if splits == 1:
        operands += aux + [Operand("out", "out", (m, n), "float32")]
    else:
        operands.append(Operand("ws", "out", (splits, m, n),
                                "int32" if q8 else "float32"))
    name = "gemm_q8" if q8 else "gemm"
    main = LaunchDescriptor(
        kernel=name,
        function="gemm_q8_bias_act_kernel" if q8 else "gemm_bias_act_kernel",
        library=name, which=0,
        args=(m, n, k, bn, splits) if q8 else (m, n, k, splits),
        dtype=dtype, operands=tuple(operands),
        threads=THREADS_Q8 if q8 else THREADS,
        grid=(-(-m // bm), -(-n // bn), splits),
        tile_map=_gemm_tiles, windows=_gemm_windows,
        dynamic_smem_bytes=(STAGES_Q8 * (bm + bn) * KS_Q8 + bn * KS_Q8
                            if q8 else 0),
        static_smem_bytes=0 if q8 else SMEM_BYTES,
        stages=STAGES_Q8 if q8 else STAGES, splits=splits, k_chunks=chunks,
        k_ranges=k_ranges(chunks, splits),
        sum_site="reduce" if splits > 1 else "none",
        sum_order=tuple(range(splits)) if splits > 1 else (),
        k_elems=k if q8 else None,
        geometry=(("m", m), ("n", n), ("bm", bm), ("bn", bn), ("bk", bk)),
        items=-(-m // bm) * -(-n // bn))
    if splits == 1:
        return [main]
    return [main, reduce_launch(main, (m, n), "float32", aux)]


def _gemm16_launch(m: int, n: int, k: int, dtype: str, bias: bool,
                   ldb: Optional[int]) -> LaunchDescriptor:
    bm, bn, bk = TILE_16
    splits = call_splits_16(m, n, k)
    chunks = -(-k // bk)
    tiles = -(-m // bm) * -(-n // bn)
    ldb = -(-n // 8) * 8 if ldb is None else ldb
    return LaunchDescriptor(
        kernel="gemm_16", function="hgemm16_bias_act_kernel",
        library="gemm_16", which=0,
        args=(m, n, k, ldb, splits, _build.DTYPE16_CODES[HALF_DTYPES[dtype]]),
        dtype=dtype,
        operands=(Operand("a", "in", (m, k), dtype, tma=True),
                  Operand("b", "in", (k, n), dtype, (ldb, 1), tma=True),
                  *([Operand("bias", "in", (n,), "float32", data=False)]
                    if bias else []),
                  Operand("out", "out", (m, n), dtype)),
        threads=THREADS_16,
        grid=(persistent_grid(tiles, RESIDENT_BLOCKS_16) if splits == 1
              else (tiles * splits, 1, 1)),
        tile_map=_gemm16_tiles, windows=_gemm16_windows,
        cluster=(splits, 1, 1),
        dynamic_smem_bytes=gemm16_smem_bytes(k, splits),
        stages=stages_16(k, splits), splits=splits, k_chunks=chunks,
        k_ranges=k_ranges(chunks, splits),
        sum_site="cluster" if splits > 1 else "none",
        sum_order=tuple(range(splits)) if splits > 1 else (),
        persistent=splits == 1, items=tiles,
        geometry=(("m", m), ("n", n), ("bm", bm), ("bn", bn), ("bk", bk)))


def _gemm_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """A block (x, y, s) writes the tile at rows 64 x, columns 64 y (bm x
    bn) of C, or of split s's slice of the workspace."""
    g = d.geom
    gx, gy, _ = d.grid
    for s in range(d.splits):
        for y in range(gy):
            for x in range(gx):
                box = ((x * g["bm"], min(g["m"], (x + 1) * g["bm"])),
                       (y * g["bn"], min(g["n"], (y + 1) * g["bn"])))
                block = x + gx * (y + gy * s)
                if d.splits == 1:
                    yield Write(block, 0, "out", box)
                else:
                    yield Write(block, s, "ws", ((s, s + 1),) + box)


def _gemm_windows(d: LaunchDescriptor) -> Iterator[Read]:
    """A block reads its rows of A and columns of B over its split's K
    chunks; the copies zero-fill the ragged M, N and K edges."""
    g = d.geom
    gx, gy, _ = d.grid
    for s, (lo, hi) in enumerate(d.k_ranges):
        k = (lo * g["bk"], hi * g["bk"])
        for y in range(gy):
            for x in range(gx):
                block = x + gx * (y + gy * s)
                yield Read(block, "a", ((x * g["bm"], (x + 1) * g["bm"]), k),
                           (0, 1))
                yield Read(block, "b", (k, (y * g["bn"], (y + 1) * g["bn"])),
                           (0, 1))


def _gemm16_tile(d: LaunchDescriptor, t: int) -> Tuple[int, int]:
    n_tiles = -(-d.geom["n"] // d.geom["bn"])
    return (t // n_tiles) * d.geom["bm"], (t % n_tiles) * d.geom["bn"]


def _gemm16_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    """Unsplit, the persistent scheduler: block b takes tiles b, b + G,
    b + 2G, ... of the ``items`` tiles (G the grid).  Split, block b is
    rank b % splits of tile b / splits's cluster and stores rows [64 r /
    splits, 64 (r + 1) / splits) of the tile's sum."""
    g, s = d.geom, d.splits
    m, n, bm, bn = g["m"], g["n"], g["bm"], g["bn"]
    if s == 1:
        step = d.grid[0]
        for b in range(step):
            for t in range(b, d.items, step):
                m0, n0 = _gemm16_tile(d, t)
                yield Write(b, 0, "out", ((m0, min(m, m0 + bm)),
                                          (n0, min(n, n0 + bn))))
        return
    for b in range(d.grid[0]):
        t, r = divmod(b, s)
        m0, n0 = _gemm16_tile(d, t)
        lo, hi = m0 + bm * r // s, min(m, m0 + bm * (r + 1) // s)
        if lo < hi:
            yield Write(b, r, "out", ((lo, hi), (n0, min(n, n0 + bn))))


def _gemm16_windows(d: LaunchDescriptor) -> Iterator[Read]:
    """The TMA boxes of A (64 x 64, K-major) and B (64 x 64) of a block's
    tiles over its split's chunks; the copy engine fills what lies past M,
    N or K with zeros."""
    g, s = d.geom, d.splits
    step = d.grid[0] // s
    for b in range(d.grid[0]):
        lo, hi = d.k_ranges[b % s]
        k = (lo * g["bk"], hi * g["bk"])
        for t in range(b // s, d.items, step):
            m0, n0 = _gemm16_tile(d, t)
            yield Read(b, "a", ((m0, m0 + g["bm"]), k))
            yield Read(b, "b", (k, (n0, n0 + g["bn"])))


@kernel_wrapper
def matmul_bias_act(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(M, K) x (K, N) -> act(a @ b + bias), fp32; ``bias`` is (N,) or None.

    With ``call_splits(M, N, K) > 1`` the partial sums go through a
    workspace of ``splits * M * N`` floats from PyTorch's caching
    allocator.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"gemm: shapes {tuple(a.shape)} x {tuple(b.shape)}"
                         f" with bias {None if bias is None else tuple(bias.shape)}")
    _build.require_dtype("gemm", torch.float32, a, b, bias)
    descs = gemm_launches(m, n, k, bias=bias is not None) if m and n else []
    if impl == "torch":
        emit(descs)
        return matmul_ref(a, b, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("gemm", a, b, bias)
    if not descs:
        return torch.empty((m, n), device=a.device, dtype=torch.float32)
    out = descs[-1].alloc("out", a.device)
    main = descs[0]
    ws = main.alloc("ws", a.device) if main.splits > 1 else None
    fn = _build.load("gemm", "repro_gemm_bias_act", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), ws.data_ptr() if ws is not None else None,
             m, n, k, ACTIVATION_CODES[activation], main.splits,
             _build.stream_handle(a))
    _build.check(err, "gemm")
    matmul_bias_act.launches += 1
    emit(descs)
    return out


#: Kernel launches since the count was last set to 0.
matmul_bias_act.launches = 0


@kernel_wrapper
def matmul16_bias_act(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(M, K) x (K, N) bf16 or fp16 -> act(a @ b + bias) in a's type, the
    products summed in fp32 and rounded once; ``bias`` fp32 (N,) or None.
    Under ``impl='cuda'`` K % 8 == 0 and A 16-byte aligned; B goes
    through ``tma_rows16`` (a copy unless it is laid out so already, as
    ``core/netplan.py`` keeps a head's weights).  One launch, split K or
    not (``call_splits_16``): the splits of a tile are summed in its
    thread block cluster, with no workspace.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"gemm_16: shapes {tuple(a.shape)} x {tuple(b.shape)}"
                         f" with bias {None if bias is None else tuple(bias.shape)}")
    dtype = _build.require_16bit("gemm_16", a, b)
    _build.require_dtype("gemm_16", torch.float32, bias)
    name = str(dtype).split(".")[-1]
    if impl == "torch":
        emit(gemm_launches(m, n, k, name, bias is not None) if m and n
             else [])
        return matmul16_ref(a, b, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("gemm_16", a, dtype=dtype)
    _build.require_cuda_operands("gemm_16", bias)
    if b.device != a.device:
        raise ValueError("gemm_16: B must lie on A's card")
    b = tma_rows16(b)
    if k % K_MULTIPLE_16 or a.data_ptr() % 16:
        raise ValueError(f"gemm_16: K must be a multiple of {K_MULTIPLE_16} "
                         f"and A 16-byte aligned, got K = {k}")
    if not (m and n):
        return torch.empty((m, n), device=a.device, dtype=dtype)
    descs = gemm_launches(m, n, k, name, bias is not None, ldb=b.stride(0))
    (main,) = descs
    out = main.alloc("out", a.device)
    fn = _build.load("gemm_16", "repro_gemm16_bias_act", _ARGTYPES_16)
    err = fn(a.data_ptr(), b.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), m, n, k, b.stride(0),
             ACTIVATION_CODES[activation], main.splits,
             _build.DTYPE16_CODES[dtype], _build.stream_handle(a))
    _build.check(err, "gemm_16")
    matmul16_bias_act.launches += 1
    emit(descs)
    return out


#: Kernel launches since the count was last set to 0.
matmul16_bias_act.launches = 0


@kernel_wrapper
def matmul_q8_bias_act(
    a_q: torch.Tensor,
    b_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: str = "linear",
    impl: str = "cuda",
) -> torch.Tensor:
    """(M, K) x (K, N) int8 -> act(float(a_q @ b_q) * scale + bias), fp32;
    ``scale`` is (N,), ``bias`` (N,) or None.  Raises when K * 127^2 could
    overflow the int32 sum, and under ``impl='cuda'`` unless K % 16 == 0.
    With ``call_splits_q8(M, N, K) > 1`` the int32 partial sums go through
    a workspace of ``splits * M * N`` int32 from PyTorch's caching
    allocator.
    """
    m, k = a_q.shape
    k2, n = b_q.shape
    if k != k2 or scale.shape != (n,) or (bias is not None
                                          and bias.shape != (n,)):
        raise ValueError(
            f"gemm_q8: shapes {tuple(a_q.shape)} x {tuple(b_q.shape)} with "
            f"scale {tuple(scale.shape)} and bias "
            f"{None if bias is None else tuple(bias.shape)}")
    _build.require_int32_exact("gemm_q8", k)
    descs = (gemm_launches(m, n, k, "int8", bias is not None) if m and n
             else [])
    if impl == "torch":
        emit(descs)
        return matmul_q8_ref(a_q, b_q, scale, bias, activation)
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    _build.require_cuda_operands("gemm_q8", a_q, b_q, dtype=torch.int8)
    _build.require_cuda_operands("gemm_q8", scale, bias)
    if k % K_MULTIPLE_Q8 or a_q.data_ptr() % 16:
        raise ValueError(f"gemm_q8: K must be a multiple of {K_MULTIPLE_Q8} "
                         f"and A 16-byte aligned, got K = {k}")
    if not descs:
        return torch.empty((m, n), device=a_q.device, dtype=torch.float32)
    out = descs[-1].alloc("out", a_q.device)
    main = descs[0]
    ws = main.alloc("ws", a_q.device) if main.splits > 1 else None
    fn = _build.load("gemm_q8", "repro_gemm_q8_bias_act", _ARGTYPES_Q8)
    err = fn(a_q.data_ptr(), b_q.data_ptr(), scale.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), ws.data_ptr() if ws is not None else None,
             m, n, k, ACTIVATION_CODES[activation], main.geom["bn"],
             main.splits, _build.stream_handle(a_q))
    _build.check(err, "gemm_q8")
    matmul_q8_bias_act.launches += 1
    emit(descs)
    return out


#: Kernel launches since the count was last set to 0.
matmul_q8_bias_act.launches = 0

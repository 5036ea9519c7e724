"""Launch descriptors: what one CUDA launch of the port is, as data.

Every kernel wrapper (kernels/*/ops.py) builds the descriptors of the
launches it makes from its operands' shapes before it launches anything,
and takes its split count and its output (and workspace) allocation from
them; ``analysis/descriptors.py`` builds the same descriptors from a
network plan alone, with the same functions.  A descriptor says exactly
what the launch is: the kernel and its CUDA function, each operand's
shape, strides and type, the block's threads, the grid and the cluster,
the dynamic and static shared memory, the ring's stages, the K splits and
the chunks each takes, where and in which order their partial sums are
added, the bytes it moves through device memory, and, through two
functions kept beside it (``tile_map``, ``windows``), which block writes
which part of which output and which part of each operand it reads.

A persistent grid (the 16-bit GEMM, the 16-bit implicit-GEMM conv and the
16-bit tuple multiply) is as large as the card holds at once,
``min(items, SMs x resident)``; only the card knows ``resident`` where it
comes from an occupancy query.  Such a descriptor is built with its
kernel's ``__launch_bounds__`` minimum and ``with_resident`` fills in what
the card says (``describe``).

``describe`` asks a library's ``repro_<library>_describe`` entry for what
its launcher would launch (csrc/describe.cuh); only a run on the card
calls it.

Two more things live here because every wrapper touches them: the stack of
launch recorders (``analysis/record.py`` pushes one; ``emit`` appends the
launches a wrapper makes, or under ``impl='torch'`` would make, to each),
and the extent of the kernel wrappers (``kernel_wrapper``), which the
channel census of ``analysis/record.py`` leaves out.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.hw import H100
from repro_torch.kernels._splitk import split_ranges

Box = Tuple[Tuple[int, int], ...]       # (lo, hi) per dimension

#: The size of each element type, in bytes.
ITEMSIZE = {"float32": 4, "int32": 4, "int8": 1, "bfloat16": 2, "float16": 2}

#: The fields ``describe`` returns, in csrc/describe.cuh's order.
DESCRIBE_FIELDS = (
    "grid_x", "grid_y", "grid_z", "cluster_x", "cluster_y", "cluster_z",
    "threads", "dynamic_smem_bytes", "stages", "resident",
    "static_smem_bytes", "registers", "max_dynamic_smem_bytes", "sm_count",
    "smem_optin_bytes", "local_bytes",
)
_DESCRIBE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    out, step = [], 1
    for size in reversed(shape):
        out.append(step)
        step *= size
    return tuple(reversed(out))


@dataclasses.dataclass(frozen=True)
class Operand:
    """One tensor a launch reads (``role`` 'in') or writes ('out').

    ``strides`` are in elements.  ``data``: an operand of the step's type
    (the activation, the weights, the output, the partial sums); False for
    the fp32 rows of the epilogue (bias, dequant scale, inverse scale).
    ``tma``: the kernel moves it by TMA boxes, whose reads past ``shape``
    the copy engine fills with zeros (and whose writes past it it drops),
    so a box may reach past it on purpose."""

    name: str
    role: str
    shape: Tuple[int, ...]
    dtype: str
    strides: Tuple[int, ...] = ()
    data: bool = True
    tma: bool = False

    def __post_init__(self):
        assert self.role in ("in", "out"), self.role
        if not self.strides:
            object.__setattr__(self, "strides",
                               contiguous_strides(self.shape))

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * ITEMSIZE[self.dtype]

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "role": self.role,
                "shape": list(self.shape), "strides": list(self.strides),
                "dtype": self.dtype, "data": self.data, "tma": self.tma}


@dataclasses.dataclass(frozen=True)
class Write:
    """Block ``block`` (split ``split``) writes ``box`` of ``operand``."""

    block: int
    split: int
    operand: str
    box: Box


@dataclasses.dataclass(frozen=True)
class Read:
    """A block reads ``box`` of ``operand``; on the dimensions in
    ``masked`` the kernel skips (zero-fills) what lies outside the
    operand, element by element."""

    block: int
    operand: str
    box: Box
    masked: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class LaunchDescriptor:
    """One CUDA launch (see the module's docstring).

    ``kernel`` is the kernel's name as ``conv_ops.plan_kernels`` gives it
    (the split-K reduce is ``kernel + '_reduce'``), ``function`` its CUDA
    function, ``library`` its source (``_build.SOURCES``), ``which`` and
    ``args`` what the library's describe entry takes for it.
    ``k_ranges`` are the chunk ranges [lo, hi) of the ``splits`` splits of
    the reduction's ``k_chunks`` chunks; ``sum_site`` says where the
    partials are added ('none' unsplit, 'reduce' a second kernel, whose
    descriptor follows, 'cluster' the blocks of a thread block cluster)
    and ``sum_order`` in which order.  ``k_elems`` is the depth of an int8
    sum (None otherwise).  ``geometry`` holds the ints the tile map and
    the windows read."""

    kernel: str
    function: str
    library: str
    which: int
    args: Tuple[int, ...]
    dtype: str
    operands: Tuple[Operand, ...]
    threads: int
    grid: Tuple[int, int, int]
    tile_map: Callable[["LaunchDescriptor"], Iterator[Write]] = \
        dataclasses.field(compare=False, repr=False)
    windows: Callable[["LaunchDescriptor"], Iterator[Read]] = \
        dataclasses.field(compare=False, repr=False)
    cluster: Tuple[int, int, int] = (1, 1, 1)
    dynamic_smem_bytes: int = 0
    static_smem_bytes: int = 0
    stages: int = 0
    splits: int = 1
    k_chunks: int = 0
    k_ranges: Tuple[Tuple[int, int], ...] = ()
    sum_site: str = "none"
    sum_order: Tuple[int, ...] = ()
    k_elems: Optional[int] = None
    persistent: bool = False
    items: int = 0
    resident: Optional[int] = None
    geometry: Tuple[Tuple[str, int], ...] = ()
    step: Optional[int] = None

    @property
    def smem_bytes(self) -> int:
        """A block's shared memory: dynamic and static."""
        return self.dynamic_smem_bytes + self.static_smem_bytes

    @property
    def hbm_bytes(self) -> int:
        """Bytes through device memory: each operand read once or written
        once."""
        return sum(op.nbytes for op in self.operands)

    @property
    def geom(self) -> Dict[str, int]:
        return dict(self.geometry)

    def operand(self, name: str) -> Operand:
        for op in self.operands:
            if op.name == name:
                return op
        raise KeyError(f"{self.kernel}: no operand {name!r}")

    def has(self, name: str) -> bool:
        return any(op.name == name for op in self.operands)

    def alloc(self, name: str, device) -> torch.Tensor:
        """An empty tensor for operand ``name`` on ``device``."""
        op = self.operand(name)
        return torch.empty(op.shape, dtype=getattr(torch, op.dtype),
                           device=device)

    def writes(self) -> Iterator[Write]:
        return self.tile_map(self)

    def reads(self) -> Iterator[Read]:
        return self.windows(self)

    def with_resident(self, resident: int,
                      sm_count: int = H100.sm_count) -> "LaunchDescriptor":
        """A persistent launch with ``resident`` blocks a SM, as the card
        sizes it: ``min(items, sm_count x resident)`` blocks."""
        if not self.persistent:
            return self
        return dataclasses.replace(
            self, resident=resident,
            grid=(min(self.items, sm_count * resident), 1, 1))

    def to_json(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel, "function": self.function,
            "library": self.library, "step": self.step, "dtype": self.dtype,
            "grid": list(self.grid), "cluster": list(self.cluster),
            "threads": self.threads,
            "dynamic_smem_bytes": self.dynamic_smem_bytes,
            "static_smem_bytes": self.static_smem_bytes,
            "stages": self.stages, "splits": self.splits,
            "k_chunks": self.k_chunks,
            "k_ranges": [list(r) for r in self.k_ranges],
            "sum_site": self.sum_site, "sum_order": list(self.sum_order),
            "k_elems": self.k_elems, "persistent": self.persistent,
            "items": self.items, "resident": self.resident,
            "hbm_bytes": self.hbm_bytes,
            "operands": [op.to_json() for op in self.operands],
        }


def persistent_grid(items: int, resident: int) -> Tuple[int, int, int]:
    """A persistent grid: as many blocks as the card's SMs hold at once
    (``resident`` each), no more than the work items."""
    return (max(1, min(items, H100.sm_count * resident)), 1, 1)


def k_ranges(k_chunks: int, splits: int) -> Tuple[Tuple[int, int], ...]:
    """Each split's chunk range, as every splitting kernel computes it
    (``_splitk.split_ranges``)."""
    return tuple(split_ranges(k_chunks, splits))


def flat_boxes(lo: int, hi: int, shape: Sequence[int]) -> List[Box]:
    """The boxes of ``shape`` that hold exactly the elements [lo, hi) of
    its row-major order (at most two a dimension, and one)."""
    shape = tuple(shape)
    if lo >= hi:
        return []
    if len(shape) == 1:
        return [((lo, hi),)]
    inner = math.prod(shape[1:])
    r0, r1 = lo // inner, (hi - 1) // inner
    if r0 == r1:
        return [((r0, r0 + 1),) + b
                for b in flat_boxes(lo - r0 * inner, hi - r0 * inner,
                                    shape[1:])]
    out: List[Box] = []
    first = r0
    if lo % inner:
        out += [((r0, r0 + 1),) + b
                for b in flat_boxes(lo - r0 * inner, inner, shape[1:])]
        first = r0 + 1
    last = r1 + 1 if hi % inner == 0 else r1
    if last > first:
        out.append(((first, last),) + tuple((0, s) for s in shape[1:]))
    if hi % inner:
        out += [((r1, r1 + 1),) + b
                for b in flat_boxes(0, hi - r1 * inner, shape[1:])]
    return out


# ---------------------------------------------------------------------------
# The split-K reduce launch, shared by five kernels


def reduce_launch(main: LaunchDescriptor, out_shape: Tuple[int, ...],
                  out_dtype: str, aux: Sequence[Operand]) -> LaunchDescriptor:
    """The reduce that follows ``main`` (sum_site 'reduce'): it reads the
    ``splits`` partial outputs of the workspace in split order, adds the
    epilogue rows ``aux`` and writes the output of ``out_shape`` (the
    last dimension the row width), 4 consecutive outputs a thread where
    that width is a multiple of 4, else 1, 256 threads a block."""
    n = math.prod(out_shape)
    cols = out_shape[-1]
    vec = 4 if cols % 4 == 0 else 1
    ws = main.operand("ws")
    return LaunchDescriptor(
        kernel=main.kernel + "_reduce",
        function=REDUCE_FUNCTIONS[main.kernel], library=main.library,
        which=1, args=main.args, dtype=main.dtype,
        operands=(dataclasses.replace(ws, role="in"), *aux,
                  Operand("out", "out", out_shape, out_dtype)),
        threads=256, grid=(-(-(n // vec) // 256), 1, 1),
        tile_map=_reduce_tiles, windows=_reduce_windows,
        splits=main.splits, sum_site="reduce",
        sum_order=tuple(range(main.splits)), k_elems=main.k_elems,
        geometry=(("n", n), ("per_block", 256 * vec)),
        items=-(-n // (256 * vec)))


#: The CUDA function of each splitting kernel's reduce.
REDUCE_FUNCTIONS = {
    "gemm": "gemm_splitk_reduce_kernel",
    "gemm_q8": "gemm_q8_splitk_reduce_kernel",
    "im2col_conv": "im2col_conv_splitk_reduce_kernel",
    "im2col_conv_q8": "im2col_conv_q8_splitk_reduce_kernel",
    "winograd_fused_16": "winograd16_split_reduce_kernel",
}


def _reduce_tiles(d: LaunchDescriptor) -> Iterator[Write]:
    g, shape = d.geom, d.operand("out").shape
    for b in range(d.grid[0]):
        lo = b * g["per_block"]
        for box in flat_boxes(lo, min(g["n"], lo + g["per_block"]), shape):
            yield Write(b, 0, "out", box)


def _reduce_windows(d: LaunchDescriptor) -> Iterator[Read]:
    g, ws = d.geom, d.operand("ws")
    for b in range(d.grid[0]):
        lo = b * g["per_block"]
        for box in flat_boxes(lo, min(g["n"], lo + g["per_block"]),
                              ws.shape[1:]):
            yield Read(b, "ws", ((0, d.splits),) + box)


# ---------------------------------------------------------------------------
# Recording and the wrappers' extent

_recorders: List[List[LaunchDescriptor]] = []
_wrapper_depth = [0]


def emit(descs: Sequence[LaunchDescriptor]) -> None:
    """Append the launches of one wrapper call to every open recorder."""
    for rec in _recorders:
        rec.extend(descs)


def push_recorder() -> List[LaunchDescriptor]:
    rec: List[LaunchDescriptor] = []
    _recorders.append(rec)
    return rec


def pop_recorder(rec: List[LaunchDescriptor]) -> None:
    """Close recorder ``rec`` (by identity: two recorders may hold equal
    lists)."""
    del _recorders[next(i for i, r in enumerate(_recorders) if r is rec)]


def inside_wrapper() -> bool:
    """Whether a kernel wrapper is running (its copies, pads and plain
    version are the kernel's own, not glue between kernels)."""
    return _wrapper_depth[0] > 0


def kernel_wrapper(fn: Callable) -> Callable:
    """Mark ``fn`` as a kernel wrapper: ``inside_wrapper`` holds while it
    runs."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _wrapper_depth[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _wrapper_depth[0] -= 1
    return wrapped


# ---------------------------------------------------------------------------
# The card's own account


def describe(desc: LaunchDescriptor) -> Dict[str, int]:
    """What ``desc``'s library launches for its shapes (its describe entry,
    csrc/describe.cuh), on the current device: ``DESCRIBE_FIELDS``.
    Builds the library on first use; needs the card."""
    from repro_torch.kernels import _build

    fn = _build.load(desc.library, f"repro_{desc.library}_describe",
                     _DESCRIBE_ARGTYPES)
    args = (ctypes.c_int * len(desc.args))(*desc.args)
    out = (ctypes.c_longlong * len(DESCRIBE_FIELDS))()
    _build.check(fn(ctypes.addressof(args), len(desc.args), desc.which,
                    ctypes.addressof(out)), f"{desc.kernel} describe")
    return dict(zip(DESCRIBE_FIELDS, (int(v) for v in out)))

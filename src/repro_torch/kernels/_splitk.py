"""Split-K: how many contiguous ranges of its K chunks a kernel's
reduction is cut into, from the shape alone.

Shared by six kernels, each over its own chunks and its own resident
blocks a SM: the fp32 implicit-GEMM conv (chunks of 8 channels), the int8
implicit-GEMM conv (chunks of 32 channels, all taps), the fp32 GEMM
(chunks of 16 of K), the int8 GEMM (chunks of 32 of K), and the 16-bit
GEMM (chunks of 64 of K) and implicit-GEMM conv (chunks of 32 channels,
all taps).  Each kernel runs split s over chunks ``split_ranges(n,
splits)[s]`` and sums the partials in split order, so the result does not
depend on the order the blocks run in: the fp32 and int8 kernels write
partial tiles to a workspace and sum them in a second kernel; the 16-bit
ones put a tile's splits in one thread block cluster and sum them there,
in the same launch, so their split count is capped at the cluster's size
(``max_splits``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.hw import H100

#: A block's fixed cost in reduction steps: its first chunk's copy, which
#: nothing overlaps, and the write of its tile.
BLOCK_OVERHEAD_STEPS = 2


def split_k(blocks_in_grid: int, k_chunks: int,
            resident_blocks: int = 2, max_splits: Optional[int] = None,
            sum_steps: int = 0) -> int:
    """How many ranges a kernel cuts its reduction of ``k_chunks`` chunks
    into, for a grid of ``blocks_in_grid`` blocks of which
    ``resident_blocks`` fit on one SM (the kernel's ``__launch_bounds__``
    minimum; the default, 2, is the implicit-GEMM conv's).

    1 where the grid already fills the card's block slots
    (``resident_blocks`` on each SM).  Else the split count that takes the
    fewest waves times steps per block (``BLOCK_OVERHEAD_STEPS`` added to
    each block's steps), the smallest on a tie: it fills the slots without
    starting a second wave of short blocks.  ``max_splits`` (None: no
    cap) bounds the count: the blocks a cluster may hold, where the splits
    of a tile are one cluster.  ``sum_steps`` prices the sum of a split
    tile's partials where a kernel adds them in its own blocks: s splits
    cost ``sum_steps * (s + 1)`` more steps a block.
    """
    slots = resident_blocks * H100.sm_count
    if blocks_in_grid >= slots or k_chunks <= 1:
        return 1

    def cost(s: int) -> int:
        waves = -(-blocks_in_grid * s // slots)
        return waves * (-(-k_chunks // s) + BLOCK_OVERHEAD_STEPS
                        + (sum_steps * (s + 1) if s > 1 else 0))

    most = k_chunks if max_splits is None else min(k_chunks, max_splits)
    return min(range(1, most + 1), key=lambda s: (cost(s), s))


def split_ranges(k_chunks: int, splits: int) -> List[Tuple[int, int]]:
    """The chunk range [lo, hi) of each split, as the kernels compute it:
    split s takes [s * n // splits, (s + 1) * n // splits)."""
    if not 1 <= splits <= k_chunks:
        raise ValueError(f"splits must be in [1, {k_chunks}], got {splits}")
    return [(s * k_chunks // splits, (s + 1) * k_chunks // splits)
            for s in range(splits)]

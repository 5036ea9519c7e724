"""The mesh context: the port of ``repro/distributed/context.py``.

A mesh here is its shape, ``MeshShape``: axis names and sizes, plain
data.  The partition rules (``sharding.py``) and the dry run read only
that, so they run with no process group and no card.  Real execution
builds a ``torch.distributed`` ``DeviceMesh`` of the same shape
(``to_device_mesh``).

Models name the axes of an activation with ``shard_hint``; the hint
resolves to a spec by the reference's rules (axis mode, absent axes
dropped, each axis group shrunk to its largest subset that divides the
dim) when a mesh is installed with ``use_mesh`` (``resolve_hint``).  The
port's models run on plain tensors, whose layout no hint can constrain,
so ``shard_hint`` returns its tensor unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

#: A spec entry: unsharded, one axis, or a group of axes.
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
AxisHint = Union[None, str, Sequence[str]]

# Conventional axis groupings used across the model zoo.
BATCH = ("pod", "data")   # DP axes
MODEL = "model"           # TP axis


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A logical device mesh: axis names and their sizes, in order (the
    last axis innermost)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{self.axis_names} and {self.shape} differ in "
                             f"length")

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def to_device_mesh(mesh: MeshShape, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``mesh`` over the default process group,
    whose world size must equal ``mesh.size``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, mesh.shape,
                            mesh_dim_names=mesh.axis_names)


_state = threading.local()


def set_mesh(mesh: Optional[MeshShape]) -> None:
    _state.mesh = mesh


def get_mesh() -> Optional[MeshShape]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: MeshShape):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def set_axis_mode(mode: str) -> None:
    """'default', 'dp_only', or 'dp_seq'.

    dp_only: pure data parallelism — the TP axis joins the batch axes and
    model-dim hints are dropped (small archs, batch >= device count).
    dp_seq: data x sequence (context) parallelism — batch over the DP axes,
    the sequence dim over the freed 'model' axis (small-arch prefill, where
    batch < device count would leave the model axis idle)."""
    if mode not in ("default", "dp_only", "dp_seq"):
        raise ValueError(f"axis mode must be default, dp_only or dp_seq, "
                         f"got {mode!r}")
    _state.axis_mode = mode


def get_axis_mode() -> str:
    return getattr(_state, "axis_mode", "default")


def largest_divisible_subset(dim: int, axes, sizes) -> tuple:
    """Longest prefix-preferring subset of ``axes`` whose size product
    divides ``dim`` (greedy: keep an axis if divisibility still holds)."""
    kept = []
    prod = 1
    for a in axes:
        if dim % (prod * sizes[a]) == 0:
            kept.append(a)
            prod *= sizes[a]
    return tuple(kept)


def _resolve(axis: AxisHint, names) -> Entry:
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in names else None
    present = tuple(a for a in axis if a in names)
    return present if len(present) > 1 else (present[0] if present else None)


def _entry(kept: tuple) -> Entry:
    return kept if len(kept) > 1 else (kept[0] if kept else None)


def resolve_hint(shape: Sequence[int], *axes: AxisHint,
                 mesh: Optional[MeshShape] = None) -> Optional[Spec]:
    """The spec ``shard_hint`` gives a tensor of ``shape`` under ``mesh``
    (the installed one by default) and the axis mode; None without a
    mesh.  One entry a hinted dim: trailing dims stay unsharded."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    mode = get_axis_mode()
    if mode == "dp_only":
        axes = tuple(
            (("pod", "data", "model") if (a == BATCH or a == ("pod", "data"))
             else None if a == MODEL else a)
            for a in axes
        )
    elif mode == "dp_seq":
        axes = tuple(None if a == MODEL else a for a in axes)
        # Sequence dim (dim 1 of activation hints) rides the model axis.
        if len(axes) >= 3 and axes[1] is None:
            axes = axes[:1] + ("model",) + axes[2:]
    names, sizes = set(mesh.axis_names), mesh.sizes
    fixed = []
    for dim, entry in zip(shape, axes):
        entry = _resolve(entry, names)
        if entry is None:
            fixed.append(None)
            continue
        ax = (entry,) if isinstance(entry, str) else tuple(entry)
        fixed.append(_entry(largest_divisible_subset(dim, ax, sizes)))
    return tuple(fixed)


def shard_hint(x: torch.Tensor, *axes: AxisHint) -> torch.Tensor:
    """``x`` itself: the port's models run on plain tensors, whose layout
    no hint constrains.  The hint is resolved all the same where a mesh
    is installed (``resolve_hint``), so a hint the rules cannot read
    fails here as it would in the reference."""
    resolve_hint(tuple(x.shape), *axes)
    return x

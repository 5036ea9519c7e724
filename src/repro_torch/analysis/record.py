"""What one forward launches and which channel copies it makes between
its kernels: the recorded side of the verifier, in place of the
reference's jaxpr trace (``repro/analysis/trace.py``).

``record_launches`` opens a launch recorder: every kernel wrapper
(kernels/*/ops.py) appends the descriptors of the launches it makes
(kernels/_launch.py), built from its own operands; under ``impl='torch'``
it appends those it would make, built from the same tensors, then runs its
plain version.  So a forward on the CPU records what the same forward
launches on the card.

``ChannelCensus`` is a ``TorchDispatchMode`` that records each pad, crop
(``pad`` and ``constant_pad_nd``, ``slice``, and ``narrow``, which
dispatches as ``slice``) and concatenation (``cat``) on the channel axis of an
activation, outside the kernel wrappers: the glue between kernels that the
plan's layout rule (``core/netplan.expected_channel_ops``) predicts.  The
channel axis is an NHWC activation's last axis, the one whose stride is 1;
a pad on a spatial axis is intra-layer movement, as in the reference (the
max pool's -inf pad runs on a (B, C, H, W) view of the activation, whose
last axis is W; the conv's spatial pads leave the last axis alone).

``record_forward`` runs a planned forward (or one stage of it) on zeros
under both.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels._launch import (
    LaunchDescriptor,
    inside_wrapper,
    pop_recorder,
    push_recorder,
)

_aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class ChannelOp:
    """One channel-axis pad ('pad'), crop ('crop') or concatenation
    ('cat') between kernels."""

    kind: str
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]


@contextlib.contextmanager
def record_launches() -> Iterator[List[LaunchDescriptor]]:
    """The launches the kernel wrappers make inside the block, in order."""
    rec = push_recorder()
    try:
        yield rec
    finally:
        pop_recorder(rec)


def _channel_last(t: Any) -> bool:
    """Whether ``t``'s last axis is its channel axis: an activation of at
    least two axes whose last is innermost in memory."""
    return (isinstance(t, torch.Tensor) and t.dim() >= 2
            and (t.stride(-1) == 1 or t.shape[-1] == 1))


class ChannelCensus(TorchDispatchMode):
    """Records ``ChannelOp``s outside the kernel wrappers (see the
    module's docstring); ``ops`` lists them in order."""

    def __init__(self):
        super().__init__()
        self.ops: List[ChannelOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not inside_wrapper():
            op = self._channel_op(func, args, kwargs, out)
            if op is not None:
                self.ops.append(op)
        return out

    @staticmethod
    def _channel_op(func, args, kwargs, out) -> Optional[ChannelOp]:
        packet = getattr(func, "overloadpacket", None)
        if packet is _aten.constant_pad_nd or packet is _aten.pad:
            x, pad = args[0], list(args[1])
            if _channel_last(x) and (pad[0] or pad[1]):
                kind = "pad" if pad[0] + pad[1] > 0 else "crop"
                return ChannelOp(kind, tuple(x.shape), tuple(out.shape))
        elif packet is _aten.slice:
            x = args[0]
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if (_channel_last(x) and dim % x.dim() == x.dim() - 1
                    and out.shape[-1] != x.shape[-1]):
                return ChannelOp("crop", tuple(x.shape), tuple(out.shape))
        elif packet is _aten.cat:
            tensors = list(args[0])
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if (len(tensors) > 1 and _channel_last(tensors[0])
                    and dim % tensors[0].dim() == tensors[0].dim() - 1):
                return ChannelOp("cat", tuple(tensors[0].shape),
                                 tuple(out.shape))
        return None


def record_forward(
    netplan,
    params: Sequence[Dict],
    x: torch.Tensor,
    pretransformed: Optional[Sequence[bool]] = None,
    start: int = 0,
    stop: Optional[int] = None,
) -> Tuple[List[LaunchDescriptor], List[ChannelOp], torch.Tensor]:
    """(launches, channel ops, output) of ``run_network`` on ``x`` over
    ``steps[start:stop]`` (``params`` the slice's own list, as
    ``run_network`` takes it), on the device the params and ``x`` lie on:
    on the card the kernels run, on the CPU their plain versions do."""
    from repro_torch.core.netplan import run_network

    census = ChannelCensus()
    with record_launches() as launches, torch.inference_mode(), census:
        y = run_network(netplan, params, x, pretransformed=pretransformed,
                        start=start, stop=stop)
    return launches, census.ops, y

"""Device lists for multi-device CNN inference: the counterpart of the
reference's ``make_stage_mesh`` (``repro/launch/mesh.py``); and the
production LM meshes as shapes (``production_mesh_shape``, its
``make_production_mesh``), which the partition rules and the dry run
read.

The port drives every stage and shard from one process, so a "mesh" is a
plain list of ``torch.device``s, one entry per stage or shard.  A device
may repeat: each entry is still its own stage or shard, with its own
stream, CUDA-graph memory pool and copy of the parameters, which runs the
whole schedule on one card (and shows nothing of multi-card speed).
Functions, not module constants: importing this module touches no
device.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch


def visible_devices(device: Any = "cuda") -> List[torch.device]:
    """Every visible card for a CUDA ``device`` without an index; else
    ``[device]`` alone (a CPU, or one named card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def stage_devices(n_stages: int,
                  devices: Optional[Sequence[Any]] = None
                  ) -> List[torch.device]:
    """The first ``n_stages`` of ``devices`` (default: every visible
    card), one a stage.  Raises ValueError when fewer are given."""
    devices = [torch.device(d) for d in (visible_devices() if devices is None
                                         else devices)]
    if len(devices) < n_stages:
        raise ValueError(f"pipeline needs {n_stages} devices, only "
                         f"{len(devices)} given")
    return devices[:n_stages]


def production_mesh_shape(multi_pod: bool = False):
    """The reference's production meshes (``make_production_mesh``) as
    shapes: (16, 16) ``("data", "model")`` for one pod, (2, 16, 16)
    ``("pod", "data", "model")`` for two (512 devices)."""
    from repro_torch.distributed.context import MeshShape

    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))

"""Three-term roofline of one step on the H100: the port of
``repro/roofline/analysis.py``.

  compute    = FLOPs_per_device / peak FLOP/s of the step's units
  memory     = bytes_per_device / HBM bandwidth
  collective = each collective's wire bytes / the bandwidth of the slowest
               link its group crosses, summed

The peak is the bf16 tensor cores' for 16-bit steps and the fp32
products' as 3xTF32 (``peak_flops_tf32 / 3``) for fp32 steps: the port's
fp32 products run as three TF32 products on the tensor cores.  There is
no HLO in the port, so the dry run (``launch/dryrun.py``) builds
``CellStats`` itself: FLOPs and bytes from a traced step, collectives from
the partition rules, each a ``CollectiveOp`` priced by the reference's
ring model, per device:

     all-reduce          2*S*(G-1)/G     (S = per-device result bytes)
     all-gather          S*(G-1)/G       (S = gathered result bytes)
     reduce-scatter      S*(G-1)         (S = scattered result bytes)
     all-to-all          S*(G-1)/G
     collective-permute  S

on NVLink inside a node of ``hw.gpus_per_node`` GPUs and on InfiniBand
between nodes, the mesh's last axis innermost (``link_bandwidth``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence

from repro_torch.hw import H100, ChipSpec


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int

    @property
    def wire_bytes(self) -> float:
        s, g = self.result_bytes, max(self.group_size, 1)
        if self.kind == "collective-permute":
            return float(s)  # point-to-point: no replica_groups attribute
        if g == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * s * (g - 1) / g
        if self.kind == "all-gather":
            return s * (g - 1) / g
        if self.kind == "reduce-scatter":
            return float(s * (g - 1))
        if self.kind == "all-to-all":
            return s * (g - 1) / g
        return float(s)  # collective-permute


@dataclasses.dataclass
class CellStats:
    """Per-device figures of one step.  ``collective_time_s``: the
    collectives priced op by op on their links (``price``)."""

    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_counts: Optional[Dict[str, int]] = None
    arg_bytes: float = 0.0
    temp_bytes: float = 0.0
    out_bytes: float = 0.0
    collective_time_s: float = 0.0

    def __add__(self, other: CellStats) -> CellStats:
        counts = dict(self.collective_counts or {})
        for k, v in (other.collective_counts or {}).items():
            counts[k] = counts.get(k, 0) + v
        return CellStats(
            self.flops_per_device + other.flops_per_device,
            self.bytes_per_device + other.bytes_per_device,
            self.collective_wire_bytes + other.collective_wire_bytes,
            counts,
            max(self.arg_bytes, other.arg_bytes),
            max(self.temp_bytes, other.temp_bytes),
            max(self.out_bytes, other.out_bytes),
            self.collective_time_s + other.collective_time_s,
        )

    def scale(self, k: float) -> CellStats:
        return CellStats(
            self.flops_per_device * k,
            self.bytes_per_device * k,
            self.collective_wire_bytes * k,
            {kk: int(v * k) for kk, v in (self.collective_counts or {}).items()},
            self.arg_bytes, self.temp_bytes, self.out_bytes,
            self.collective_time_s * k,
        )


def link_bandwidth(shape: Sequence[int], group_dims: Sequence[int],
                   hw: ChipSpec = H100) -> float:
    """B/s of the slowest link a group crosses: the group of mesh dims
    ``group_dims`` (indices into ``shape``, row-major, the last dim
    innermost) through device 0; NVLink if all of it lies in one node of
    ``hw.gpus_per_node`` devices, else InfiniBand."""
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    nodes = {sum(c * strides[d] for c, d in zip(coords, group_dims))
             // hw.gpus_per_node
             for coords in itertools.product(*(range(shape[d]) for d in group_dims))}
    return hw.nvlink_bandwidth if len(nodes) == 1 else hw.ib_bandwidth


def price(ops: Sequence[CollectiveOp], bandwidths: Sequence[float]) -> CellStats:
    """``CellStats`` of collectives alone: wire bytes, counts by kind and
    time, each op at its link's bandwidth."""
    counts: Dict[str, int] = {}
    for op in ops:
        counts[op.kind] = counts.get(op.kind, 0) + 1
    return CellStats(
        collective_wire_bytes=sum(op.wire_bytes for op in ops),
        collective_counts=counts,
        collective_time_s=sum(op.wire_bytes / bw for op, bw in zip(ops, bandwidths)),
    )


@dataclasses.dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    chips: int
    stats: CellStats

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_frac(self) -> float:
        """compute term / achieved bound = fraction of roofline attained."""
        return self.compute_s / max(self.bound_time_s, 1e-30)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops_global, 1.0)

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "roofline_frac": self.roofline_frac,
            "model_flops": self.model_flops,
            "hlo_flops_global": self.hlo_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "chips": self.chips,
            "flops_per_device": self.stats.flops_per_device,
            "bytes_per_device": self.stats.bytes_per_device,
            "collective_wire_bytes": self.stats.collective_wire_bytes,
            "collective_counts": self.stats.collective_counts,
            "arg_bytes_per_device": self.stats.arg_bytes,
            "temp_bytes_per_device": self.stats.temp_bytes,
        }


def peak_flops(hw: ChipSpec, dtype: str) -> float:
    """FLOP/s of the units a step of ``dtype`` runs its products on."""
    if dtype in ("bfloat16", "float16"):
        return hw.peak_flops_bf16
    return hw.peak_rate("tf32x3")


def roofline(stats: CellStats, chips: int, model_flops: float,
             hw: ChipSpec = H100, dtype: str = "bfloat16") -> RooflineReport:
    return RooflineReport(
        compute_s=stats.flops_per_device / peak_flops(hw, dtype),
        memory_s=stats.bytes_per_device / hw.hbm_bandwidth,
        collective_s=stats.collective_time_s,
        model_flops=model_flops,
        hlo_flops_global=stats.flops_per_device * chips,
        chips=chips,
        stats=stats,
    )


def model_flops_for(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N_active*B (one decode step)."""
    n_active = cfg.active_param_count()
    d_tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * d_tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * d_tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq

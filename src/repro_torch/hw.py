"""Target-hardware constants: one NVIDIA H100 SXM.

From NVIDIA's H100 data sheet and the Hopper architecture white paper.
``check_device`` holds the card's reported properties against these.
The fp32 peak is the non-tensor-core rate: every fp32 kernel of the port
runs fp32 FMA on CUDA cores (no TF32), so that is the rate an fp32 bound
divides by.  An int8 bound divides by the dense int8 tensor-core peak, the
least time the card could take for the work, though the int8 kernels run
dp4a on the CUDA cores.  A bf16 bound divides by the dense bf16
tensor-core peak: the units the bf16 flash-attention kernel runs on
(through mma.sync).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "h100_sxm"
    sm_count: int = 132
    smem_per_block_bytes: int = 232_448      # 227 KB opt-in dynamic smem
    l2_bytes: int = 50 * 1024**2             # 50 MB (binary, as cache sizes are)
    hbm_bytes: int = 80 * 1000**3            # 80 GB
    hbm_bandwidth: float = 3.35e12           # B/s
    peak_flops_fp32: float = 67e12           # FLOP/s, CUDA cores, no TF32
    peak_ops_int8: float = 1979e12           # OP/s, dense int8 tensor cores
    # FLOP/s, dense bf16 tensor cores (NVIDIA H100 SXM data sheet, without
    # sparsity).
    peak_flops_bf16: float = 989e12


H100 = ChipSpec()


def check_device(device=0, spec: ChipSpec = H100) -> Dict[str, object]:
    """The card's reported properties beside ``spec``: (reported, spec) pairs.

    Only the fields ``torch.cuda.get_device_properties`` exposes are
    compared; bandwidth and peak rate are not reported there.
    """
    import torch

    p = torch.cuda.get_device_properties(device)
    return {
        "sm_count": (p.multi_processor_count, spec.sm_count),
        "smem_per_block_bytes": (
            getattr(p, "shared_memory_per_block_optin", None),
            spec.smem_per_block_bytes,
        ),
        "l2_bytes": (getattr(p, "L2_cache_size", None), spec.l2_bytes),
        "hbm_bytes": (p.total_memory, spec.hbm_bytes),
    }

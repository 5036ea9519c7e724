"""Target-hardware constants: one NVIDIA H100 SXM.

From NVIDIA's H100 data sheet and the Hopper architecture white paper.
``check_device`` holds the card's reported properties against these.
Each bound divides by the peak of the units the kernel's work needs:

- ``peak_flops_fp32``, fp32 FMA on the CUDA cores (no TF32): the fp32
  im2col conv, the Winograd kernels other than the tuple multiply, and
  fp32 flash attention.
- ``peak_flops_tf32``, dense TF32 on the tensor cores: the fp32 GEMM and
  the 3-pass tuple multiply run three TF32 products per fp32 product
  (3xTF32, fp32 accuracy), so their bound is 3 x FLOPs over this peak:
  165 TFLOP/s of fp32-accurate products on those units, against 67 on the
  CUDA cores.
- ``peak_ops_int8``, dense int8 on the tensor cores: the least time the
  card could take for the int8 kernels' work, though they run dp4a on the
  CUDA cores.
- ``peak_flops_bf16``, dense bf16 on the tensor cores: the units the bf16
  flash-attention kernel runs on (through mma.sync).
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
    peak_flops_tf32: float = 495e12          # FLOP/s, dense TF32 tensor cores
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

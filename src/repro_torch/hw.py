"""Target-hardware constants: one NVIDIA H100 SXM.

From NVIDIA's H100 data sheet and the Hopper architecture white paper.
``check_device`` holds the card's reported properties against these.
Each bound divides by the peak of the units the kernel's work needs:

- ``peak_flops_fp32``, fp32 FMA on the CUDA cores (no TF32): the fp32
  im2col conv and the Winograd transforms.
- ``peak_flops_tf32``, dense TF32 on the tensor cores: the fp32 GEMM, the
  3-pass tuple multiply, the fused Winograd kernel's products and fp32
  flash attention run three TF32 products per fp32 product (3xTF32, fp32
  accuracy), so their bound is 3 x FLOPs over this peak: 165 TFLOP/s of
  fp32-accurate products on those units, against 67 on the CUDA cores.
- ``peak_ops_int8``, dense int8 on the tensor cores: the units the int8
  GEMM and the int8 conv run on (through mma.sync).
- ``peak_flops_bf16``, dense bf16 on the tensor cores: the units the bf16
  flash-attention kernel runs on (through mma.sync).

``peak_rate(unit)`` names those units for the cost model
(core/smem_model.py): 'tf32x3' (fp32 products as three TF32 products,
``peak_flops_tf32 / 3``), 'fp32' (the CUDA cores), 'bf16' (bf16 and fp16
tensor cores), 'int8' (s8 tensor cores).  The model's own constants -- the fixed cost of a launch in a
replayed CUDA graph and each kernel's share of its roofline -- are
measured on the card, not taken from a data sheet: each names its source.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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
    # Shared memory of one SM (228 KB), of which one block may take
    # ``smem_per_block_bytes``: bounds the resident blocks of a tile.
    smem_per_sm_bytes: int = 233_472
    # The cost model's cost of one node of a replayed CUDA graph beyond its
    # kernel's duration: nodes start 0.5 us apart in chip_smoke.py's
    # profiles of replayed forwards (PERF.md section 6).
    launch_s: float = 0.5e-6
    # Each kernel's (fixed seconds a launch, share of its roofline):
    # duration = fixed + max(compute, memory) / share, as
    # scripts/cost_model_fit.py fits them to the card's per-call times
    # ('glue': PyTorch's launches around a conv).
    # The fit of 149 fp32 and int8 candidate calls of YOLOv3-tiny 416
    # b1/b4, MODEL_20 608 b1 and VGG-16 224 b1 on "NVIDIA H100 80GB HBM3,
    # 700.00 W" by scripts/cost_model_fit.py, and of 112 bf16 ones of the
    # same convs appended to them in a later run ('..._16' and 'glue_16',
    # fit apart, so no fp32 or int8 entry moved); the records are
    # scripts/cost_model_records_h100.json (PERF.md section 6).  A share
    # above 1: the operands stayed in the 50 MB L2.
    kernel_fit: Tuple[Tuple[str, float, float], ...] = (
        ("gemm", 1.7e-6, 0.3657),
        ("gemm_q8", 3.0e-6, 0.7479),
        ("im2col_conv", 5.5e-6, 0.3911),
        ("im2col_conv_q8", 3.7e-6, 0.1094),
        ("winograd_fused", 0.7e-6, 0.3420),
        ("input_transform", 2.7e-6, 1.5641),
        ("tuple_multiply", 1.1e-6, 0.4891),
        ("output_transform", 3.1e-6, 1.3375),
        ("gemm_reduce", 1.8e-6, 1.2508),
        ("gemm_q8_reduce", 2.0e-6, 1.8704),
        ("im2col_conv_reduce", 1.6e-6, 0.8944),
        ("im2col_conv_q8_reduce", 1.1e-6, 0.5593),
        ("gemm_16", 2.3e-6, 0.3999),
        ("im2col_conv_16", 0.6e-6, 0.1223),
        ("winograd_fused_16", 0.0, 0.2735),
        ("input_transform_16", 2.7e-6, 1.3678),
        ("tuple_multiply_16", 3.7e-6, 0.5849),
        ("output_transform_16", 2.2e-6, 1.3375),
        ("gemm_16_reduce", 1.7e-6, 1.5641),
        ("im2col_conv_16_reduce", 2.0e-6, 4.0000),
        ("glue", 1.4e-6, 0.8746),
        ("glue_16", 1.7e-6, 0.5593),
    )

    def peak_rate(self, unit: str) -> float:
        """Peak operations a second of the units ``unit`` names."""
        rates = {"tf32x3": self.peak_flops_tf32 / 3,
                 "fp32": self.peak_flops_fp32,
                 "bf16": self.peak_flops_bf16,
                 "int8": self.peak_ops_int8}
        if unit not in rates:
            raise ValueError(f"unknown units {unit!r}; one of {sorted(rates)}")
        return rates[unit]

    def kernel_cost(self, kernel: str) -> Tuple[float, float]:
        """(fixed seconds a launch, share of its roofline) of ``kernel``;
        raises for a kernel the model was never fit to (nothing is priced
        by a guess)."""
        for name, fixed_s, share in self.kernel_fit:
            if name == kernel:
                return fixed_s, share
        raise KeyError(f"{self.name}: no fit for kernel {kernel!r} "
                       f"(scripts/cost_model_fit.py)")

    @property
    def fit_digest(self) -> str:
        """A short digest of the cost model's measured constants
        (``launch_s``, ``kernel_fit``): it keys the cache's model-mode
        entries, so a refit never reuses a plan priced by the old ones."""
        import hashlib

        return hashlib.sha1(
            repr((self.launch_s, self.kernel_fit)).encode()).hexdigest()[:8]


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
        "smem_per_sm_bytes": (
            getattr(p, "shared_memory_per_multiprocessor", None),
            spec.smem_per_sm_bytes,
        ),
        "l2_bytes": (getattr(p, "L2_cache_size", None), spec.l2_bytes),
        "hbm_bytes": (p.total_memory, spec.hbm_bytes),
    }

"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface (it may include the
``.cuh`` headers beside it, and those of the shared directory ``csrc/``
here, such as the fp32 tensor-core GEMM core ``sgemm_3xtf32.cuh`` and its
bf16/fp16 twin ``hmma16.cuh``) and is
compiled on first use, for ``sm_90a``, into its own shared library under
``build/repro_torch/`` at the repository root (the file name carries a
digest of the source, every header it includes and the flags, so an
edited source or header is rebuilt and never confused with an old
library).  ``build`` starts one nvcc per source, all at once.  A failed
build raises with nvcc's output: nothing falls back to a plain version.

Nothing here runs at import time, so the CPU tests import every module of
the port on a machine that has neither nvcc nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

_KERNELS_DIR = Path(__file__).resolve().parent

#: name -> source, relative to this directory.
SOURCES: Dict[str, str] = {
    "gemm": "gemm/csrc/gemm.cu",
    "gemm_q8": "gemm/csrc/gemm_q8.cu",
    "im2col_conv": "im2col_gemm/csrc/im2col_conv.cu",
    "im2col_conv_q8": "im2col_gemm/csrc/im2col_conv_q8.cu",
    "winograd_fused": "winograd/csrc/winograd_fused.cu",
    "winograd_3pass": "winograd/csrc/winograd_3pass.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "gemm_16": "gemm/csrc/gemm_16.cu",
    "im2col_conv_16": "im2col_gemm/csrc/im2col_conv_16.cu",
    "winograd_fused_16": "winograd/csrc/winograd_fused_16.cu",
    "winograd_3pass_16": "winograd/csrc/winograd_3pass_16.cu",
}

#: The code of each 16-bit element type in the C entries of the 16-bit
#: kernels (one template instance each).
DTYPE16_CODES = {torch.bfloat16: 0, torch.float16: 1}

BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch"

#: Headers any source may include, relative to this directory (nvcc runs
#: here, so ``-I`` names it as is).
SHARED_INCLUDE = "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-I", SHARED_INCLUDE,
)

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_libraries: Dict[str, ctypes.CDLL] = {}
#: name -> nvcc's output of the build this process made (ptxas register and
#: spill counts), for reports; empty for a library that was already built.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch cannot be built"
    )


def included_headers(src: Path) -> List[Path]:
    """Every header ``src`` includes with quotes, transitively, each found
    as nvcc finds it: beside the including file, else in the shared
    directory."""
    found: List[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop()
        for name in _INCLUDE.findall(cur.read_bytes()):
            name = name.decode()
            for cand in (cur.parent / name, _KERNELS_DIR / SHARED_INCLUDE / name):
                if cand.is_file():
                    if cand not in found:
                        found.append(cand)
                        todo.append(cand)
                    break
    return sorted(found)


def library_path(name: str) -> Path:
    """The library of source ``name``; its digest covers the source, every
    header it includes (``included_headers``) and the flags."""
    src = _KERNELS_DIR / SOURCES[name]
    text = src.read_bytes() + b"".join(
        h.name.encode() + h.read_bytes() for h in included_headers(src))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once.

    Returns name -> library path.  Raises RuntimeError naming each source
    nvcc rejected, with its output.
    """
    names = list(SOURCES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_KERNELS_DIR / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=_KERNELS_DIR,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode == 0:
            os.replace(tmp, paths[n])
        else:
            os.unlink(tmp)
            failed.append(f"--- {SOURCES[n]} (nvcc exit {proc.returncode})\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str, symbol: str, argtypes: Sequence[type]):
    """The C entry ``symbol`` of library ``name``, built on first use.

    ``argtypes`` must name ``ctypes.c_void_p`` for every pointer and the
    stream and ``ctypes.c_int`` for every int; every entry returns the int
    value of ``cudaGetLastError()``.
    """
    if name not in _libraries:
        _libraries[name] = ctypes.CDLL(str(build([name])[name]))
    fn = getattr(_libraries[name], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise unless a C entry returned cudaSuccess (0)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_cuda_operands(what: str, *tensors,
                          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every given tensor (None skipped) is a contiguous
    tensor of ``dtype`` on the current card — what the C entries take (an
    int8 entry checks its int8 operands and its fp32 ones in two calls).

    The libraries link the CUDA runtime statically and launch on the
    current device, the one ``torch.cuda.device(...)`` sets (the
    executors of a stage or shard on another card run under it); a
    tensor on another card is refused, and a CPU tensor is refused, never
    computed with the plain version instead.
    """
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(
                f"{what}: impl='cuda' needs CUDA tensors, got one on "
                f"{t.device} (ask for impl='torch' to run the plain version)"
            )
        current = torch.cuda.current_device()
        if t.device.index not in (None, current):
            raise ValueError(f"{what}: the kernels launch on the current "
                             f"device cuda:{current}, got a tensor on "
                             f"{t.device} (run under torch.cuda.device)")
        if t.dtype != dtype:
            raise ValueError(f"{what}: needs {str(dtype).split('.')[-1]} "
                             f"tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous tensors")


def require_dtype(what: str, dtype: torch.dtype, *tensors) -> None:
    """Raise unless every given tensor (None skipped) is of ``dtype``, on
    any device: a wrapper takes its own type and never casts quietly."""
    for t in tensors:
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{what}: needs {str(dtype).split('.')[-1]} "
                             f"tensors, got {t.dtype}")


def require_16bit(what: str, *tensors) -> torch.dtype:
    """The one 16-bit type (bf16 or fp16) of all the given tensors; raises
    on any other type or a mix."""
    dtype = tensors[0].dtype
    if dtype not in DTYPE16_CODES:
        raise ValueError(f"{what}: needs bfloat16 or float16 tensors, got "
                         f"{dtype}")
    require_dtype(what, dtype, *tensors)
    return dtype


def require_int32_exact(what: str, k: int) -> None:
    """Raise unless an int8 x int8 sum over ``k`` products is exact in
    int32: k * 127^2 < 2^31 (the operands are clipped to [-127, 127])."""
    if k * 127 * 127 >= 2 ** 31:
        raise ValueError(f"{what}: K = {k} products of int8 values can "
                         f"overflow the int32 accumulator (K * 127^2 >= 2^31)")


def stream_handle(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int.

    Under ``torch.cuda.graph`` that is the capture stream, and a launch of
    these libraries, each with its own static CUDA runtime, is recorded
    into the graph like any other launch on it (no shared runtime needed:
    ``tests/test_torch_cuda.py::test_kernel_launch_is_captured_by_a_cuda_graph``).
    """
    return torch.cuda.current_stream(t.device).cuda_stream

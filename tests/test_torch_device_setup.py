"""Each kernel launch function keeps its one-time setup per device.

``cudaFuncSetAttribute`` (a kernel's dynamic shared memory above 48 KB)
and a device's properties (its SM count) hold for the current device only.
A launch function that guards that setup with one process-wide ``static``
flag sets it up on the first card it runs on and never on a second one:
every launch of a stage or shard there above 48 KB would fail.  This test
reads every CUDA source of the port that calls ``cudaFuncSetAttribute``
and holds each ``static`` of its launch functions to a per-device array,
``[per_device::MAX_DEVICES]``, indexed by the ordinal
``per_device::current`` gives (kernels/csrc/per_device.cuh).  The card
runs the guards in every kernel check of chip_smoke.py.
"""
import re
from pathlib import Path

import pytest

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
SOURCES = sorted(p for p in KERNELS.rglob("*.cu*")
                 if "cudaFuncSetAttribute(" in p.read_text())
# A mutable static: not constexpr, no function, no assert, not in device
# code (``__device__``, ``__shared__``).
STATIC = re.compile(
    r"^\s*static\s+(?!constexpr|inline|__|_assert)[\w:<>]+\s+(\w+)\s*"
    r"(\[[^\]]*\])?\s*(=[^;]*)?;", re.MULTILINE)


def _functions_with(text, needle):
    """The bodies of the top-level functions (brace-matched) that contain
    ``needle``."""
    bodies = []
    for m in re.finditer(r"\)\s*(const\s*)?\{", text):
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        body = text[m.end():i]
        if needle in body and not any(body in b for b in bodies):
            bodies = [b for b in bodies if b not in body] + [body]
    return bodies


def test_the_sources_that_set_attributes_are_found():
    names = {p.name for p in SOURCES}
    assert names == {
        "winograd_fused.cu", "winograd_fused_16.cu", "winograd_3pass_16.cu",
        "gemm_16.cu", "gemm_q8.cu", "im2col_conv.cu", "im2col_conv_q8.cu",
        "im2col_conv_16.cu", "flash_attention_bf16.cuh",
        "flash_attention_fp32.cuh", "flash_attention_bwd.cu"}


@pytest.mark.parametrize("src", SOURCES, ids=[p.name for p in SOURCES])
def test_launch_setup_is_kept_per_device(src):
    text = src.read_text()
    assert '#include "per_device.cuh"' in text
    bodies = _functions_with(text, "cudaFuncSetAttribute(")
    assert bodies
    for body in bodies:
        statics = STATIC.findall(body)
        assert statics, f"{src.name}: no guard around cudaFuncSetAttribute"
        assert "per_device::current(&dev)" in body
        for name, dims, _ in statics:
            assert dims == "[per_device::MAX_DEVICES]", (
                f"{src.name}: static {name} is one value for every device")
            # The declaration, then every use indexed by the device.
            uses = re.findall(rf"\b{name}\b(\[\w+\])?", body)[1:]
            assert uses and all(u == "[dev]" for u in uses), (
                f"{src.name}: {name} used without [dev]: {uses}")


def test_the_check_catches_a_process_wide_guard():
    """The old guard, one flag for the process, is what the check refuses."""
    old = """int launch() {
  static bool smem_set = false;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 1);
    smem_set = true;
  }
}"""
    (body,) = _functions_with(old, "cudaFuncSetAttribute(")
    ((name, dims, _),) = STATIC.findall(body)
    assert name == "smem_set" and dims != "[per_device::MAX_DEVICES]"

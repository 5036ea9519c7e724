"""``repro_torch.roofline`` against the reference's ``repro.roofline`` on
the same figures: the ring model's wire bytes for every kind and group
size, ``CellStats`` arithmetic, the roofline report given the reference a
``ChipSpec`` with the H100's numbers, and ``model_flops_for`` of every
runnable cell; the link a collective is priced on; ``hw.py``'s link
bandwidths and its unchanged ``check_device``."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.hw import ChipSpec as RefChipSpec
from repro.roofline import analysis as ref_ra
from repro_torch import configs
from repro_torch.hw import H100, check_device
from repro_torch.roofline import analysis as ra

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
#: The reference's ChipSpec with the H100's rates: its fp32 peak is the
#: port's fp32 products as 3xTF32, its one link NVLink's bandwidth.
REF_H100 = RefChipSpec(name="h100_sxm", peak_flops_bf16=H100.peak_flops_bf16,
                       peak_flops_fp32=H100.peak_flops_tf32 / 3,
                       hbm_bandwidth=H100.hbm_bandwidth,
                       ici_link_bandwidth=H100.nvlink_bandwidth)


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_the_reference(kind):
    for g in (1, 2, 3, 8, 16, 32, 256, 512):
        for s in (0, 1, 4096, 123_456_789):
            got = ra.CollectiveOp(kind, s, g).wire_bytes
            assert got == ref_ra.CollectiveOp(kind, s, g).wire_bytes, (g, s)


def _stats(rng):
    """(the port's, the reference's) ``CellStats`` of the same random
    figures, with up to 20 random collectives priced by ``price`` at
    NVLink's bandwidth, the reference's one link."""
    v = rng.uniform(0, 1e15, size=6)
    ops = [ra.CollectiveOp(KINDS[int(i)], int(rng.integers(0, 1 << 40)),
                           int(rng.integers(1, 513)))
           for i in rng.integers(0, len(KINDS), size=int(rng.integers(0, 21)))]
    coll = ra.price(ops, [H100.nvlink_bandwidth] * len(ops))
    wire, counts = coll.collective_wire_bytes, coll.collective_counts
    port = ra.CellStats(v[0], v[1], wire, counts, v[2], v[3], v[4],
                        coll.collective_time_s)
    ref = ref_ra.CellStats(v[0], v[1], wire, dict(counts), v[2], v[3], v[4])
    return port, ref


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_roofline_report_equals_the_reference(dtype):
    """Every figure equal, but the collective term and what reads it (the
    bound, the fraction): the port sums each op's time, the reference
    divides the summed wire bytes by its link, the same to a relative
    1e-12."""
    rng = np.random.default_rng(0)
    for chips in (1, 256, 512):
        for _ in range(5):
            a, b = _stats(rng)
            model = float(rng.uniform(1e12, 1e18))
            got = ra.roofline(a, chips, model, dtype=dtype)
            want = ref_ra.roofline(b, chips, model, hw=REF_H100, dtype=dtype)
            g, w = got.as_dict(), want.as_dict()
            near = ("collective_s", "roofline_frac")
            assert [g.pop(k) for k in near] == pytest.approx(
                [w.pop(k) for k in near], rel=1e-12)
            assert g == w
            assert got.bound_time_s == pytest.approx(want.bound_time_s, rel=1e-12)
            s2 = a + a.scale(3)
            r2 = b + b.scale(3)
            assert [getattr(s2, f.name) for f in dataclasses.fields(r2)] == [
                getattr(r2, f.name) for f in dataclasses.fields(r2)]
            assert s2.collective_time_s == pytest.approx(
                r2.collective_wire_bytes / H100.nvlink_bandwidth, rel=1e-12)


def test_priced_collectives_use_their_links():
    """Each op at its link: a roofline of priced stats reads their time,
    not the wire bytes at NVLink's rate."""
    ops = [ra.CollectiveOp("all-reduce", 1 << 20, 16),
           ra.CollectiveOp("all-gather", 1 << 22, 8)]
    stats = ra.price(ops, [H100.ib_bandwidth, H100.nvlink_bandwidth])
    assert stats.collective_counts == {"all-reduce": 1, "all-gather": 1}
    want = ops[0].wire_bytes / 50e9 + ops[1].wire_bytes / 450e9
    assert stats.collective_time_s == pytest.approx(want, rel=1e-15)
    assert ra.roofline(stats, 16, 1.0).collective_s == stats.collective_time_s
    assert (stats + stats).collective_time_s == 2 * stats.collective_time_s


def test_link_bandwidth_by_node():
    """Eight GPUs a node, the mesh's last axis innermost."""
    nv, ib = H100.nvlink_bandwidth, H100.ib_bandwidth
    assert ra.link_bandwidth((16, 16), [1]) == ib          # model: two nodes
    assert ra.link_bandwidth((16, 16), [0]) == ib          # data: 16 nodes
    assert ra.link_bandwidth((32, 8), [1]) == nv           # model: one node
    assert ra.link_bandwidth((32, 8), [0]) == ib
    assert ra.link_bandwidth((2, 4), [0, 1]) == nv
    assert ra.link_bandwidth((2, 16, 16), [0, 1]) == ib
    assert ra.link_bandwidth((64, 2, 4), [2]) == nv


def test_model_flops_equal_the_reference():
    n = 0
    for arch in configs.ARCHS:
        for name, shape in configs.SHAPES.items():
            cfg = configs.get_config(arch)
            if not configs.cell_is_runnable(cfg, shape)[0]:
                continue
            want = ref_ra.model_flops_for(ref_configs.get_config(arch),
                                          ref_configs.base.SHAPES[name])
            assert ra.model_flops_for(cfg, shape) == want, (arch, name)
            n += 1
    assert n >= 30


def test_peaks_and_links_in_hw():
    """The link bandwidths and their units; a bf16 step's peak is the
    bf16 tensor cores', an fp32 step's the 3xTF32 products'."""
    assert H100.nvlink_bandwidth == 450e9 and H100.ib_bandwidth == 50e9
    assert H100.gpus_per_node == 8
    assert ra.peak_flops(H100, "bfloat16") == 989e12
    assert ra.peak_flops(H100, "float32") == 495e12 / 3


def test_check_device_is_unchanged(monkeypatch):
    """``check_device`` reads the same properties, beside the same spec
    fields, as before the link bandwidths were added."""
    props = types.SimpleNamespace(
        multi_processor_count=132, shared_memory_per_block_optin=232_448,
        shared_memory_per_multiprocessor=233_472, L2_cache_size=50 * 1024 ** 2,
        total_memory=85_000_000_000)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)
    assert check_device() == {
        "sm_count": (132, 132),
        "smem_per_block_bytes": (232_448, 232_448),
        "smem_per_sm_bytes": (233_472, 233_472),
        "l2_bytes": (50 * 1024 ** 2, 50 * 1024 ** 2),
        "hbm_bytes": (85_000_000_000, 80 * 1000 ** 3),
    }

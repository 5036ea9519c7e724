"""``repro_torch.launch.dryrun`` on the CPU: the traced FLOPs of a smoke
train, prefill and decode cell against an analytic count written here;
the collectives the rules give; the CLI's JSON (the reference's keys)
for Llama-3.2-1B's train_4k cell at full width, and the roofline table
over it; ``opt_sweep.overrides_for`` against the reference's."""
import json

import pytest

from repro.launch import opt_sweep as ref_opt_sweep
from repro.roofline.analysis import CellStats as RefCellStats
from repro.roofline.analysis import roofline as ref_roofline
from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.distributed.context import MeshShape
from repro_torch.launch import dryrun, opt_sweep
from repro_torch.roofline import table

ONE = MeshShape(("data", "model"), (1, 1))


def _pairs(s, causal=True):
    return s * (s + 1) // 2 if causal else s * s


def _analytic(cfg, shape, capacity=None):
    """FLOPs of one step of a dense attention + SwiGLU config with a tied
    head: each product 2 m n k; the backward two products per forward
    one (dx and dw); remat "full" runs the layers' forward again in the
    backward, up to the last output the backward needs (PyTorch's
    checkpoint stops early: a period's last product, the MLP's w_down, is
    not run again); attention 4 hd a valid pair and query head forward,
    10 backward; a decode step's attention over the whole cache (the plain
    einsums)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    layer = 2 * d * hd * (h + 2 * kv) + 2 * h * hd * d + 3 * 2 * d * f
    head = 2 * d * v
    n = cfg.num_layers
    b = shape.global_batch
    if shape.kind == "decode":
        return b * (n * layer + head) + n * b * h * 4 * hd * capacity
    tokens = b * shape.seq_len
    attn = b * h * hd * _pairs(shape.seq_len)
    if shape.kind == "prefill":
        return tokens * (n * layer + head) + n * 4 * attn
    again = cfg.remat != "none"
    return (tokens * (n * layer * 3 + head * 3 + again * n * (layer - 2 * d * f))
            + n * attn * (4 * (1 + again) + 10))


@pytest.mark.parametrize("kind,grad_accum", [("train", 1), ("train", 2),
                                             ("prefill", 1), ("decode", 1)])
def test_traced_flops_equal_the_analytic_count(kind, grad_accum):
    cfg = configs.smoke_config("llama3.2-1b")
    shape = ShapeSpec(kind, 32, 4, kind)
    r = dryrun.build_cell("llama3.2-1b", kind, overrides={"grad_accum": grad_accum},
                          mesh=ONE, shape=shape, cfg=cfg)
    want = _analytic(cfg, shape, capacity=shape.seq_len)
    assert r["roofline"]["hlo_flops_global"] == want
    assert r["roofline"]["flops_per_device"] == want
    att = r["attention"]
    calls = {"train": 3 * cfg.num_layers * grad_accum, "prefill": cfg.num_layers,
             "decode": 0}[kind]
    assert att["calls"] == calls
    if kind != "decode":
        assert att["flops_dense"] > att["flops_valid_pairs"] > 0
        assert att["hlo_flops_global_dense_attention"] - want == (
            att["flops_dense"] - att["flops_valid_pairs"])
    assert r["roofline"]["collective_counts"] == {}
    assert r["memory"]["temp_bytes"] > 0 and r["memory"]["argument_bytes"] > 0


def test_trace_counts_only_storages_the_step_makes():
    """Temporaries are the storages the step makes: a view of an argument
    (a weight's transpose, kept to the end as a backward keeps it) adds
    nothing, where the arguments are counted apart; y = x w (8 x 32 fp32)
    and 2 y alive together peak at 2 x 1024 bytes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()
    with fake:
        w, x = torch.zeros(64, 32), torch.zeros(8, 64)

    def fn(steps, w, x):
        wt = w.t()
        y = x @ w
        return (y * 2).t(), wt, x[:4]

    assert dryrun.trace(fake, fn, w, x).peak_temp_bytes == 2 * 8 * 32 * 4


def _counts(mode, mesh=MeshShape(("data", "model"), (16, 16))):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import tree as tree_lib
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, adamw, constant

    cfg = configs.get_config("llama3.2-1b")
    with FakeTensorMode():
        params = tf.init_params(cfg, torch.Generator())
        opt = adamw.init(AdamWConfig(lr=constant(1e-4)), params)
    axes = mesh.axis_names if mode != "default" else shd.DP
    psh = (shd.param_specs(params, mesh) if mode == "default"
           else tree_lib.tree_map(lambda _: (), params))
    osh = shd.opt_state_specs(opt, params, mesh, dp_axes=axes, psh=psh)
    ops = dryrun.collectives(cfg, configs.SHAPES["train_4k"], mesh, mode, 1,
                             params, psh, osh.m)
    counts = {}
    for op, _ in ops:
        counts[op.kind] = counts.get(op.kind, 0) + 1
    return counts, ops


def test_rules_collectives_of_llama_train():
    """Default mode on the single pod: per layer two blocks, each one
    all-reduce forward, again in the recompute and one backward; the
    embedding's; the head's three row all-reduces and its backward; a
    reduce-scatter and an all-gather per ZeRO leaf, over ``data``.
    dp_only: only the ZeRO pair, over every chip."""
    leaves = 2 + 16 * 9
    counts, ops = _counts("default")
    assert counts == {"all-reduce": 16 * 2 * 3 + 1 + 4,
                      "reduce-scatter": leaves, "all-gather": leaves}
    assert {op.group_size for op, _ in ops} == {16}
    counts, ops = _counts("dp_only")
    assert counts == {"reduce-scatter": leaves, "all-gather": leaves}
    assert {op.group_size for op, _ in ops} == {256}


def test_cli_writes_the_reference_keys_and_the_table(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape
    train_4k --mesh single --table`` with no card: its JSON holds the
    reference's keys (the roofline's those of the reference's report),
    the three terms, model FLOPs, GiB per device and collective counts;
    the table prints its row."""
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--mesh",
                 "single", "--out", str(tmp_path), "--table"])
    out = capsys.readouterr().out
    r = json.loads((tmp_path / "llama3.2-1b__train_4k__single.json").read_text())
    assert {"arch", "shape", "mesh", "chips", "skipped", "lower_s", "compile_s",
            "moment_dtype", "overrides", "memory", "scan_correction_periods",
            "roofline"} <= set(r)
    ref_keys = ref_roofline(RefCellStats(), 1, 1.0).as_dict().keys()
    assert set(r["roofline"]) == set(ref_keys)
    assert (r["chips"], r["mesh"], r["scan_correction_periods"]) == (256, "16x16", 0)
    rl = r["roofline"]
    assert min(rl["compute_s"], rl["memory_s"], rl["collective_s"]) > 0
    assert rl["model_flops"] == 6 * configs.get_config(
        "llama3.2-1b").active_param_count() * 256 * 4096
    assert r["memory"]["total_per_device_gib"] > 0 and rl["collective_counts"]
    assert "| llama3.2-1b | train_4k | 16x16 |" in out
    rows = table.rows(table.load_cells(str(tmp_path)))
    assert len(rows) == 1 and "dominant=" in rows[0]


def test_overrides_equal_the_reference():
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            for chips in (256, 512):
                assert opt_sweep.overrides_for(arch, shape, chips) == (
                    ref_opt_sweep.overrides_for(arch, shape, chips)), (arch, shape)


def test_unmasked_pairs():
    """The stand-in's pair count is the plain version's mask's."""
    from repro_torch.kernels.flash_attention.ref import attention_mask, unmasked_pairs

    assert unmasked_pairs(5, 5, True, 0) == 15
    assert unmasked_pairs(5, 5, False, 0) == 25
    for s, sk, causal, window in [(9, 7, True, 4), (6, 6, True, 2), (13, 5, False, 0),
                                  (40, 40, True, 7)]:
        assert unmasked_pairs(s, sk, causal, window) == int(
            attention_mask(s, sk, causal, window).sum())

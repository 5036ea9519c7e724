"""The port's copied tables and constants against the JAX package's.

The layer tables of ``repro_torch.configs`` are plain-data copies of
``repro.configs`` (whose modules import JAX); they must stay equal field
by field.  ``params_from_numpy`` must move a reference parameter list into
the port unchanged, and cost mode's rule must give YOLOv3-tiny
at 416x416, batch 1, the split of the reference's cost-mode planner.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import vgg16 as j_vgg16
from repro.configs import yolov3 as j_yolov3
from repro.core import winograd as j_winograd
from repro.models.cnn import init_cnn as j_init_cnn
from repro_torch import configs, hw, util
from repro_torch.configs import vgg16, yolov3
from repro_torch.core import winograd
from repro_torch.core.conv_spec import ConvAlgorithm
from repro_torch.core.netplan import plan_network
from repro_torch.core.planner import Planner
from repro_torch.models.cnn import init_cnn, params_from_numpy


@pytest.mark.parametrize("ours,ref", [
    (yolov3.TINY_LAYERS, j_yolov3.TINY_LAYERS),
    (yolov3.LAYERS_20, j_yolov3.LAYERS_20),
    (vgg16.LAYERS, j_vgg16.LAYERS),
], ids=["yolov3-tiny", "yolov3-20", "vgg16"])
def test_layer_tables_equal_reference(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("ours,ref", [
    (yolov3.TINY_MODEL, j_yolov3.TINY_MODEL),
    (yolov3.MODEL_20, j_yolov3.MODEL_20),
    (vgg16.MODEL, j_vgg16.MODEL),
], ids=["yolov3-tiny", "yolov3-20", "vgg16"])
def test_models_equal_reference(ours, ref):
    assert (ours.name, ours.input_hw, ours.in_channels) == (
        ref.name, tuple(ref.input_hw), ref.in_channels)
    assert [dataclasses.asdict(l) for l in ours.layers] == [
        dataclasses.asdict(l) for l in ref.layers]


def test_input_sizes_equal_reference():
    assert yolov3.INPUT_HW == j_yolov3.INPUT_HW
    assert yolov3.TINY_INPUT_HW == j_yolov3.TINY_INPUT_HW
    assert vgg16.INPUT_HW == j_vgg16.INPUT_HW


def test_winograd_matrices_equal_reference():
    for name in ("BT", "G", "AT"):
        np.testing.assert_array_equal(getattr(winograd, name),
                                      np.asarray(getattr(j_winograd, name)))


def test_params_from_numpy_keeps_reference_params():
    """A reference parameter list (JAX init, as numpy) lands in the port
    bit-identical and in the same layouts."""
    ref = j_init_cnn(jax.random.PRNGKey(3), yolov3.TINY_LAYERS[:8])
    ref = jax.tree_util.tree_map(np.asarray, ref)
    ours = params_from_numpy(ref, device="cpu")
    assert len(ours) == len(ref)
    for p, q in zip(ours, ref):
        assert p.keys() == q.keys()
        flat_p = jax.tree_util.tree_leaves(p)
        flat_q = jax.tree_util.tree_leaves(q)
        for a, b in zip(flat_p, flat_q):
            assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)


def test_init_cnn_shapes_match_reference():
    layers = yolov3.TINY_LAYERS
    ours = init_cnn(np.random.default_rng(0), layers)
    ref = j_init_cnn(jax.random.PRNGKey(0), layers)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), ours) == shapes


def test_planner_split_yolov3_tiny_416():
    """Cost mode's rule gives the reference cost-mode planner's split."""
    netplan = plan_network(yolov3.TINY_LAYERS, *yolov3.TINY_INPUT_HW,
                           Planner(), batch=1)
    got = {s.index: s.plan.algorithm for s in netplan.steps if s.plan}
    want = {i: ConvAlgorithm.WINOGRAD for i in (0, 2, 4, 6)}
    want.update({i: ConvAlgorithm.IM2COL_GEMM for i in (8, 10, 12, 14, 20)})
    want.update({i: ConvAlgorithm.DIRECT for i in (13, 15, 17, 21)})
    assert got == want
    assert netplan.algorithm_counts() == {
        ConvAlgorithm.WINOGRAD: 4, ConvAlgorithm.IM2COL_GEMM: 5,
        ConvAlgorithm.DIRECT: 4}


def test_util_helpers():
    assert [util.ceil_to(x, 8) for x in (1, 8, 9, 255)] == [8, 8, 16, 256]
    bias = torch.arange(3, dtype=torch.float32)
    assert util.pad_bias_row(None, 8) is None
    assert util.pad_bias_row(bias, 3) is bias
    assert util.pad_bias_row(bias, 5).tolist() == [0.0, 1.0, 2.0, 0.0, 0.0]


def test_h100_spec():
    spec = hw.H100
    assert (spec.sm_count, spec.smem_per_block_bytes) == (132, 232_448)
    assert spec.l2_bytes == 50 * 1024**2 and spec.hbm_bytes == 80 * 10**9
    assert (spec.hbm_bandwidth, spec.peak_flops_fp32) == (3.35e12, 67e12)
    assert spec.peak_flops_bf16 == 989e12
    assert not any(hasattr(spec, f) for f in
                   ("vmem_bytes", "sublanes", "lane_width", "mxu_dim"))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_lm_configs_equal_reference(arch):
    """The copied ModelConfigs and their smoke reductions, field by field,
    with the derived quantities."""
    for ours, ref in ((configs.get_config(arch), j_configs.get_config(arch)),
                      (configs.smoke_config(arch), j_configs.smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()
        assert ours.pattern_layers == ref.pattern_layers
        assert ours.resolved_head_dim == ref.resolved_head_dim
    fields = [f.name for f in dataclasses.fields(configs.ModelConfig)]
    assert fields == [f.name for f in dataclasses.fields(type(ref))]


def test_unported_lm_archs_are_the_reference_rest():
    """No arch is left unported: the port's archs are the reference's."""
    assert sorted(configs.ARCHS) == sorted(j_configs.ARCHS)

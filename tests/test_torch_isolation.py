"""The port stands alone and never falls back.

- No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  the JAX package (``repro``); importing every module of the port leaves
  both out of ``sys.modules``.
- The default options run on the card: without one they raise instead of
  running on the CPU, and ``impl='cuda'`` refuses CPU tensors at every
  level, from the facade down to the kernel wrappers.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import yolov3
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.netplan import NetworkExecutor, plan_network
from repro_torch.core.planner import Planner
from repro_torch.models.cnn import init_cnn, params_from_numpy

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_reference():
    assert len(_port_files()) > 20
    bad = [
        (str(p.relative_to(REPO)), m)
        for p in _port_files() for m in _imported_modules(p)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "core/cost_rule.py", "serving/cnn_engine.py", "serving/faults.py",
    "serving/resilience.py", "serving/engine.py", "distributed/pipeline.py",
    "launch/mesh.py", "core/netplan.py", "graphs.py",
    "distributed/context.py", "distributed/sharding.py",
    "distributed/compression.py", "distributed/zero.py",
    "roofline/analysis.py", "roofline/table.py", "launch/dryrun.py",
    "launch/opt_sweep.py"])
def test_the_planner_rule_and_serving_modules_are_walked(module):
    """The cost rule, the serving modules, the multi-device modules (the
    pipeline partition in core/netplan.py, the schedule, the device
    lists), and the LM side of distributed/ with the roofline and the dry
    run, which copy the reference's logic, are among the walked sources
    and import neither JAX nor the reference (the rule's crossovers, the
    pipeline's tick overhead, the partition rules and the ring model are
    copies of their own)."""
    path = PORT / module
    assert path in _port_files()
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in FORBIDDEN]


def test_a_served_cnn_on_the_card_path_never_serves_on_the_cpu():
    """The serving engine runs its compilation's executors: a
    CUDA-planned executor fed a CPU batch raises, and the engine fails the
    request rather than serving it through a plain version."""
    from repro_torch.serving import RequestFailed
    from repro_torch.serving.cnn_engine import CNNServingEngine

    layers = yolov3.TINY_LAYERS[:2]
    model = repro_torch.CNNModel(layers, (32, 32))
    compiled = repro_torch.compile(model, init_cnn(np.random.default_rng(0),
                                                   layers),
                                   repro_torch.ExecutionOptions(
                                       impl="torch", device="cpu"))
    engine = CNNServingEngine.from_compiled(compiled, buckets=(1,))
    cuda_plan = plan_network(layers, 32, 32, Planner(impl="cuda"))
    engine._executors[1] = NetworkExecutor(cuda_plan, compiled.params)
    uid = engine.submit(np.zeros((32, 32, 3), np.float32))
    result = engine.run()[uid]
    assert isinstance(result, RequestFailed)
    assert "needs CUDA tensors" in result.reason
    assert engine.health()["failed_batches"] == 1


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.startswith("ok")


def test_default_options_need_a_card(monkeypatch):
    """``ExecutionOptions()`` asks for the card; where there is none it
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = repro_torch.ExecutionOptions
    assert (opts.impl, opts.device) == ("cuda", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opts(impl="torch")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        opts(impl="cuda", device="cpu")
    assert opts(impl="torch", device="cpu").device == "cpu"


def test_cuda_impl_refuses_cpu_tensors_end_to_end():
    """A CUDA-planned network fed CPU tensors raises at its first kernel."""
    layers = yolov3.TINY_LAYERS[:4]
    netplan = plan_network(layers, 32, 32, Planner(impl="cuda"))
    params = params_from_numpy(init_cnn(np.random.default_rng(0), layers),
                               device="cpu")
    executor = NetworkExecutor(netplan, params)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        executor(torch.zeros(1, 32, 32, 3))


def test_conv2d_defaults_to_cuda():
    x, w = torch.zeros(1, 6, 6, 8), torch.zeros(3, 3, 8, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        repro_torch.conv2d(x, w, ConvSpec(8, 4))
    assert repro_torch.conv2d(x, w, ConvSpec(8, 4), impl="torch").shape == (
        1, 6, 6, 4)

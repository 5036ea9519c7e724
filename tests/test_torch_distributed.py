"""The LM side of ``repro_torch.distributed`` against the reference's
``repro.distributed`` on the CPU: the partition rules, the ZeRO moment
specs, the batch and cache specs and the activation hints, for every
config at full width on both production meshes; the int8 gradient
compression bit for bit; and, on a gloo group of two CPU processes, the
compressed all-reduce and the data-parallel ZeRO train step.

The reference's side needs no 512 devices: its rules read only the mesh's
axis names and sizes, so they run on a ``jax.sharding.Mesh`` over one CPU
device repeated into the production shape.  Shapes come from
``jax.eval_shape`` there and from ``FakeTensorMode`` here: nothing is
allocated at full width.

The port's layers are a plain list where the reference stacks them by
period with a scan dim in front (``models/transformer.py::_period_split``):
param specs are compared with that dim dropped (the rules never shard
it).  The reference's ZeRO may put the DP axes on that scan dim, which a
per-layer moment does not have, so moments and caches are compared with
the reference's functions on its unstacked tree (``scan_layers=False``:
the same per-layer shapes the port holds).
"""
import functools
import multiprocessing as mp

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro.distributed import compression as ref_comp
from repro.distributed import context as ref_ctx
from repro.distributed import sharding as ref_shd
from repro.models import transformer as ref_tf
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw as ref_adamw
from repro.optim import quantized_state as ref_qs
from repro.optim import constant as ref_constant
from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.distributed import compression, context, sharding
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw, constant
from repro_torch.optim.quantized_state import quantize

MESHES = {"single": False, "multi": True}


def _ref_mesh(multi_pod: bool):
    """A Mesh of the production shape over one CPU device repeated."""
    shape = production_mesh_shape(multi_pod)
    arr = np.empty(shape.shape, object)
    arr[...] = jax.devices()[0]
    return jax.sharding.Mesh(arr, shape.axis_names)


def _ref_specs(tree) -> dict:
    """{path: spec tuple} of a reference NamedSharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {ref_shd._path_str(p): tuple(ns.spec) for p, ns in flat}


def _ref_path(cfg, path: str, stacked_tree: bool) -> tuple:
    """(the reference's path of a port path, stacked): ``layers/<i>/...``
    to its period or tail slot."""
    parts = path.split("/")
    if parts[0] != "layers":
        return path, False
    i, rest = int(parts[1]), "/".join(parts[2:])
    n_periods, pat, tail = ref_tf._period_split(cfg)
    if not stacked_tree:
        n_periods, pat, tail = 0, (), cfg.pattern_layers
    if i < n_periods * len(pat):
        return f"period/{i % len(pat)}:{pat[i % len(pat)]}/{rest}", True
    j = i - n_periods * len(pat)
    return f"tail/{j}:{tail[j]}/{rest}", False


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    with FakeTensorMode():
        return tf.init_params(configs.get_config(arch), torch.Generator())


@functools.lru_cache(maxsize=None)
def _port_quantized(shape):
    with FakeTensorMode():
        return quantize(torch.zeros(shape))


@functools.lru_cache(maxsize=None)
def _port_opt(arch, moments):
    """``adamw.init``'s state; int8 moments built from one ``quantize`` a
    distinct shape (what ``adamw.init`` stores, at a fraction of the
    trace)."""
    params = _port_params(arch)
    with FakeTensorMode():
        if moments == "float32":
            return adamw.init(AdamWConfig(lr=constant(1e-4)), params)
        step = torch.zeros((), dtype=torch.int32)
    m = tree_lib.tree_map(lambda p: _port_quantized(tuple(p.shape)), params)
    return adamw.AdamWState(step=step, m=m, v=m)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, stacked):
    cfg = ref_configs.get_config(arch)
    if not stacked:
        cfg = cfg.__class__(**{**cfg.__dict__, "scan_layers": False})
    return cfg, jax.eval_shape(lambda: ref_tf.init_params(
        cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _ref_quantized(shape):
    return jax.eval_shape(ref_qs.quantize, jax.ShapeDtypeStruct(shape, np.float32))


@functools.lru_cache(maxsize=None)
def _ref_opt(arch, moments):
    """``jax.eval_shape`` of the reference's ``adamw.init``; int8 moments
    from the reference's ``quantize`` traced once a distinct shape."""
    params = _ref_params(arch, False)[1]
    if moments == "float32":
        return jax.eval_shape(lambda p: ref_adamw.init(
            RefAdamWConfig(lr=ref_constant(1e-4)), p), params)
    m = jax.tree_util.tree_map(lambda p: _ref_quantized(tuple(p.shape)), params)
    return ref_adamw.AdamWState(step=jax.ShapeDtypeStruct((), np.int32), m=m, v=m)


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_kind):
    multi = MESHES[mesh_kind]
    mesh, ref_mesh = production_mesh_shape(multi), _ref_mesh(multi)
    rcfg, abs_params = _ref_params(arch, True)
    ref = _ref_specs(ref_shd.param_sharding(abs_params, ref_mesh))
    params = _port_params(arch)
    got = dict(tree_lib.leaves_with_paths(sharding.param_specs(params, mesh)))
    assert len(got) == len(tree_lib.leaves(params))
    sharded = 0
    for path, spec in got.items():
        rpath, stacked = _ref_path(rcfg, path, True)
        want = ref[rpath]
        if stacked and want:
            assert want[0] is None, (rpath, want)
            want = want[1:]
        assert spec == want, (path, spec, want)
        sharded += spec != () and any(e is not None for e in spec)
    assert sharded > 0


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_moment_batch_and_cache_specs_equal_the_reference(arch, mesh_kind):
    """ZeRO moment specs (fp32 and int8 moments) on the unstacked tree,
    batch specs of every runnable cell, cache specs of the decode cell."""
    multi = MESHES[mesh_kind]
    mesh, ref_mesh = production_mesh_shape(multi), _ref_mesh(multi)
    flat_cfg, abs_params = _ref_params(arch, False)
    params = _port_params(arch)
    psh = sharding.param_specs(params, mesh)
    for moments in ("float32", "int8"):
        ref = ref_shd.opt_state_sharding(_ref_opt(arch, moments), abs_params,
                                         ref_mesh)
        got = sharding.opt_state_specs(_port_opt(arch, moments), params, mesh,
                                       psh=psh)
        assert got.step == () and tuple(ref.step.spec) == ()
        for name in ("m", "v"):
            want = _ref_specs(getattr(ref, name))
            for path, spec in tree_lib.leaves_with_paths(getattr(got, name)):
                rpath, _ = _ref_path(flat_cfg, path, False)
                assert spec == want[rpath], (moments, name, path, spec, want[rpath])
    cfg = configs.get_config(arch)
    for shape in configs.SHAPES.values():
        if not configs.cell_is_runnable(cfg, shape)[0]:
            continue
        ref_batch = ref_configs.input_specs(flat_cfg, shape)
        want = {k: tuple(v.spec) for k, v in
                ref_shd.batch_sharding(ref_batch, ref_mesh).items()}
        with FakeTensorMode():
            batch = {k: torch.empty(s, dtype=dt) for k, (s, dt) in
                     configs.input_specs(cfg, shape).items()}
        assert sharding.batch_specs(batch, mesh) == want, shape.name
    decode = configs.SHAPES["decode_32k"]
    if configs.cell_is_runnable(cfg, decode)[0]:
        ref_cache = jax.eval_shape(lambda: ref_tf.init_cache(
            flat_cfg, decode.global_batch, decode.seq_len))
        want = _ref_specs(ref_shd.cache_sharding(ref_cache, ref_mesh))
        with FakeTensorMode():
            cache = tf.init_cache(cfg, decode.global_batch, decode.seq_len)
        got = tree_lib.leaves_with_paths(sharding.cache_specs(cache, mesh))
        for path, spec in got:
            rpath, _ = _ref_path(flat_cfg, "layers/" + path, False)
            assert spec == want[rpath], (path, spec, want[rpath])


def test_zero_spec_adds_dp_axis():
    """The reference suite's case (tests/test_distributed.py), in process."""
    mesh = context.MeshShape(("data", "model"), (2, 4))
    assert sharding.zero_spec((64, 128), (None, "model"), mesh) == ("data", "model")
    assert sharding.zero_spec((3, 128), (None, "model"), mesh) == (None, ("data", "model"))
    assert sharding.zero_spec((3, 5), (), mesh) == ()


# ---------------------------------------------------------------------------
# Activation hints and axis modes


HINT_CASES = [
    # (shape, axes): activations (B, S, d), MoE dispatch buffers, batches
    # that divide the DP axes and ones that do not.
    ((256, 4096, 2048), (context.BATCH, None, context.MODEL)),
    ((32, 32768, 2048), (context.BATCH, None, None)),
    ((1, 4096, 2048), (context.BATCH, None, context.MODEL)),
    ((6, 1000, 1280), (context.BATCH, None, context.MODEL)),
    ((8, 4096), (context.BATCH, None)),
    ((40, 1280, 4096), (context.BATCH, None, None)),
    ((40, 1280, 512), (context.BATCH, None, context.MODEL)),
    ((128, 1, 4096), (("pod", "data"), None, "model")),
    ((24, 4096, 48), (None, None, context.MODEL)),
]


@pytest.mark.parametrize("mode", ["default", "dp_only", "dp_seq"])
def test_hints_resolve_as_the_reference(mode, monkeypatch):
    """``resolve_hint`` and ``largest_divisible_subset`` against the
    reference's ``shard_hint`` (its constraint captured, not applied)
    under each axis mode on both production meshes."""
    monkeypatch.setattr(ref_ctx.jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    for multi in MESHES.values():
        mesh, ref_mesh = production_mesh_shape(multi), _ref_mesh(multi)
        ref_ctx.set_mesh(ref_mesh)
        ref_ctx.set_axis_mode(mode)
        context.set_axis_mode(mode)
        try:
            with context.use_mesh(mesh):
                for shape, axes in HINT_CASES:
                    want = tuple(ref_ctx.shard_hint(
                        jax.ShapeDtypeStruct(shape, np.float32), *axes).spec)
                    got = context.resolve_hint(shape, *axes)
                    assert got == want, (mode, shape, axes, got, want)
                    x = torch.zeros(1)
                    assert context.shard_hint(x, *axes[:1]) is x
                    for dim in shape:
                        for axes_ in (("pod", "data", "model"), ("data", "model")):
                            ax = tuple(a for a in axes_ if a in mesh.sizes)
                            assert context.largest_divisible_subset(
                                dim, ax, mesh.sizes) == ref_ctx.largest_divisible_subset(
                                dim, ax, mesh.sizes)
        finally:
            ref_ctx.set_mesh(None)
            ref_ctx.set_axis_mode("default")
            context.set_axis_mode("default")
    assert context.resolve_hint((4, 4), context.BATCH) is None


# ---------------------------------------------------------------------------
# int8 compression


@pytest.mark.parametrize("shape", [(1000,), (64, 128), (3, 5, 7), (256,), (1,)])
def test_quantize_int8_is_bit_equal_to_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 1e3], size=shape)
         ).astype(np.float32)
    if x.size > 512:
        x.reshape(-1)[:256] = 0.0      # a block of zeros: scale 0
    q, s = compression.quantize_int8(torch.tensor(x))
    rq, rs = ref_comp.quantize_int8(jax.numpy.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    back = compression.dequantize_int8(q, s, shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        ref_comp.dequantize_int8(rq, rs, shape)))
    assert compression.compression_ratio(shape) == ref_comp.compression_ratio(shape)
    assert compression.compression_ratio((1024, 1024)) > 3.5


# ---------------------------------------------------------------------------
# Two gloo processes


GLOO_RANKS = 2


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """One run of tests/torch_gloo_workers.py on GLOO_RANKS spawned CPU
    processes (a ``file://`` rendezvous under the test's own temporary
    directory); each rank's results."""
    import torch_gloo_workers as workers

    tmp = tmp_path_factory.mktemp("gloo")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.run,
                         args=(r, GLOO_RANKS, str(tmp / "rendezvous"), str(tmp)))
             for r in range(GLOO_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"gloo workers {alive} did not finish in 120 s"
    assert [p.exitcode for p in procs] == [0] * GLOO_RANKS
    return [torch.load(tmp / f"rank{r}.pt") for r in range(GLOO_RANKS)]


def test_compressed_allreduce_on_gloo(gloo_run):
    """The reference suite's gates (REL < 0.02 after one exchange, DIST <
    0.2 after 200 EF-compressed SGD steps) on its problem, every rank the
    same mean, equal to the mean of the reference's quantize/dequantize
    round trips of the ranks' rows, and each rank's error feedback its
    own residual."""
    import torch_gloo_workers as workers

    rows = [workers.compression_problem(r, GLOO_RANKS)[0] for r in range(GLOO_RANKS)]
    exact = np.mean(rows, axis=0)
    mean = gloo_run[0]["compression"]["mean"].numpy()
    for r, res in enumerate(gloo_run):
        np.testing.assert_array_equal(res["compression"]["mean"].numpy(), mean)
        rq, rs = ref_comp.quantize_int8(jax.numpy.asarray(rows[r]))
        deq = np.asarray(ref_comp.dequantize_int8(rq, rs, rows[r].shape))
        np.testing.assert_array_equal(res["compression"]["error"].numpy(),
                                      rows[r] - deq)
        assert res["compression"]["dist"] < 0.2
    deqs = [np.asarray(ref_comp.dequantize_int8(*ref_comp.quantize_int8(
        jax.numpy.asarray(x)), x.shape)) for x in rows]
    np.testing.assert_allclose(mean, np.sum(deqs, axis=0) / GLOO_RANKS,
                               rtol=1e-6, atol=1e-7)
    assert float(np.abs(mean - exact).max() / np.abs(exact).max()) < 0.02


def test_placements_on_a_gloo_device_mesh(gloo_run):
    """``to_device_mesh`` builds a ``DeviceMesh`` of the ``MeshShape``'s
    names and sizes over the two ranks, and ``placements`` turns a spec
    into the DTensor placements that give each rank its slice: a
    column-parallel weight on (data 1, model 2) its half of the columns; a
    row-parallel weight's ZeRO moment, ((data, model), None) on (data 2,
    model 1), its half of the rows."""
    import torch_gloo_workers as workers

    full = workers.placed_tensor()
    want = [((None, "model"), [("replicate",), ("shard", 1)],
             lambda r: full[:, 3 * r:3 * r + 3]),
            ((("data", "model"), None), [("shard", 0), ("shard", 0)],
             lambda r: full[4 * r:4 * r + 4])]
    for r, res in enumerate(gloo_run):
        for got, (shape, _, _), (spec, place, local) in zip(
                res["placements"], workers.PLACED, want):
            assert got["names"] == ("data", "model") and got["shape"] == shape
            assert got["spec"] == spec and got["placements"] == place
            assert torch.equal(got["local"], local(r))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_zero_step_on_gloo_matches_one_process(gloo_run, arch):
    """Two ZeRO steps on two ranks (each its two rows, its slices of the
    moments) against one process's ``make_train_step`` with the batch in
    two microbatches: the loss within 1e-5 relative, every parameter of
    every rank within 1e-5 * max(1, max|p|)."""
    import torch_gloo_workers as workers
    from repro_torch.train.step import make_train_step

    cfg, params, batch, opt_cfg = workers.zero_inputs(arch)
    step = make_train_step(cfg, opt_cfg, grad_accum=GLOO_RANKS, impl="torch")
    opt = adamw.init(opt_cfg, params)
    losses = []
    for _ in range(workers.ZERO_STEPS):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    for res in gloo_run:
        got = res[arch]
        assert got["step"] == workers.ZERO_STEPS
        halved = [m for m, p in zip(got["moment_numels"], tree_lib.leaves(params))
                  if 2 * m == p.numel()]
        assert len(halved) >= len(got["moment_numels"]) // 2
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        ref_leaves = tree_lib.leaves(params)
        got_leaves = tree_lib.leaves_with_paths(got["params"])
        for (path, x), ref in zip(got_leaves, ref_leaves):
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            assert x.shape == ref.shape and float((x - ref).abs().max()) <= tol, path

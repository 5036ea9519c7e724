"""The port's synthetic data and input specs against the JAX package's.

The bits of a CPU ``torch.Generator`` are not ``jax.random``'s, so the
values are held to the reference's structure, not to its numbers: the
Markov rule ``(7 t + 31) % V`` taken with probability 0.8, labels the
stream shifted by one, the audio mask at 0.08, every key, shape and dtype
equal to the reference's ``batch_for`` and ``input_specs``, each batch a
pure function of (seed, step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import batch_for as j_batch_for
from repro.data import image_batch as j_image_batch
from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.data import batch_for, image_batch, markov_tokens
from repro_torch.data.tokens import generator

_DTYPES = {torch.int32: np.int32, torch.float32: np.float32, torch.bool: np.bool_}


def test_markov_rule_and_noise():
    v = 1000
    toks = markov_tokens(generator(0, 0), 64, 257, v).long()
    follows = (toks[:, 1:] == (7 * toks[:, :-1] + 31) % v).float().mean()
    # 0.8 by the rule, plus 0.2 / V by chance.
    assert 0.78 < float(follows) < 0.82
    assert toks.dtype == torch.int64 and 0 <= int(toks.min()) and int(toks.max()) < v


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_structure_matches_reference(arch, kind):
    cfg, j_cfg = configs.smoke_config(arch), j_configs.smoke_config(arch)
    ours = batch_for(cfg, ShapeSpec("t", 32, 4, kind), step=3, seed=5)
    ref = j_batch_for(j_cfg, JShapeSpec("t", 32, 4, kind), step=3, seed=5)
    assert sorted(ours) == sorted(ref)
    specs = configs.input_specs(cfg, ShapeSpec("t", 32, 4, kind))
    assert sorted(specs) == sorted(ours)
    for k, t in ours.items():
        assert tuple(t.shape) == tuple(ref[k].shape) == specs[k][0], k
        assert _DTYPES[t.dtype] == np.asarray(ref[k]).dtype, k
        assert t.dtype == specs[k][1], k
    if "labels" in ours:
        assert torch.equal(ours["labels"][:, :-1], ours["tokens"][:, 1:])
        assert int(ours["tokens"].max()) < cfg.vocab_size


def test_batch_is_a_pure_function_of_seed_and_step():
    cfg = configs.smoke_config("internvl2-2b")
    shape = ShapeSpec("t", 32, 4, "train")
    a, b = batch_for(cfg, shape, 7, seed=1), batch_for(cfg, shape, 7, seed=1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c, d = batch_for(cfg, shape, 8, seed=1), batch_for(cfg, shape, 7, seed=2)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert not torch.equal(a["patch_embeds"], c["patch_embeds"])


def test_audio_mask_rate():
    cfg = configs.smoke_config("hubert-xlarge")
    batch = batch_for(cfg, ShapeSpec("t", 1000, 16, "train"), 0)
    assert 0.07 < float(batch["mask"].float().mean()) < 0.09
    assert batch["frames"].dtype == torch.float32


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_and_cells_match_reference(arch):
    cfg, j_cfg = configs.get_config(arch), j_configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        assert shape == ShapeSpec(*j_configs.SHAPES[name].__dict__.values())
        ours = configs.input_specs(cfg, shape)
        ref = j_configs.input_specs(j_cfg, j_configs.SHAPES[name])
        assert sorted(ours) == sorted(ref)
        for k, (shp, dt) in ours.items():
            assert shp == tuple(ref[k].shape) and _DTYPES[dt] == ref[k].dtype
    assert ([c for c in configs.all_cells() if c[0] == arch]
            == [c for c in j_configs.all_cells() if c[0] == arch])


def test_image_batch_matches_reference_structure():
    ours = image_batch(2, 3, 16, 20, seed=4)
    ref = np.asarray(j_image_batch(2, 3, 16, 20, seed=4))
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    assert torch.equal(ours, image_batch(2, 3, 16, 20, seed=4))
    # Waves in [-1, 1] plus 0.1 of noise, as the reference's.
    assert abs(float(ours.std()) - float(ref.std())) < 0.1
    assert float(ours.abs().max()) < 1.6 and float(jnp.abs(ref).max()) < 1.6

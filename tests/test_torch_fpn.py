"""The PyTorch port's FPN serving path against the JAX package.

One seeded smp-named ``state_dict`` feeds both sides: the port loads it
with ``load_state_dict(strict=True)``, the JAX FPN through
``convert_smp_fpn_state_dict``.  Checked here, in f32 at 64²:

* the weight carry: torch sd → flax → ``fpn_state_dict_from_jax`` is
  bit-exact;
* logits: the port's ``FPN`` vs the flax ``FPN`` within ``rtol=2e-3,
  atol=5e-4`` (the bound of ``tests/test_fpn_golden.py``);
* probabilities: the port's ``make_infer_step`` vs the JAX one (normalize
  fold, sigmoid) within ``atol=5e-4``, at the tile size and with a 96²
  input resized on ingest.

On the CPU the JAX FPN takes ``xla_group_norm_relu`` (its ``on_tpu`` gate),
the plain reference of its Pallas kernels, and the port takes its own
plain version: this is the slice-level comparison.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.ops.resize import (
    resize_bilinear as jax_resize_bilinear,
    resize_nearest as jax_resize_nearest,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_infer_step as jax_make_infer_step,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_nearest,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    fpn_state_dict_from_jax,
    load_reference_state_dict,
    seeded_state_dict,
)

SIZE = 64
_State = namedtuple("_State", "params batch_stats")


@pytest.fixture(scope="module")
def pair():
    """(port model, torch sd, jax model, jax state) from one seeded sd."""
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="float32")
    model = build_model(cfg)
    sd = seeded_state_dict(model, seed=5)
    model.load_state_dict(sd, strict=True)

    jcfg = JaxConfig(model="fpn", img_size=SIZE, compute_dtype="float32")
    jmodel = jax_build_model(jcfg)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    params, batch_stats = convert_smp_fpn_state_dict(
        {k: v.numpy() for k, v in sd.items()},
        variables["params"], variables["batch_stats"])
    return model, sd, jmodel, _State(params, batch_stats)


def test_weight_carry_round_trips_bit_exact(pair):
    _, sd, _, state = pair
    back = fpn_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def test_logits_match_flax(pair):
    model, _, jmodel, state = pair
    x = np.random.default_rng(0).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(x))
    with torch.no_grad():
        ours = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert ours.dtype == torch.float32 and ours.shape == (2, 1, SIZE, SIZE)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("in_size", [SIZE, 96])
def test_infer_step_matches_jax(pair, in_size):
    model, _, jmodel, state = pair
    imgs = np.random.default_rng(in_size).integers(
        0, 256, (2, in_size, in_size, 3), dtype=np.uint8)
    ref = np.asarray(jax_make_infer_step(jmodel, SIZE)(state,
                                                       jnp.asarray(imgs)))
    ours = make_infer_step(model, SIZE)(torch.from_numpy(imgs))
    assert ours.dtype == torch.float32 and ours.shape == (2, SIZE, SIZE)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=5e-4)


def test_reference_checkpoint_loads(pair, tmp_path):
    """A reference-format ``{"model": sd}`` file with DDP ``module.``
    prefixes loads strictly into the port."""
    model, sd, _, _ = pair
    path = tmp_path / "best.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3, "previous_best": 0.6}, path)
    loaded = load_reference_state_dict(str(path))
    fresh = build_model(Config(model="fpn", img_size=SIZE,
                               compute_dtype="float32"))
    fresh.load_state_dict(loaded, strict=True)
    torch.save(sd, tmp_path / "bare.pth")
    assert sorted(load_reference_state_dict(str(tmp_path / "bare.pth"))) \
        == sorted(sd)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out", [(37, 53), (128, 96)])
def test_resize_bilinear_matches_jax(align_corners, out):
    """torch takes the source coordinate in f32 (error about
    index·2⁻²⁴ in the weight), the JAX side builds its interpolation
    matrices in f64: on N(0, 1) inputs that is up to ~1.5e-5 apart, hence
    ``atol=5e-5``."""
    x = np.random.default_rng(1).normal(size=(2, 40, 50, 3)).astype(
        np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), *out,
                                         align_corners=align_corners))
    ours = resize_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                           *out, align_corners=align_corners)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("out", [(23, 31), (96, 80)])
def test_resize_nearest_matches_jax(out):
    m = np.random.default_rng(2).integers(0, 4, (3, 40, 50), dtype=np.uint8)
    ref = np.asarray(jax_resize_nearest(jnp.asarray(m), *out))
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(m), *out).numpy(), ref)


@pytest.mark.parametrize("backbone,channels", [
    ("resnet34", [64, 64, 128, 256, 512]),
    ("resnet50", [64, 256, 512, 1024, 2048]),
])
def test_resnet_family_feature_pyramid(backbone, channels):
    model = build_model(Config(model="fpn", backbone=backbone, img_size=SIZE,
                               compute_dtype="float32"))
    with torch.no_grad():
        feats = model.encoder(torch.zeros(1, 3, SIZE, SIZE))
    assert [f.shape[1] for f in feats] == channels
    assert [f.shape[-1] for f in feats] == [SIZE // s for s in
                                            (2, 4, 8, 16, 32)]

"""The port's stain normalization (``ops/stain.py``) and its hooks
(``ops/augment.py::eval_images``, ``train/steps.py::make_infer_step``, the
int8 path's ``quantize_from_config``) against the JAX package, on the CPU.

* Reinhard and Macenko, batch outputs within 2e-5 of JAX's on seeded
  H&E-like tiles (Beer-Lambert of gamma-distributed concentrations on a
  jittered reference basis, a fifth of the pixels background); Macenko's
  bases within 1e-5 and its 99th-percentile concentrations within a
  relative 1e-5, image by image.  Eigenvector signs are never compared.
* Background pixels weigh nothing: a tile with a block of glass added
  gives the same basis as the tissue alone.
* ``nanpercentile_nearest`` equal to ``jnp.nanpercentile(...,
  method="nearest")`` for every count 1..12 and the percentiles the
  Macenko fit takes, and on ties (``(n − 1)·q`` ending in .5: the lower
  neighbour).
* The FPN infer step with ``stain`` against the JAX ``make_infer_step``
  (probabilities within 5e-4, the FPN bound) and ``eval_transform``
  against the JAX one; ``quantize_from_config`` with ``stain: reinhard``:
  its float mirror equal to the model's stained infer step (the JAX
  ``test_quantize_from_config_applies_stain``); an unknown method raises.
* Macenko does not depend on the eigensolver's signs: with any of the
  plane's eigenvectors negated the result is the same, bit for bit, on
  H&E-like tiles and on patches with no stain plane (colour noise and a
  tinted disc, as the synthetic test patches), where float32 and float64
  then agree within 2e-4.
* On such patches the port equals the JAX function run under the port's
  sign rule (a test-local wrapper of ``jnp.linalg.eigh``) within 2e-4;
  without it the two differ by up to 1.0.
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
from pdac_pathological_image_segmentation_tpu.ops import stain as jax_stain
from pdac_pathological_image_segmentation_tpu.ops.augment import (
    eval_transform as jax_eval_transform,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_infer_step as jax_make_infer_step,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.infer import quantized as q
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.ops import stain
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    eval_transform,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)

SIZE = 64
METHODS = ("reinhard", "macenko")


def _he_tiles(seed, n=4, size=SIZE):
    rng = np.random.default_rng(seed)
    conc = rng.gamma(2.0, 0.35, (n, size, size, 2)).astype(np.float32)
    glass = rng.random((n, size, size)) < 0.2
    conc[glass] = rng.random((int(glass.sum()), 2)).astype(np.float32) * 0.02
    basis = (stain.REFERENCE_STAIN_BASIS
             + rng.normal(0, 0.05, (3, 2)).astype(np.float32))
    od = conc @ basis.T
    rgb = np.power(10.0, -od) + rng.normal(0, 0.01, od.shape)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
def test_batch_normalization_matches_jax(method):
    x = _he_tiles(1)
    want = np.asarray(jax_stain.apply_stain_batch(jnp.asarray(x), method))
    got = stain.apply_stain_batch(torch.from_numpy(x), method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_macenko_basis_and_concentrations_match_jax():
    x = _he_tiles(2)
    got = stain.macenko_stain_matrix(torch.from_numpy(x))
    for i in range(len(x)):
        want = jax_stain.macenko_stain_matrix(jnp.asarray(x[i]))
        np.testing.assert_allclose(got.basis[i].numpy(),
                                   np.asarray(want.basis), atol=1e-5)
        np.testing.assert_allclose(got.max_conc[i].numpy(),
                                   np.asarray(want.max_conc), rtol=1e-5)


def test_background_pixels_weigh_nothing():
    x = _he_tiles(3, n=1)
    padded = np.concatenate([x, np.full((1, 16, SIZE, 3), 0.97,
                                        np.float32)], axis=1)
    a = stain.macenko_stain_matrix(torch.from_numpy(x))
    b = stain.macenko_stain_matrix(torch.from_numpy(padded))
    np.testing.assert_allclose(b.basis.numpy(), a.basis.numpy(), atol=1e-5)
    np.testing.assert_allclose(b.max_conc.numpy(), a.max_conc.numpy(),
                               rtol=1e-5)
    # and the padded tile against JAX too
    want = jax_stain.macenko_stain_matrix(jnp.asarray(padded[0]))
    np.testing.assert_allclose(b.basis[0].numpy(), np.asarray(want.basis),
                               atol=1e-5)


@pytest.mark.parametrize("percent", [1.0, 25.0, 50.0, 99.0])
def test_nearest_percentile_matches_jax_index_for_index(percent):
    rng = np.random.default_rng(int(percent))
    values = rng.normal(size=(12, 40)).astype(np.float32)
    valid = np.zeros((12, 40), bool)
    for n in range(1, 13):
        valid[n - 1, rng.choice(40, n, replace=False)] = True
    want = np.asarray(jnp.nanpercentile(
        jnp.where(valid, values, jnp.nan), percent, axis=1,
        method="nearest"))
    got = stain.nanpercentile_nearest(torch.from_numpy(values),
                                      torch.from_numpy(valid), percent)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nearest_percentile_tie_takes_the_lower_neighbour():
    # n = 4, q = 0.5: position 1.5 exactly, so the second smallest
    values = torch.tensor([[4.0, 1.0, 3.0, 2.0, 9.0]])
    valid = torch.tensor([[True, True, True, True, False]])
    assert stain.nanpercentile_nearest(values, valid, 50.0).item() == 2.0
    want = jnp.nanpercentile(jnp.asarray([4.0, 1.0, 3.0, 2.0, jnp.nan]),
                             50.0, method="nearest")
    assert float(want) == 2.0


@pytest.fixture(scope="module")
def fpn():
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="float32")
    model = build_model(cfg)
    sd = seeded_state_dict(model, seed=31)
    model.load_state_dict(sd, strict=True)
    jmodel = jax_build_model(JaxConfig(model="fpn", img_size=SIZE,
                                       compute_dtype="float32"))
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, SIZE, SIZE, 3)),
        train=False)
    params, batch_stats = convert_smp_fpn_state_dict(
        {k: v.numpy() for k, v in sd.items()}, variables["params"],
        variables["batch_stats"])
    state = namedtuple("_S", "params batch_stats")(params, batch_stats)
    images = (_he_tiles(4, n=3) * 255).astype(np.uint8)
    return model.eval(), jmodel, state, images


@pytest.mark.parametrize("method", METHODS)
def test_infer_step_with_stain_matches_jax(fpn, method):
    model, jmodel, state, images = fpn
    got = make_infer_step(model, SIZE, stain=method)(
        torch.from_numpy(images)).numpy()
    want = np.asarray(jax_make_infer_step(jmodel, SIZE, stain=method)(
        state, jnp.asarray(images)))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    plain = make_infer_step(model, SIZE)(torch.from_numpy(images)).numpy()
    assert np.abs(got - plain).max() > 1e-3


@pytest.mark.parametrize("method", METHODS)
def test_eval_transform_with_stain_matches_jax(fpn, method):
    images = fpn[3]
    masks = np.zeros(images.shape[:3], np.uint8)
    got, _ = eval_transform(torch.from_numpy(images),
                            torch.from_numpy(masks), SIZE, stain=method)
    want, _ = jax_eval_transform(jnp.asarray(images), jnp.asarray(masks),
                                 img_size=SIZE, stain=method)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=2e-4)


def test_quantize_from_config_applies_stain(fpn):
    """``cfg.stain`` reaches the int8 path: its float mirror equals the
    model's infer step with the same stain, and differs from the
    stainless mirror."""
    model, _, _, images = fpn
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="float32",
                 stain="reinhard")
    sd = model.state_dict()
    _, forward = q.quantize_from_config(cfg, sd, [images])
    got = q.make_float_infer_step(sd, SIZE, forward)(images)
    ref = make_infer_step(model, SIZE, stain="reinhard")(
        torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    plain = q.make_float_infer_step(sd, SIZE, q.fpn_forward)(images)
    assert float((got - plain).abs().max()) > 1e-6


def _stainless_patches(seed, n=8, size=SIZE):
    """Smooth colour noise with fine noise and a disc tinted purple in
    [0, 1]: the synthetic test patches' recipe, which has no stain plane."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(
        rng.uniform(40, 230, (n, 3, 4, 4)).astype(np.float32))
    img = torch.nn.functional.interpolate(
        coarse, size=(size, size), mode="bilinear",
        align_corners=False).numpy().transpose(0, 2, 3, 1)
    img = img + rng.normal(0, 12, img.shape)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        r = rng.integers(size // 8, size // 3)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[i][disc] = 0.5 * img[i][disc] + 0.5 * np.asarray([120, 60, 160])
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32) / 255.0


@pytest.mark.parametrize("flip", [(1, -1, 1), (1, 1, -1), (1, -1, -1)])
def test_macenko_does_not_depend_on_eigenvector_signs(monkeypatch, flip):
    """LAPACK, cuSOLVER and XLA each choose an eigenvector's sign, which
    turns the tissue angles by π or mirrors them; where the angles straddle
    ±π (a patch with no stain plane: seed 8, patch 6) the percentiles would
    take other pixels.  The port fixes the signs, so negating any
    eigenvector changes nothing, and float32 and float64 agree there."""
    x = torch.from_numpy(np.concatenate([_stainless_patches(8)[6:7],
                                         _he_tiles(4, n=1)]))
    want = stain.apply_stain_batch(x, "macenko")
    exact = stain.apply_stain_batch(x.double(), "macenko")
    assert float((want.double() - exact).abs().max()) < 2e-4
    eigh = torch.linalg.eigh
    signs = torch.tensor(flip, dtype=torch.float32)

    def flipped(a):
        vals, vecs = eigh(a)
        return vals, vecs * signs

    monkeypatch.setattr(torch.linalg, "eigh", flipped)
    assert torch.equal(stain.apply_stain_batch(x, "macenko"), want)


def test_macenko_on_tiles_with_no_stain_plane_matches_jax_under_the_port_sign_rule(
        monkeypatch):
    """On colour-noise tiles with no stain plane (16 at 64², numpy seeds 8
    and 3) the port's Macenko equals the JAX function run under the port's
    sign rule: each eigenvector's largest component positive, put into JAX
    by a test-local wrapper of ``jnp.linalg.eigh`` (the JAX package is not
    edited).  Reading on the CPU: 6.1e-5 at most (the port's covariance and
    eigh run in float64, JAX's in float32); bound 2e-4.  Without the
    wrapper the raw gap is up to 1.0 (0.96, 0.994 and 0.993 on three of
    seed 8's tiles, 1.0 on one of seed 3's): the JAX result depends on its
    solver's signs there."""
    x = np.concatenate([_stainless_patches(8), _stainless_patches(3)])
    got = stain.apply_stain_batch(torch.from_numpy(x), "macenko").numpy()
    raw = np.asarray(jax_stain.apply_stain_batch(jnp.asarray(x), "macenko"))
    eigh = jnp.linalg.eigh

    def signed(a, *args, **kw):
        vals, vecs = eigh(a, *args, **kw)
        big = jnp.argmax(jnp.abs(vecs), axis=0)
        lead = jnp.take_along_axis(vecs, big[None, :], axis=0)
        return vals, vecs * jnp.where(lead < 0, -1.0, 1.0)

    monkeypatch.setattr(jnp.linalg, "eigh", signed)
    jax.clear_caches()  # trace the jitted fit anew, with the wrapper
    try:
        want = np.asarray(jax_stain.apply_stain_batch(jnp.asarray(x),
                                                      "macenko"))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    gap = float(np.abs(got - want).max())
    print(f"macenko, no stain plane: port vs JAX under the sign rule "
          f"{gap:.3g}, raw {float(np.abs(got - raw).max()):.3g}")
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert gap < 2e-4, gap


def test_one_colour_tile_gives_what_jax_gives():
    """A tile of one colour (the daemon's warm-up zeros) has coinciding
    stain vectors: no exception, non-finite pixels where JAX's are."""
    x = np.zeros((1, 16, 16, 3), np.float32)
    got = stain.apply_stain_batch(torch.from_numpy(x), "macenko").numpy()
    want = np.asarray(jax_stain.apply_stain_batch(jnp.asarray(x), "macenko"))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))


def test_unknown_stain_method_raises():
    with pytest.raises(ValueError, match="unknown stain method"):
        stain.apply_stain_batch(torch.zeros(1, 4, 4, 3), "vahadane")

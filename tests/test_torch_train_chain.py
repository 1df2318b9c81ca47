"""The port's non-fused train chain (``ops/augment.py::train_transform``)
against the JAX ``train_transform``, on the CPU at 64².

Both sides get the same draws: the JAX chain's ``draw_augment_scalars`` is
replaced by one that returns given tables (a test-local patch of the JAX
module; the JAX package is not edited), and the port's
``train_transform_drawn`` takes the same tables.

* Default mode: f32 within 1e-5 (the jitter tables computed by two
  libraries, one f32 rounding apart); bf16 within the augmentation bound of
  ``tests/test_fused_augment.py`` (an element is off when ``|Δ| > 0.06 +
  0.02·|ref|``, fewer than 5e-4 of the elements may be); masks bitwise,
  class ids 0..2 included.
* Resize on ingest (48² patches, ``img_size`` 64): within 1.5e-5, the two
  bilinear resizes' source coordinates taken at different precisions.
* Stain in training, Reinhard and Macenko on H&E-like tiles: f32 within
  2e-4 (the stain tests' bound for ``eval_transform``), bf16 within the
  augmentation bound.
* Parity mode: each ``_adjust_*`` within 1e-5; the chain, on the draws the
  JAX chain takes from a key (recomputed here with the key splits of the
  JAX ``color_jitter`` and ``one_of_flip_rot``), within 1e-5; over 4096
  draws of the step's generators, the chain's jitter-apply (0.5), OneOf
  (0.3), choice (1/3) and rot90 k (1/4) frequencies within 4σ.
* ``can_fuse_augment``'s clauses; the fused kernel's plain version keeps
  class ids 0..2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.ops import augment as jax_aug
from pdac_pathological_image_segmentation_tpu_torch.ops import augment
from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
    fused_train_transform,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.stain import (
    REFERENCE_STAIN_BASIS,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    can_fuse_augment,
    step_generator,
)

S = 64
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _batch(n, seed, size=S, classes=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    masks = rng.integers(0, classes, (n, size, size), dtype=np.uint8)
    return images, masks


def _he_batch(n, seed, size=S):
    """H&E-like uint8 tiles (Beer-Lambert of gamma concentrations on a
    jittered reference basis, a fifth of the pixels glass), so Macenko's
    stain plane is well defined."""
    rng = np.random.default_rng(seed)
    conc = rng.gamma(2.0, 0.35, (n, size, size, 2))
    glass = rng.random((n, size, size)) < 0.2
    conc[glass] = rng.random((int(glass.sum()), 2)) * 0.02
    od = conc @ (REFERENCE_STAIN_BASIS
                 + rng.normal(0, 0.05, (3, 2))).T
    rgb = np.clip(np.power(10.0, -od) + rng.normal(0, 0.01, od.shape), 0, 1)
    masks = rng.integers(0, 3, (n, size, size), dtype=np.uint8)
    return (rgb * 255).astype(np.uint8), masks


def _draws(n, seed):
    facs, ints = jax_aug.draw_augment_scalars(jax.random.PRNGKey(seed), n)
    ints = np.array(ints)
    ints[: n // 2, 4] = 1  # half the batch jittered, whatever the key says
    ints[:, 5] = np.arange(n) % 4 != 0  # most samples take a geometry
    return np.array(facs), ints


def jax_chain(images, masks, img_size, facs, ints, stain="none",
              dtype=jnp.float32):
    """The JAX ``train_transform`` in default mode on the given tables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_aug, "draw_augment_scalars",
                   lambda key, n, **kw: (jnp.asarray(facs),
                                         jnp.asarray(ints)))
        jax.clear_caches()  # trace the jitted chain anew, with the patch
        try:
            out, m = jax_aug.train_transform(
                jax.random.PRNGKey(0), jnp.asarray(images),
                jnp.asarray(masks), img_size=img_size, stain=stain,
                dtype=dtype)
        finally:
            jax.clear_caches()
    return np.asarray(out, np.float32), np.asarray(m)


def port_chain(images, masks, img_size, facs, ints, **kw):
    out, m = augment.train_transform_drawn(
        torch.from_numpy(images), torch.from_numpy(masks), img_size,
        torch.from_numpy(facs), torch.from_numpy(ints), **kw)
    assert out.is_contiguous() and m.dtype == torch.float32
    assert tuple(out.shape) == (images.shape[0], 3, img_size, img_size)
    return out.float().numpy().transpose(0, 2, 3, 1), m.numpy()


def assert_augment_bound(got, want):
    """``tests/test_fused_augment.py``'s bound for bf16 chains."""
    viol = np.abs(got - want) > (0.06 + 0.02 * np.abs(want))
    assert viol.mean() < 5e-4, (
        f"{viol.sum()} elements beyond the bound (max |Δ| "
        f"{np.abs(got - want).max():.4f})")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("in_size", [S, 48])
def test_default_chain_matches_jax(dtype, in_size):
    images, masks = _batch(8, seed=in_size)
    facs, ints = _draws(8, seed=in_size)
    tdt, jdt = DTYPES[dtype]
    want, want_m = jax_chain(images, masks, S, facs, ints, dtype=jdt)
    got, got_m = port_chain(images, masks, S, facs, ints, dtype=tdt)
    np.testing.assert_array_equal(got_m, want_m)
    assert set(np.unique(got_m)) == {0.0, 1.0, 2.0}
    if dtype == "bfloat16":
        assert_augment_bound(got, want)
    else:
        # at 48², beside the one rounding: the resize's 1.5e-5
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 if in_size == S else 1.5e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stain", ["reinhard", "macenko"])
def test_stain_in_training_matches_jax(stain, dtype):
    """The stain hook of the train chain: the JAX function hands
    ``apply_stain_batch`` the image already in the chain's dtype; on bf16
    input the port computes what JAX computes there (``ops/stain.py``)."""
    images, masks = _he_batch(4, seed=3)
    facs, ints = _draws(4, seed=5)
    tdt, jdt = DTYPES[dtype]
    want, want_m = jax_chain(images, masks, S, facs, ints, stain=stain,
                             dtype=jdt)
    got, got_m = port_chain(images, masks, S, facs, ints, stain=stain,
                            dtype=tdt)
    np.testing.assert_array_equal(got_m, want_m)
    if dtype == "bfloat16":
        assert_augment_bound(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    plain, _ = port_chain(images, masks, S, facs, ints, dtype=tdt)
    assert np.abs(got - plain).max() > 0.05  # the stain did something


# -- parity mode ----------------------------------------------------------------

_ADJUST = ["_adjust_brightness", "_adjust_contrast", "_adjust_saturation",
           "_adjust_hue"]


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", _ADJUST)
def test_each_adjust_op_matches_jax(name, clip):
    """Each op on normalized floats (parity mode's input, well outside
    [0, 1]) with per-sample factors: f32 within 1e-5."""
    rng = np.random.default_rng(_ADJUST.index(name))
    x = rng.normal(0.3, 1.2, (4, S, S, 3)).astype(np.float32)
    f = (rng.uniform(-0.3, 0.3, 4) if name == "_adjust_hue"
         else rng.uniform(0.7, 1.3, 4)).astype(np.float32)
    jfn = getattr(jax_aug, name)
    want = np.asarray(jax.vmap(lambda im, fi: jfn(im, fi, clip))(
        jnp.asarray(x), jnp.asarray(f)))
    factor = torch.from_numpy(f).view(4, 1, 1, 1)
    if name == "_adjust_hue":
        factor = augment.hue_rotation(torch.from_numpy(f), torch.float32
                                      ).view(4, 1, 1, 1, 2)
    got = getattr(augment, name)(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), factor, clip)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)


def jax_parity_draws(key, n, brightness=0.3, contrast=0.3, saturation=0.3,
                     hue=0.3, p=0.5, p_geom=0.3):
    """The draws the JAX parity chain takes from ``key``, recomputed with
    the key splits of ``train_transform`` (one key pair per sample),
    ``color_jitter`` (apply, order, b, c, s, h) and ``one_of_flip_rot``
    (apply, pick, rot), in ``draw_augment_scalars``' layout."""
    keys = jax.random.split(key, n * 2).reshape(n, 2, -1)
    facs, ints = [], []
    for i in range(n):
        k_apply, k_order, k_b, k_c, k_s, k_h = jax.random.split(keys[i, 0],
                                                                6)
        g_apply, g_pick, g_rot = jax.random.split(keys[i, 1], 3)
        facs.append([
            jax.random.uniform(k_b, (), minval=1 - brightness,
                               maxval=1 + brightness),
            jax.random.uniform(k_c, (), minval=1 - contrast,
                               maxval=1 + contrast),
            jax.random.uniform(k_s, (), minval=1 - saturation,
                               maxval=1 + saturation),
            jax.random.uniform(k_h, (), minval=-hue, maxval=hue)])
        ints.append(list(np.asarray(jax.random.permutation(k_order, 4)))
                    + [int(jax.random.uniform(k_apply) < p),
                       int(jax.random.uniform(g_apply) < p_geom),
                       int(jax.random.randint(g_pick, (), 0, 3)),
                       int(jax.random.randint(g_rot, (), 0, 4))])
    return (np.asarray(facs, np.float32), np.asarray(ints, np.int32))


@pytest.mark.parametrize("seed", [0, 5])
def test_parity_chain_matches_jax_on_its_key_draws(seed):
    n = 8
    images, masks = _batch(n, seed=20 + seed)
    key = jax.random.PRNGKey(seed)
    want, want_m = jax_aug.train_transform(
        key, jnp.asarray(images), jnp.asarray(masks), img_size=S,
        parity_mode=True)
    facs, ints = jax_parity_draws(key, n)
    jfacs, jints = jax_aug.draw_augment_scalars(key, n)
    np.testing.assert_array_equal(ints, np.asarray(jints))
    np.testing.assert_array_equal(facs, np.asarray(jfacs))
    assert ints[:, 4].any() and not ints[:, 4].all()
    got, got_m = port_chain(images, masks, S, facs, ints, parity_mode=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_m, np.asarray(want_m))


def test_parity_chain_laws_over_the_step_generators():
    """4096 samples of 8² through the parity chain, four per step
    generator: whether the jitter ran (the output is not the normalized
    input under the sample's geometry) and which geometry ran (read off a
    mask of distinct values) follow p = 0.5, 0.3, 1/3 and 1/4 within 4σ."""
    size, per, steps = 8, 4, 1024
    n = per * steps
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    masks = np.broadcast_to(np.arange(size * size, dtype=np.uint8).reshape(
        size, size), (n, size, size)).copy()
    outs, moved = [], []
    for s in range(steps):
        part = slice(s * per, (s + 1) * per)
        o, m = augment.train_transform(
            torch.from_numpy(images[part]), torch.from_numpy(masks[part]),
            size, step_generator(3, 0, s), parity_mode=True)
        outs.append(o)
        moved.append(m)
    out, mask = torch.cat(outs), torch.cat(moved).long()
    plain = augment.normalize(torch.from_numpy(images).permute(0, 3, 1, 2))
    base = torch.arange(size * size).view(size, size)
    cases = {"none": base, "hflip": base.flip(-1), "vflip": base.flip(-2),
             **{f"rot{k}": torch.rot90(base, k) for k in (1, 2, 3)}}
    which = []
    for i in range(n):
        name = next(c for c, v in cases.items() if torch.equal(mask[i], v))
        which.append(name)
        idx = mask[i].flatten()
        undone = torch.empty_like(out[i].flatten(1))
        undone[:, idx] = out[i].flatten(1)
        out[i] = undone.view(3, size, size)
    jittered = (out - plain).abs().flatten(1).amax(dim=1) > 1e-6
    which = np.asarray(which)

    def within_4_sigma(hits, total, p):
        sigma = np.sqrt(p * (1 - p) / total)
        assert abs(hits / total - p) < 4 * sigma, (hits, total, p)

    within_4_sigma(int(jittered.sum()), n, 0.5)
    geom = which != "none"
    # a drawn rot90 with k = 0 moves nothing: P(moved) = 0.3·(1 − 1/12)
    within_4_sigma(int(geom.sum()), n, 0.3 * 11 / 12)
    moved_n = int(geom.sum())
    within_4_sigma(int((which == "hflip").sum()), moved_n, 4 / 11)
    within_4_sigma(int((which == "vflip").sum()), moved_n, 4 / 11)
    for k in (1, 2, 3):
        within_4_sigma(int((which == f"rot{k}").sum()), moved_n, 1 / 11)


# -- which chain the step takes ----------------------------------------------------

@pytest.mark.parametrize("shape,size,parity,stain,dtype,fuse", [
    ((4, 64, 64, 3), 64, False, "none", torch.bfloat16, True),
    ((4, 64, 64, 3), 64, False, "none", torch.float32, False),
    ((4, 64, 64, 3), 64, True, "none", torch.bfloat16, False),
    ((4, 64, 64, 3), 64, False, "macenko", torch.bfloat16, False),
    ((4, 48, 48, 3), 64, False, "none", torch.bfloat16, False),
    ((4, 60, 60, 3), 60, False, "none", torch.bfloat16, False),
    ((4, 64, 48, 3), 64, False, "none", torch.bfloat16, False),
])
def test_can_fuse_augment_has_the_jax_clauses(shape, size, parity, stain,
                                              dtype, fuse):
    assert can_fuse_augment(shape, size, parity, stain, dtype) is fuse


def test_fused_plain_version_keeps_class_ids():
    """A 3-class config without stain still fuses: the kernel's plain
    version moves mask bytes 0..2 under the geometry, unchanged."""
    images, masks = _batch(7, seed=4)
    facs, ints = _draws(7, seed=4)
    ints[:, 5:8] = [(0, 0, 0), (1, 0, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3),
                    (1, 2, 0), (1, 1, 0)]
    tables = augment.make_augment_tables(torch.from_numpy(facs),
                                         torch.from_numpy(ints))
    _, got = fused_train_transform(torch.from_numpy(images),
                                   torch.from_numpy(masks), tables)
    m = torch.from_numpy(masks).float()
    want = [m[0], m[1].flip(-1), torch.rot90(m[2], 1, (-2, -1)),
            torch.rot90(m[3], 2, (-2, -1)), torch.rot90(m[4], 3, (-2, -1)),
            m[5].flip(-2), m[6]]
    assert torch.equal(got, torch.stack(want))
    assert set(got.unique().tolist()) == {0.0, 1.0, 2.0}

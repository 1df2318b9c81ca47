"""The port's train augmentation (``ops/augment.py``, ``ops/fused_augment.py``)
against the JAX package.

The port's CUDA kernel runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  Here the plain version, which is what a
CPU tensor takes, is fed the JAX package's own tables and held against
the Pallas ``fused_augment_planar`` in interpret mode and against the XLA
``train_transform`` chain, with the bound of ``tests/test_fused_augment.py``:
an image element is off when ``|Δ| > 0.06 + 0.02·|ref|`` (last-ulp bf16
double roundings where two compilers group the slot sums differently), and
fewer than 5e-4 of the elements may be off; masks are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.ops.augment import (
    draw_augment_scalars as jax_draw_augment_scalars,
    eval_transform as jax_eval_transform,
    geom_bits as jax_geom_bits,
    jitter_slot_params as jax_jitter_slot_params,
    train_transform as jax_train_transform,
)
from pdac_pathological_image_segmentation_tpu.ops.pallas.fused_augment import (
    fused_augment_planar,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    AugmentTables,
    apply_one_of_geom,
    check_supported,
    draw_augment_scalars,
    eval_transform,
    geom_bits,
    jitter_slot_params,
    make_augment_tables,
    train_transform,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
    TILE,
    fused_train_transform,
    fused_train_transform_reference,
    in_tile,
    lookup_tables,
    out_tile,
    vector_path,
)

S = 64
# (g_apply, choice, rot_k): none, hflip, rot90 k = 0..3, vflip
GEOMETRY = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3),
            (1, 2, 0)]


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    masks = rng.integers(0, 2, (n, S, S), dtype=np.uint8)
    return images, masks


def _jax_tables(facs, ints) -> AugmentTables:
    """The JAX package's tables of one batch, as the port's."""
    a_mats, gammas = jax_jitter_slot_params(jnp.asarray(facs),
                                            jnp.asarray(ints))
    geom = jax_geom_bits(jnp.asarray(ints))
    return AugmentTables(*(torch.from_numpy(np.array(t)) for t in (
        a_mats, gammas, np.asarray(ints, np.int32), geom)))


def _hand_built(n_jitter_on):
    """Seven samples, one per geometry case; the first ``n_jitter_on`` of
    them with the jitter applied, the slot order varied."""
    rng = np.random.default_rng(3)
    facs = np.stack([rng.uniform(0.7, 1.3, 7), rng.uniform(0.7, 1.3, 7),
                     rng.uniform(0.7, 1.3, 7), rng.uniform(-0.3, 0.3, 7)],
                    axis=1).astype(np.float32)
    ints = np.zeros((7, 8), np.int32)
    for i, (g, choice, k) in enumerate(GEOMETRY):
        ints[i, :4] = np.roll(np.arange(4), i)
        ints[i, 4] = int(i < n_jitter_on)
        ints[i, 5:8] = (g, choice, k)
    return facs, ints


def _assert_bound(got_i, ref_i, got_m, ref_m):
    gi, ri = np.asarray(got_i, np.float32), np.asarray(ref_i, np.float32)
    viol = np.abs(gi - ri) > (0.06 + 0.02 * np.abs(ri))
    assert viol.mean() < 5e-4, (
        f"{viol.sum()} elements beyond the bound (max |Δ| "
        f"{np.abs(gi - ri).max():.4f})")
    np.testing.assert_array_equal(np.asarray(got_m), np.asarray(ref_m))


def _port_nhwc(images, masks, tables):
    out, m = train_transform(torch.from_numpy(images),
                             torch.from_numpy(masks), tables)
    assert out.dtype == torch.bfloat16 and m.dtype == torch.float32
    assert out.shape == (images.shape[0], 3, S, S) and out.is_contiguous()
    return out.float().numpy().transpose(0, 2, 3, 1), m.numpy()


@pytest.mark.parametrize("n_jitter_on", [0, 4, 7])
def test_plain_matches_pallas_interpret_every_geometry(n_jitter_on):
    images, masks = _batch(7, seed=n_jitter_on)
    facs, ints = _hand_built(n_jitter_on)
    tables = _jax_tables(facs, ints)
    ref_i, ref_m = fused_augment_planar(
        jnp.asarray(images.transpose(0, 3, 1, 2)), jnp.asarray(masks),
        *(jnp.asarray(t.numpy()) for t in tables), interpret=True)
    got_i, got_m = _port_nhwc(images, masks, tables)
    _assert_bound(got_i, np.asarray(ref_i, np.float32).transpose(0, 2, 3, 1),
                  got_m, ref_m)
    # every sample's mask moved as its geometry says (7 distinct cases)
    assert len({got_m[i].tobytes() for i in range(7)}) == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_xla_train_transform(seed):
    images, masks = _batch(6, seed=10 + seed)
    key = jax.random.PRNGKey(seed)
    ref_i, ref_m = jax_train_transform(key, jnp.asarray(images),
                                       jnp.asarray(masks), img_size=S,
                                       dtype=jnp.bfloat16)
    facs, ints = jax_draw_augment_scalars(key, 6)
    got_i, got_m = _port_nhwc(images, masks,
                              _jax_tables(np.asarray(facs), np.asarray(ints)))
    _assert_bound(got_i, ref_i, got_m, ref_m)


def test_port_tables_match_jax_tables():
    """``jitter_slot_params`` and ``geom_bits`` of the port on the JAX
    draws: the matrices within f32 rounding of cos/sin and of the 3×3
    products (1e-6), the geometry bits equal."""
    facs, ints = jax_draw_augment_scalars(jax.random.PRNGKey(7), 64)
    facs, ints = np.array(facs), np.array(ints)
    ref = _jax_tables(facs, ints)
    a_mats, gammas = jitter_slot_params(torch.from_numpy(facs),
                                        torch.from_numpy(ints))
    np.testing.assert_allclose(a_mats.numpy(), ref.a_mats.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(gammas.numpy(), ref.gammas.numpy(),
                               rtol=0, atol=1e-6)
    assert torch.equal(geom_bits(torch.from_numpy(ints)), ref.geom)


def test_draws_have_the_jax_distributions():
    """The two RNG streams differ, so the draws are held on their laws over
    many samples: ranges, means, permutations, and the frequencies of
    j_apply (0.5), g_apply (0.3), choice (1/3 each) and rot_k (1/4 each),
    each within 0.02 (about 5 standard errors at n = 20000)."""
    n = 20000
    facs, ints = draw_augment_scalars(n, torch.Generator().manual_seed(0))
    assert facs.dtype == torch.float32 and ints.dtype == torch.int32
    f, iv = facs.numpy(), ints.numpy()
    for col, (lo, hi) in enumerate([(0.7, 1.3)] * 3 + [(-0.3, 0.3)]):
        assert lo <= f[:, col].min() and f[:, col].max() <= hi
        assert abs(f[:, col].mean() - (lo + hi) / 2) < 0.01
    assert (np.sort(iv[:, :4], axis=1) == np.arange(4)).all()
    for slot in range(4):
        assert np.abs(np.bincount(iv[:, slot], minlength=4) / n - 0.25
                      ).max() < 0.02
    assert abs(iv[:, 4].mean() - 0.5) < 0.02
    assert abs(iv[:, 5].mean() - 0.3) < 0.02
    assert np.abs(np.bincount(iv[:, 6], minlength=3) / n - 1 / 3).max() < 0.02
    assert np.abs(np.bincount(iv[:, 7], minlength=4) / n - 0.25).max() < 0.02
    again = draw_augment_scalars(n, torch.Generator().manual_seed(0))
    assert torch.equal(again[0], facs) and torch.equal(again[1], ints)


@pytest.mark.parametrize("dtype,in_size", [("float32", S), ("bfloat16", S),
                                           ("float32", 80)])
def test_eval_transform_matches_jax(dtype, in_size):
    """Native size: the same normalize in the same dtype, bitwise in f32
    up to one rounding (1e-6) and one bf16 ulp in bf16.  80² input:
    resized on ingest; the two bilinear resizes take their source
    coordinates at different precisions (``test_torch_fpn``), up to about
    2e-3 on the 0..255 scale, 1e-4 after the normalize."""
    rng = np.random.default_rng(in_size)
    images = rng.integers(0, 256, (3, in_size, in_size, 3), dtype=np.uint8)
    masks = rng.integers(0, 2, (3, in_size, in_size), dtype=np.uint8)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref_i, ref_m = jax_eval_transform(jnp.asarray(images), jnp.asarray(masks),
                                      img_size=S, dtype=jdt)
    got_i, got_m = eval_transform(torch.from_numpy(images),
                                  torch.from_numpy(masks), S,
                                  getattr(torch, dtype))
    assert got_i.dtype == getattr(torch, dtype) and got_i.is_contiguous()
    gi = got_i.float().numpy().transpose(0, 2, 3, 1)
    ri = np.asarray(ref_i, np.float32)
    if in_size != S:
        np.testing.assert_allclose(gi, ri, rtol=0, atol=1e-4)
    elif dtype == "float32":
        np.testing.assert_allclose(gi, ri, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(gi, ri, rtol=2 ** -7, atol=0)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    images, masks = _batch(4, seed=5)
    gen = torch.Generator().manual_seed(1)
    tables = make_augment_tables(*draw_augment_scalars(4, gen))
    before = fused_train_transform.launches
    got = fused_train_transform(torch.from_numpy(images),
                                torch.from_numpy(masks), tables)
    want = fused_train_transform_reference(torch.from_numpy(images),
                                           torch.from_numpy(masks), tables)
    assert fused_train_transform.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    images, masks = _batch(2, seed=6)
    tables = make_augment_tables(*draw_augment_scalars(
        2, torch.Generator().manual_seed(2)))
    img, msk = torch.from_numpy(images), torch.from_numpy(masks)
    with pytest.raises(ValueError, match="square"):
        fused_train_transform(img[:, :, :32], msk[:, :, :32], tables)
    with pytest.raises(TypeError, match="uint8"):
        fused_train_transform(img.float(), msk, tables)
    with pytest.raises(ValueError, match="tables.geom"):
        fused_train_transform(img, msk, tables._replace(
            geom=tables.geom.long()))
    with pytest.raises(ValueError, match="tables.a_mats"):
        fused_train_transform(img[:1], msk[:1], tables)


@pytest.mark.parametrize("knob", ["parity_mode", "stain"])
def test_unported_options_name_the_roadmap(knob):
    kwargs = {"parity_mode": True} if knob == "parity_mode" \
        else {"stain": "macenko"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(**kwargs)


def test_lookup_tables_are_the_plain_chain_bit_for_bit():
    """The kernel's byte tables: ``unit`` is bf16(v / 255) rounded to
    nearest even from the f32 quotient (computed here with numpy alone),
    ``norm`` the plain chain's output of an un-jittered, unflipped patch
    that holds every byte value in every channel."""
    unit, norm = lookup_tables("cpu")
    assert unit.dtype == torch.float32 and tuple(unit.shape) == (256,)
    assert norm.dtype == torch.bfloat16 and tuple(norm.shape) == (3, 256)
    assert lookup_tables(torch.device("cpu")) is lookup_tables("cpu")
    q = (np.arange(256, dtype=np.float32) / np.float32(255)).view(np.uint32)
    rne = ((q + 0x7FFF + ((q >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    np.testing.assert_array_equal(unit.numpy().view(np.uint32), rne)
    v = np.arange(256).reshape(16, 16)
    images = np.stack([(v + 85 * c) % 256 for c in range(3)], -1)
    images = torch.from_numpy(images.astype(np.uint8)[None])
    facs = torch.ones((1, 4), dtype=torch.float32)
    ints = torch.tensor([[0, 1, 2, 3, 0, 0, 0, 0]], dtype=torch.int32)
    out, _ = fused_train_transform_reference(
        images, torch.zeros((1, 16, 16), dtype=torch.uint8),
        make_augment_tables(facs, ints))
    for c in range(3):
        want = norm[c][images[0, ..., c].flatten().long()]
        assert torch.equal(out[0, c].flatten(), want)


def _geometry(x, t, l, r):
    """``(exch@)ˡ Tᵗ(x) (@exch)ʳ`` of a 2-D array, by definition."""
    if t:
        x = x.T
    if l:
        x = x[::-1]
    if r:
        x = x[:, ::-1]
    return x


# (t, l, r) of each drawn geometry case (``geom_bits``); (1, 0, 0) and
# (1, 1, 1) are never drawn, the kernel takes them all the same
_DRAWN = {tuple(geom_bits(torch.tensor([[0, 1, 2, 3, 0, *g]]))[0].tolist()): g
          for g in GEOMETRY}


@pytest.mark.parametrize("size", [64, 48, 40, 136])
@pytest.mark.parametrize("t,l,r", [(t, l, r) for t in (0, 1) for l in (0, 1)
                                   for r in (0, 1)])
def test_tile_index_math_is_the_geometry(size, t, l, r):
    """``out_tile`` + ``in_tile`` (the kernel's index math) move every
    pixel of every source tile, ragged ones included, where the geometry
    sends it, and each output tile is filled exactly once; where the
    draws reach (t, l, r), ``apply_one_of_geom`` agrees."""
    src = np.arange(size * size).reshape(size, size)
    want = _geometry(src, t, l, r)
    got = np.full((size, size), -1)
    for ty0 in range(0, size, TILE):
        for tx0 in range(0, size, TILE):
            th, tw = min(TILE, size - ty0), min(TILE, size - tx0)
            row0, col0, rows, cols = out_tile(size, ty0, tx0, t, l, r)
            assert (rows, cols) == ((tw, th) if t else (th, tw))
            i, j = np.mgrid[:th, :tw]
            oi, oj = in_tile(i, j, th, tw, t, l, r)
            assert oi.min() == 0 and oi.max() == rows - 1
            assert oj.min() == 0 and oj.max() == cols - 1
            assert (got[row0 + oi, col0 + oj] == -1).all()
            got[row0 + oi, col0 + oj] = src[ty0 + i, tx0 + j]
    np.testing.assert_array_equal(got, want)
    if (t, l, r) in _DRAWN:
        ints = torch.tensor([[0, 1, 2, 3, 0, *_DRAWN[t, l, r]]])
        img = torch.from_numpy(src.astype(np.float32))
        moved, _ = apply_one_of_geom(img[None, None], img[None], ints)
        np.testing.assert_array_equal(moved[0, 0].numpy(), want)


@pytest.mark.parametrize("size,offset,vec", [(512, 0, True), (48, 0, True),
                                             (200, 0, False), (40, 0, False),
                                             (64, 1, False)])
def test_vector_path_needs_aligned_rows(size, offset, vec):
    """The 16-byte instantiation takes sizes that are a multiple of 16 on
    16-byte aligned tensors; the others take the byte-load one."""
    buf = torch.empty(size * size * 3 + 16, dtype=torch.uint8)
    images = buf[offset:offset + size * size * 3]
    assert vector_path(size, images) is vec

"""The PyTorch port's whole-slide inference against the JAX package, on the
CPU: ``ops/stitch.py``, ``ops/tissue.py``, ``data/synthetic.py``,
``infer/wsi.py`` and ``cli/overlay.py``.

* Stitching: ``stitch_tiles`` / ``stitch_tiles_into`` / ``finalize_canvas``
  against the JAX ones for the three blends, overlapping and not, in one
  chunk and in two, binary and channelled: canvases and maps within 1e-6,
  masks equal; a stitched map repeats bit for bit.
* Tissue masks equal to the JAX ones bit for bit; the tile sources'
  coordinates equal.
* The runners on one seeded FPN (f32, 32² tiles; the JAX side gets the same
  weights through ``convert_smp_fpn_state_dict``): ``SlidingWindowInference``
  (plain, TTA, uncertainty) and ``BandedSlidingWindow`` (band input and
  window upload) against the JAX runners on ``GridTiler``,
  ``SyntheticSlideSource`` and ``PyHISTTileSource``: probabilities within
  5e-4 (``tests/test_fpn_golden.py``'s probability bound), masks ≥ 99.9%
  equal, uncertainty within 1e-5.
* ``cli.overlay --device cpu`` against the JAX ``cli.overlay.main`` on one
  port-written ``best.pth``: probability maps within 5e-4, the GeoJSON equal
  to the JAX ``mask_to_polygons`` of the port's mask, ``overlay.png`` equal
  to the stated composite (``--sharded``: ``tests/test_torch_wsi_sharded.py``).
"""

import contextlib
import json
import os
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from pdac_pathological_image_segmentation_tpu.cli import overlay as jax_cli
from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.data import (
    synthetic as jax_synthetic,
)
from pdac_pathological_image_segmentation_tpu.data.geojson import (
    mask_to_polygons as jax_mask_to_polygons,
)
from pdac_pathological_image_segmentation_tpu.infer import wsi as jax_wsi
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.ops import stitch as jax_stitch
from pdac_pathological_image_segmentation_tpu.ops import tissue as jax_tissue
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    export as cli_export,
    overlay as cli_overlay,
)
from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    DeviceSlideSource,
    SyntheticSlideSource,
)
from pdac_pathological_image_segmentation_tpu_torch.data.tiffwriter import (
    write_tiff,
)
from pdac_pathological_image_segmentation_tpu_torch.infer import wsi
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.ops import stitch, tissue
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    save_checkpoint,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    make_optimizer,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
    EarlyStop,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)

TILE = 32
PROB_ATOL = 5e-4
_State = namedtuple("_State", "params batch_stats")
BLENDS = ("uniform", "hann", "pyramid")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """32² tiles: one intra-op thread is faster than many, and keeps this
    file's time steady when other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- stitching ----------------------------------------------------------------

def test_blend_windows_equal_jax():
    for mode in BLENDS:
        for t in (32, 48):
            np.testing.assert_array_equal(
                stitch.blend_window(t, mode).numpy(),
                np.asarray(jax_stitch.blend_window(t, mode)), err_msg=mode)
    with pytest.raises(ValueError, match="unknown blend"):
        stitch.blend_window(8, "gauss")


def _tiles(seed, n, channels):
    rng = np.random.default_rng(seed)
    shape = (n, TILE, TILE) + ((channels,) if channels else ())
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("blend", BLENDS)
def test_stitch_matches_jax(blend, overlap, chunked, channels):
    step = TILE // 2 if overlap else TILE
    coords = np.asarray([(y, x) for y in (0, step, 2 * step)
                         for x in (0, step)], np.int32)
    probs = _tiles(7, len(coords), channels)
    canvas = (2 * step + TILE, step + TILE + 8)  # a strip no tile covers
    if channels:
        probs = probs / probs.sum(-1, keepdims=True)
    cut = 4 if chunked else len(coords)
    a, w = stitch.stitch_tiles(torch.from_numpy(probs[:cut]), coords[:cut],
                               canvas, blend=blend)
    ja, jw = jax_stitch.stitch_tiles(jnp.asarray(probs[:cut]),
                                     jnp.asarray(coords[:cut]),
                                     canvas_hw=canvas, blend=blend)
    if chunked:
        a2, w2 = stitch.stitch_tiles_into(a, w, torch.from_numpy(probs[cut:]),
                                          coords[cut:], blend=blend)
        assert a2 is a and w2 is w  # in place
        ja, jw = jax_stitch.stitch_tiles_into(
            ja, jw, jnp.asarray(probs[cut:]), jnp.asarray(coords[cut:]),
            blend=blend)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    prob, mask = stitch.finalize_canvas(a, w)
    jprob, jmask = jax_stitch.finalize_canvas(ja, jw)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.dtype == torch.uint8
    # the strip no tile covers: probability 0, class 0
    assert float(prob[:, -8:].abs().max()) == 0.0
    assert int(mask[:, -8:].max()) == 0


def test_stitch_repeats_bitwise_and_thresholds():
    probs = torch.from_numpy(_tiles(3, 12, 0))
    coords = [(y, x) for y in (0, 8, 16) for x in (0, 8, 16, 24)]
    a1, w1 = stitch.stitch_tiles(probs, coords, (48, 56), blend="hann")
    a2, w2 = stitch.stitch_tiles(probs, coords, (48, 56), blend="hann")
    assert torch.equal(a1, a2) and torch.equal(w1, w2)
    prob, mask = stitch.finalize_canvas(a1, w1, threshold=0.25)
    assert torch.equal(mask, (prob >= 0.25).to(torch.uint8))


def test_tissue_masks_equal_jax():
    rng = np.random.default_rng(0)
    slide = np.full((64, 96, 3), 248, np.uint8)
    slide[:, 48:] = np.stack([rng.integers(150, 220, (64, 48)),
                              rng.integers(60, 140, (64, 48)),
                              rng.integers(140, 200, (64, 48))], -1)
    slide[:8, :8] = 5  # pen/black
    noise = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    unit = rng.random((16, 16, 3)).astype(np.float32)
    for img in (slide, noise, unit):
        want = jax_tissue.tissue_mask_np(img)
        np.testing.assert_array_equal(tissue.tissue_mask_np(img), want)
        np.testing.assert_array_equal(
            tissue.tissue_mask(torch.from_numpy(img)).numpy(),
            np.asarray(jax_tissue.tissue_mask(jnp.asarray(img))))
        np.testing.assert_array_equal(
            tissue.tissue_mask(torch.from_numpy(img)).numpy(), want)
        assert tissue.tissue_fraction_np(img) == \
            jax_tissue.tissue_fraction_np(img)
    batch = np.stack([slide[:, :48], slide[:, 48:]])
    np.testing.assert_array_equal(
        tissue.tissue_fraction(torch.from_numpy(batch)).numpy(),
        np.asarray(jax_tissue.tissue_fraction(jnp.asarray(batch))))
    assert (tissue.SAT_THRESH, tissue.WHITE_THRESH, tissue.BLACK_THRESH) == (
        jax_tissue.SAT_THRESH, jax_tissue.WHITE_THRESH,
        jax_tissue.BLACK_THRESH)


@pytest.mark.parametrize("shape,stride,thresh", [
    ((100, 70), TILE, 0.0), ((20, 50), TILE, 0.0), ((96, 128), 16, 0.5)])
def test_grid_tiler_equals_jax(shape, stride, thresh):
    rng = np.random.default_rng(1)
    slide = np.full(shape + (3,), 248, np.uint8)
    half = shape[1] // 2
    slide[:, half:] = rng.integers(60, 220, (shape[0], shape[1] - half, 3))
    ours = wsi.GridTiler(slide, tile=TILE, stride=stride,
                         tissue_threshold=thresh)
    ref = jax_wsi.GridTiler(slide, tile=TILE, stride=stride,
                            tissue_threshold=thresh)
    assert ours.coords == ref.coords and ours.canvas_hw == ref.canvas_hw
    assert ours.orig_hw == ref.orig_hw
    np.testing.assert_array_equal(ours.get(len(ours) - 1)[0],
                                  ref.get(len(ref) - 1)[0])
    np.testing.assert_array_equal(ours.read_region(8, 8, 40, 200),
                                  ref.read_region(8, 8, 40, 200))


def test_synthetic_source_equals_jax():
    ours = SyntheticSlideSource(size=200, tile=TILE, stride=24, seed=3)
    ref = jax_synthetic.SyntheticSlideSource(size=200, tile=TILE, stride=24,
                                             seed=3)
    assert ours.coords == ref.coords and ours.canvas_hw == ref.canvas_hw
    for args in ((0, 0, 200, 200), (-10, 190, 40, 40), (37, 5, 64, 150)):
        np.testing.assert_array_equal(ours.read_region(*args),
                                      ref.read_region(*args))
    np.testing.assert_array_equal(ours.get(17)[0], ref.get(17)[0])
    # windows are crops of the region reads
    y, x = ours.coords[9]
    np.testing.assert_array_equal(
        ours.get(9)[0], ours.read_region(0, 0, 200, 200)[y:y + TILE,
                                                         x:x + TILE])


def test_device_source_reads_agree_and_match_jax():
    """Overlapping reads equal bit for bit; against the JAX source within
    one level everywhere (sin/cos may differ by an ulp and the cast
    truncates) and equal on at least 99.9% of the values."""
    ours = DeviceSlideSource(size=300, tile=TILE, stride=24, seed=3,
                             device="cpu")
    ref = jax_synthetic.DeviceSlideSource(size=300, tile=TILE, stride=24,
                                          seed=3)
    assert ours.coords == ref.coords and ours.canvas_hw == ref.canvas_hw
    whole = ours.read_region(0, 0, 300, 300)
    assert whole.dtype == torch.uint8 and tuple(whole.shape) == (300, 300, 3)
    part = ours.read_region(37, 45, 64, 150)
    assert torch.equal(whole[37:101, 45:195], part)
    y, x = ours.coords[9]
    np.testing.assert_array_equal(ours.get(9)[0],
                                  whole[y:y + TILE, x:x + TILE].numpy())
    for args in ((0, 0, 300, 300), (40_000, 39_000, 48, 64)):
        got = ours.read_region(*args).numpy().astype(np.int16)
        want = np.asarray(ref.read_region(*args)).astype(np.int16)
        assert np.abs(got - want).max() <= 1
        assert np.mean(got == want) >= 0.999
    with pytest.raises(RuntimeError, match="no CUDA device") \
            if not torch.cuda.is_available() else _no_raise():
        DeviceSlideSource(size=64)


@contextlib.contextmanager
def _no_raise():
    yield


def _pyhist_dir(root, rng):
    tile_dir = root / "tiles"
    tile_dir.mkdir()
    rows = ["Tile\tRow\tColumn\tKeep"]
    for r in range(2):
        for c in range(3):
            name = f"tile_{r}_{c}.png"
            if (r, c) == (0, 1):  # background glass
                arr = np.full((TILE, TILE, 3), 246, np.uint8)
            else:
                arr = rng.integers(0, 256, (TILE, TILE, 3), dtype=np.uint8)
            Image.fromarray(arr).save(tile_dir / name)
            rows.append(f"{name}\t{r}\t{c}\t{0 if (r, c) == (1, 2) else 1}")
    tsv = root / "tile_selection.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    return tile_dir, tsv


def test_pyhist_source_equals_jax(tmp_path):
    tile_dir, tsv = _pyhist_dir(tmp_path, np.random.default_rng(0))
    for thresh in (0.0, 0.5):
        ours = wsi.PyHISTTileSource(str(tile_dir), str(tsv), tile=TILE,
                                    tissue_threshold=thresh, num_workers=2)
        ref = jax_wsi.PyHISTTileSource(str(tile_dir), str(tsv), tile=TILE,
                                       tissue_threshold=thresh, num_workers=2)
        assert ours.entries == ref.entries and ours.canvas_hw == ref.canvas_hw
        assert len(ours) == (5 if thresh == 0.0 else 4)
        img, yx = ours.get(1)
        np.testing.assert_array_equal(img, ref.get(1)[0])
        assert yx == ref.get(1)[1]


# -- the runners --------------------------------------------------------------

@pytest.fixture(scope="module")
def fpn():
    """(port FPN, JAX FPN, JAX state) from one seeded smp-named sd."""
    cfg = Config(model="fpn", img_size=TILE, compute_dtype="float32")
    model = build_model(cfg)
    sd = seeded_state_dict(model, seed=11)
    model.load_state_dict(sd, strict=True)
    model.eval()
    jmodel = jax_build_model(JaxConfig(model="fpn", img_size=TILE,
                                       compute_dtype="float32"))
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, TILE, TILE, 3)), train=False)
    params, batch_stats = convert_smp_fpn_state_dict(
        {k: v.numpy() for k, v in sd.items()}, variables["params"],
        variables["batch_stats"])
    return model, jmodel, _State(params, batch_stats)


def _assert_maps_close(got, want, unc=False):
    (p, m), (q, n) = got[:2], want[:2]
    assert p.shape == q.shape and m.shape == n.shape
    assert p.dtype == q.dtype and m.dtype == n.dtype == np.uint8
    np.testing.assert_allclose(p.astype(np.float32), q.astype(np.float32),
                               rtol=0, atol=PROB_ATOL)
    assert (m == n).mean() >= 0.999
    if unc:
        assert got[2].dtype == want[2].dtype
        np.testing.assert_allclose(got[2].astype(np.float32),
                                   want[2].astype(np.float32), rtol=0,
                                   atol=1e-5)
        assert float(np.asarray(got[2], np.float32).max()) > 0.0


def _slide(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("mode", ["plain", "tta", "uncertainty"])
def test_sliding_window_matches_jax(fpn, mode):
    model, jmodel, state = fpn
    tta, unc = mode != "plain", mode == "uncertainty"
    tiler = wsi.GridTiler(_slide(0, 80, 72), tile=TILE, stride=16)
    kw = dict(tile=TILE, batch_size=4, tta=tta, blend="hann", num_workers=2,
              uncertainty=unc)
    got = wsi.SlidingWindowInference(model, **kw).run(tiler)
    want = jax_wsi.SlidingWindowInference(jmodel, state, **kw).run(tiler)
    assert len(got) == len(want) == (3 if unc else 2)
    assert got[0].shape == (80, 72)
    _assert_maps_close(got, want, unc)


def test_sliding_window_small_slide_and_pyhist_match_jax(fpn, tmp_path):
    model, jmodel, state = fpn
    kw = dict(tile=TILE, batch_size=4, blend="uniform", num_workers=2)
    tiler = wsi.GridTiler(_slide(1, 20, 50), tile=TILE)
    got = wsi.SlidingWindowInference(model, **kw).run(tiler)
    assert got[0].shape == (20, 50)
    _assert_maps_close(got, jax_wsi.SlidingWindowInference(
        jmodel, state, **kw).run(tiler))
    tile_dir, tsv = _pyhist_dir(tmp_path, np.random.default_rng(2))
    source = wsi.PyHISTTileSource(str(tile_dir), str(tsv), tile=TILE)
    got = wsi.SlidingWindowInference(model, **kw).run(source)
    _assert_maps_close(got, jax_wsi.SlidingWindowInference(
        jmodel, state, **kw).run(source))
    # the dropped tile's region is uncovered → probability 0
    assert got[0][TILE:, 2 * TILE:].max() == 0.0


@pytest.mark.parametrize("band_input", [True, False])
def test_banded_matches_jax(fpn, band_input):
    model, jmodel, state = fpn
    src = SyntheticSlideSource(size=120, tile=TILE, stride=24, seed=5)
    jsrc = jax_synthetic.SyntheticSlideSource(size=120, tile=TILE, stride=24,
                                              seed=5)
    kw = dict(tile=TILE, batch_size=4, band_h=40, blend="hann",
              num_workers=2, band_input=band_input)
    runner = wsi.BandedSlidingWindow(model, **kw)
    got = runner.run(src)
    want = jax_wsi.BandedSlidingWindow(jmodel, state, **kw).run(jsrc)
    assert got[0].dtype == np.float16
    _assert_maps_close(got, want)
    bands = -(-120 // 40)
    assert runner.last_run["bands"] == (bands if band_input else 0)
    assert runner.last_run["band_upload_bytes"] == (
        bands * (40 + TILE) * 120 * 3 if band_input else 0)


def test_banded_on_device_source_equals_grid_tiler_run(fpn):
    """Bands made by ``DeviceSlideSource`` go through the runner untouched
    (no upload bytes) and give the run on a ``GridTiler`` of the same
    pixels bit for bit; a band on another device is refused."""
    model = fpn[0]
    src = DeviceSlideSource(size=100, tile=TILE, stride=24, seed=5,
                            device="cpu")
    grid = wsi.GridTiler(src.read_region(0, 0, 100, 100).numpy(), tile=TILE,
                         stride=24)
    assert grid.coords == src.coords
    runs = []
    for source in (src, grid):
        runner = wsi.BandedSlidingWindow(model, tile=TILE, batch_size=4,
                                         band_h=40, blend="hann",
                                         num_workers=1)
        runs.append((runner.run(source), runner.last_run))
    (got, stats), (want, gstats) = runs
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # tiles start at rows 0, 24, 48 and 68: two bands of 40 rows hold them
    assert stats["band_upload_bytes"] == 0 and stats["bands"] == 2
    assert gstats["band_upload_bytes"] > 0

    class Elsewhere(DeviceSlideSource):
        def read_region(self, y, x, h, w):
            return torch.empty((h, w, 3), dtype=torch.uint8, device="meta")

    with pytest.raises(ValueError, match="band on meta"):
        wsi.BandedSlidingWindow(model, tile=TILE, batch_size=4, band_h=40,
                                num_workers=1).run(
            Elsewhere(size=100, tile=TILE, stride=24, device="cpu"))


def test_banded_uncertainty_matches_jax_and_plain(fpn):
    model, jmodel, state = fpn
    tiler = wsi.GridTiler(_slide(4, 104, 64), tile=TILE, stride=16)
    kw = dict(tile=TILE, batch_size=4, tta=True, uncertainty=True,
              blend="hann", num_workers=2)
    got = wsi.BandedSlidingWindow(model, band_h=TILE, **kw).run(
        tiler, prob_dtype=np.float32)
    want = jax_wsi.BandedSlidingWindow(jmodel, state, band_h=TILE, **kw).run(
        tiler, prob_dtype=np.float32)
    _assert_maps_close(got, want, unc=True)
    # the banded runner equals the whole-canvas one within float16 rounding
    plain = wsi.SlidingWindowInference(model, **kw).run(tiler)
    half = wsi.BandedSlidingWindow(model, band_h=40, **kw).run(tiler)
    for b, p in zip(half, plain):
        np.testing.assert_allclose(b.astype(np.float32), p,
                                   rtol=2 ** -11, atol=2 ** -24)
    np.testing.assert_array_equal(got[1], plain[1])


def test_tta_matches_manual_dihedral_average(fpn):
    model = fpn[0]
    img = torch.from_numpy(_slide(2, 2 * TILE, TILE).reshape(2, TILE, TILE, 3))
    plain = wsi.SlidingWindowInference(model, tile=TILE, tta=False)._infer
    tta = wsi.SlidingWindowInference(model, tile=TILE, tta=True)._infer
    expected = np.zeros((2, TILE, TILE), np.float32)
    for flip in (False, True):
        base = img.numpy()[:, :, ::-1, :] if flip else img.numpy()
        for k in range(4):
            p = plain(torch.from_numpy(np.rot90(base, k, axes=(1, 2)).copy()))
            p = np.rot90(p.numpy(), -k, axes=(1, 2))
            expected += p[:, :, ::-1] if flip else p
    np.testing.assert_allclose(tta(img).numpy(), expected / 8.0, atol=1e-6)


def test_runner_refusals(fpn):
    model = fpn[0]
    with pytest.raises(ValueError, match="uncertainty maps require tta"):
        wsi.SlidingWindowInference(model, tile=TILE, uncertainty=True)
    multi = build_model(Config(model="fpn", img_size=TILE, num_classes=3,
                               compute_dtype="float32"))
    with pytest.raises(ValueError, match="multi-class"):
        wsi.BandedSlidingWindow(multi, tile=TILE)
    src = wsi.PyHISTTileSource.__new__(wsi.PyHISTTileSource)
    src.entries, src.canvas_hw, src.tile = [], (TILE, TILE), TILE
    with pytest.raises(ValueError, match="read_region"):
        wsi.BandedSlidingWindow(model, tile=TILE, band_input=True).run(src)
    with pytest.raises(ValueError, match="empty"):
        wsi.SlidingWindowInference(model, tile=TILE).run(src)
    with pytest.raises(ValueError, match="device="):
        wsi.SlidingWindowInference(None, tile=TILE,
                                   infer_step=lambda x: x)


def test_multiclass_canvas_is_argmax():
    step = lambda imgs: torch.softmax(  # noqa: E731
        imgs.float()[..., :3] / 40.0, dim=-1)
    tiler = wsi.GridTiler(_slide(5, 48, 48), tile=TILE, stride=16)
    prob, cls = wsi.SlidingWindowInference(
        None, tile=TILE, batch_size=3, blend="pyramid", infer_step=step,
        device="cpu").run(tiler)
    assert prob.shape == (48, 48, 3) and cls.dtype == np.uint8
    np.testing.assert_array_equal(cls, prob.argmax(-1))


def test_overlay_composite(tmp_path):
    rng = np.random.default_rng(3)
    thumb = rng.integers(0, 256, (30, 45, 3), dtype=np.uint8)
    mask = (rng.random((64, 96)) < 0.5).astype(np.uint8)
    path = wsi.overlay_figure(thumb, mask, str(tmp_path / "o.png"))
    got = np.asarray(Image.open(path))
    assert got.shape == (30, 45, 3)
    ys = (np.arange(30) * (64 / 30)).astype(np.int64)
    xs = (np.arange(45) * (96 / 45)).astype(np.int64)
    a = mask[np.ix_(ys, xs)].astype(np.float32)[..., None] * np.float32(0.4)
    red = np.zeros((30, 45, 3), np.float32)
    red[..., 0] = 1.0
    want = np.round((thumb / np.float32(255.0) * (1 - a) + red * a) * 255.0)
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    # class k ≥ 1 takes matplotlib's tab10 colour k − 1
    classes = rng.integers(0, 4, (30, 45)).astype(np.uint8)
    got = np.asarray(Image.open(wsi.overlay_figure(
        thumb, classes, str(tmp_path / "c.png"), num_classes=4)))
    sel = classes == 2
    want = np.round((thumb[sel] / np.float32(255.0) * np.float32(0.6)
                     + wsi.TAB10[1] * np.float32(0.4)) * 255.0)
    np.testing.assert_array_equal(got[sel], want.astype(np.uint8))
    np.testing.assert_array_equal(got[classes == 0], thumb[classes == 0])
    try:
        from matplotlib import colormaps
    except ImportError:
        return
    np.testing.assert_allclose(
        wsi.TAB10, [colormaps["tab10"](k)[:3] for k in range(10)], atol=1e-6)


# -- the CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A PyHIST directory and a deflate pyramidal TIFF, one port-written
    ``best.pth`` and a config that names them."""
    root = tmp_path_factory.mktemp("overlay")
    tile_dir, tsv = _pyhist_dir(root, np.random.default_rng(6))
    slide = _slide(7, 90, 110)
    write_tiff(str(root / "slide.tiff"), slide, tile=32, min_size=32)
    cfg = Config(model="fpn", img_size=TILE, compute_dtype="float32")
    model = build_model(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=13), strict=True)
    save_checkpoint(str(root / "pth"), model, make_optimizer(model, 1e-4), 1,
                    0.5, {"lr": 1e-4, "best": 0.5, "num_bad_epochs": 0},
                    EarlyStop().state_dict(), is_best=True)
    raw = {"model": "fpn", "backbone": "resnet18", "img_size": TILE,
           "batch_size": 4, "num_worker": 2, "compute_dtype": "float32",
           "tile_path": str(tile_dir), "tsv_path": str(tsv)}
    (root / "cfg.yaml").write_text(yaml.safe_dump(raw))
    return root


def _both(root, name, extra):
    base = ["--config", str(root / "cfg.yaml"), "--pth_path",
            str(root / "pth" / "best.pth")]
    ours = cli_overlay.main(base + ["--save_path", str(root / name / "port"),
                                    "--device", "cpu"] + extra)
    ref = jax_cli.main(base + ["--save_path", str(root / name / "jax")]
                       + extra)
    return ours, ref, root / name / "port", root / name / "jax"


def test_cli_overlay_pyhist_matches_jax(cli_run):
    ours, ref, out, jout = _both(cli_run, "pyhist",
                                 ["--geojson", "--min_region", "4"])
    p = np.load(out / "probability_map.npy")
    np.testing.assert_allclose(p, np.load(jout / "probability_map.npy"),
                               rtol=0, atol=PROB_ATOL)
    assert ours["n_tiles"] == ref["n_tiles"] == 5
    assert abs(ours["tumor_fraction"] - ref["tumor_fraction"]) < 1e-3
    gj = json.loads((out / "annotations.geojson").read_text())
    from pdac_pathological_image_segmentation_tpu.data.geojson import (
        clean_mask as jax_clean_mask,
    )
    mask = jax_clean_mask((p >= 0.5).astype(np.uint8), min_area=4)
    want = jax_mask_to_polygons(mask)
    assert len(gj["features"]) == len(want)
    for feat, (ext, holes) in zip(gj["features"], want):
        assert feat["geometry"]["coordinates"] == [ext.tolist()] + [
            h.tolist() for h in holes]
        assert feat["properties"]["measurements"]["tumor_fraction"] == \
            pytest.approx(float(mask.mean()))
    assert ours["tumor_fraction"] == pytest.approx(float(mask.mean()))
    # no slide: the overlay is the composite over a white canvas
    png = np.asarray(Image.open(out / "overlay.png"))
    assert png.shape == p.shape + (3,)
    white = np.full(png.shape, 255, np.uint8)
    want = np.round((white / np.float32(255.0) * np.float32(0.6)
                     + np.float32(0.4) * np.array([1, 0, 0], np.float32))
                    * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(png[mask == 1], want[mask == 1])
    np.testing.assert_array_equal(png[mask == 0], white[mask == 0])


def test_cli_overlay_slide_banded_tta_matches_jax(cli_run):
    extra = ["--slide", str(cli_run / "slide.tiff"), "--stride", "16",
             "--banded", "--band_h", "40", "--blend", "hann", "--tta",
             "--uncertainty", "--export_tiff"]
    ours, ref, out, jout = _both(cli_run, "slide", extra)
    p = np.load(out / "probability_map.npy")
    assert p.shape == (90, 110) and p.dtype == np.float16
    np.testing.assert_allclose(
        p.astype(np.float32),
        np.load(jout / "probability_map.npy").astype(np.float32),
        rtol=0, atol=PROB_ATOL)
    # float16 maps: 1e-5, or one float16 step of the value
    np.testing.assert_allclose(
        np.load(out / "uncertainty_map.npy").astype(np.float32),
        np.load(jout / "uncertainty_map.npy").astype(np.float32),
        rtol=2 ** -10, atol=1e-5)
    for name in ("probability_map.tiff", "uncertainty_map.tiff"):
        assert os.path.getsize(out / name) > 0
    # the slide is its own thumbnail: overlay at the slide's size
    png = np.asarray(Image.open(out / "overlay.png"))
    assert png.shape == (90, 110, 3)
    assert ours["tumor_fraction"] == pytest.approx(float((p >= 0.5).mean()))


def test_cli_overlay_artifact_and_threshold(cli_run):
    art = str(cli_run / "m.pdacpt")
    cli_export.main(["--config", str(cli_run / "cfg.yaml"), "--pth_path",
                     str(cli_run / "pth" / "best.pth"), "--out", art])
    base = ["--config", str(cli_run / "cfg.yaml"), "--device", "cpu"]
    by_pth = cli_overlay.main(base + [
        "--pth_path", str(cli_run / "pth"),
        "--save_path", str(cli_run / "a_pth")])
    by_art = cli_overlay.main(base + [
        "--artifact", art, "--threshold", "0.3",
        "--save_path", str(cli_run / "a_art")])
    p = np.load(cli_run / "a_pth" / "probability_map.npy")
    np.testing.assert_array_equal(
        np.load(cli_run / "a_art" / "probability_map.npy"), p)
    assert by_pth["tumor_fraction"] == pytest.approx(float((p >= 0.5).mean()))
    assert by_art["tumor_fraction"] == pytest.approx(float((p >= 0.3).mean()))
    assert by_art["threshold"] == 0.3


def test_cli_overlay_threshold_auto_calibrates_on_val(cli_run, tmp_path,
                                                     capsys):
    """``--threshold auto`` takes the port ``Evaluator``'s Dice-optimal
    threshold on the config's val split and re-derives the mask."""
    from pdac_pathological_image_segmentation_tpu.data.synthetic import (
        generate_synthetic_patches,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
        discover_split,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
        PatchDataset,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        Evaluator,
    )

    generate_synthetic_patches(str(tmp_path / "val"), n=4, size=TILE, seed=3)
    raw = yaml.safe_load((cli_run / "cfg.yaml").read_text())
    raw["val_path"] = str(tmp_path / "val")
    cfg_path = tmp_path / "auto.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    out = cli_overlay.main(["--config", str(cfg_path), "--device", "cpu",
                            "--save_path", str(tmp_path / "o"), "--pth_path",
                            str(cli_run / "pth"), "--threshold", "auto"])
    cfg = Config.from_dict(raw)
    want = Evaluator(cfg, str(cli_run / "pth"), device="cpu").run(
        PatchDataset(*discover_split(cfg.val_path), cfg), verbose=False)
    assert out["threshold"] == want["best_threshold"]
    assert "calibrated threshold" in capsys.readouterr().out
    p = np.load(tmp_path / "o" / "probability_map.npy")
    assert out["tumor_fraction"] == pytest.approx(
        float((p >= out["threshold"]).mean()))


@pytest.mark.parametrize("extra", [
    [], ["--slide", "SLIDE", "--stride", "16", "--banded", "--band_h", "40",
         "--tta"]])
def test_cli_overlay_int8_matches_jax(cli_run, extra):
    """``--int8`` (calibrated on the first tissue tiles) against the JAX
    ``cli.overlay.main --int8`` on the same ``best.pth``: masks ≥ 99%
    equal, probabilities within 0.02 (the JAX path is jitted: its FMAs and
    reciprocal multiplies move int8 roundings, ``test_torch_quantized.py``),
    the tumor fractions within 1%."""
    extra = [str(cli_run / "slide.tiff") if a == "SLIDE" else a
             for a in extra]
    ours, ref, out, jout = _both(cli_run, "int8" + str(len(extra)),
                                 ["--int8"] + extra)
    p = np.load(out / "probability_map.npy").astype(np.float32)
    jp = np.load(jout / "probability_map.npy").astype(np.float32)
    assert p.shape == jp.shape and ours["n_tiles"] == ref["n_tiles"]
    np.testing.assert_allclose(p, jp, rtol=0, atol=2e-2)
    assert np.mean((p >= 0.5) == (jp >= 0.5)) >= 0.99
    assert abs(ours["tumor_fraction"] - ref["tumor_fraction"]) < 0.01
    plain = cli_overlay.main(["--config", str(cli_run / "cfg.yaml"),
                              "--pth_path", str(cli_run / "pth"), "--device",
                              "cpu", "--save_path",
                              str(cli_run / f"f32_{len(extra)}")] + extra)
    assert plain["n_tiles"] == ours["n_tiles"]


def test_cli_overlay_int8_refusals(cli_run, tmp_path):
    base = ["--config", str(cli_run / "cfg.yaml"), "--device", "cpu",
            "--save_path", str(tmp_path / "o"), "--int8"]
    with pytest.raises(SystemExit, match="artifact"):
        cli_overlay.main(base + ["--artifact", str(tmp_path / "a.pdacpt")])
    # a PyHIST selection that keeps no tile
    tsv = tmp_path / "none_kept.tsv"
    rows = (cli_run / "tile_selection.tsv").read_text().splitlines()
    tsv.write_text("\n".join([rows[0]] + [r.rsplit("\t", 1)[0] + "\t0"
                                           for r in rows[1:]]) + "\n")
    for key, value, match in (("model", "unet++", "supports models"),
                              ("backbone", "resnet34", "resnet18"),
                              ("tsv_path", str(tsv), "tissue filter")):
        raw = yaml.safe_load((cli_run / "cfg.yaml").read_text())
        raw[key] = value
        cfg = tmp_path / f"{key}.yaml"
        cfg.write_text(yaml.safe_dump(raw))
        pth = cli_run / "pth"
        if key != "tsv_path":
            model = build_model(Config.from_dict(raw))
            pth = tmp_path / f"{key}.pth"
            torch.save({"model": model.state_dict()}, pth)
        with pytest.raises(SystemExit, match=match):
            cli_overlay.main(["--config", str(cfg), "--device", "cpu",
                              "--save_path", str(tmp_path / key),
                              "--pth_path", str(pth), "--int8"])


@pytest.mark.parametrize("flags", [
    ["--uncertainty"], [], ["--threshold", "1.5"]])
def test_cli_overlay_refusals(cli_run, flags):
    argv = ["--config", str(cli_run / "cfg.yaml"), "--device", "cpu",
            "--save_path", str(cli_run / "r")] + flags
    if flags:
        argv += ["--pth_path", str(cli_run / "pth")]
    with pytest.raises(SystemExit):
        cli_overlay.main(argv)


def test_cli_overlay_multiclass_refusals(cli_run, tmp_path):
    raw = yaml.safe_load((cli_run / "cfg.yaml").read_text())
    raw["num_classes"] = 3
    cfg = tmp_path / "mc.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    for flags in (["--banded"], ["--export_tiff"], ["--threshold", "0.4"]):
        with pytest.raises(SystemExit):
            cli_overlay.main(["--config", str(cfg), "--device", "cpu",
                              "--save_path", str(tmp_path / "o"),
                              "--pth_path", str(cli_run / "pth")] + flags)

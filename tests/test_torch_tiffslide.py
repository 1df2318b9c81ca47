"""The PyTorch port's TIFF writer and its own binding of the native reader
(``native/tiffreader.cpp`` + ``native/jpegdec.cpp``, built into
``build/native/``) against the JAX package's:

* ``write_tiff`` / ``write_probability_tiff`` files byte-identical to the
  JAX writer's (classic and BigTIFF, none/deflate, predictor, pyramid,
  description);
* the port's ``TiffSlide`` reads PIL-written strip/LZW/deflate/JPEG files
  and the writer's pyramids bit-identically to the JAX ``TiffSlide``
  (regions, tiles, levels, metadata), including the per-tile PIL path for
  JPEG streams outside the native decoder's scope;
* ``TiffSlideSource`` gives the JAX source's windows and coordinates, with
  and without the thumbnail tissue filter;
* the library is built under ``build/native/`` with a hash-keyed name.
"""

import numpy as np
import pytest
from PIL import Image

from pdac_pathological_image_segmentation_tpu.data import (
    tiffslide as jax_ts,
    tiffwriter as jax_tw,
)
from pdac_pathological_image_segmentation_tpu_torch.data import (
    tiffslide as ts,
    tiffwriter as tw,
)


@pytest.fixture(scope="module")
def rgb():
    return np.random.default_rng(0).integers(0, 256, (300, 420, 3),
                                             dtype=np.uint8)


@pytest.mark.parametrize("kw", [
    dict(compression="deflate", pyramid=True, min_size=64),
    dict(compression="none", pyramid=False),
    dict(compression="deflate", predictor=True, pyramid=True, min_size=100),
    dict(compression="deflate", big=True, pyramid=True, min_size=64,
         description="Aperio |MPP = 0.2498|"),
    dict(compression="none", big=True, pyramid=False, tile=128),
])
def test_write_tiff_bytes_equal_jax(tmp_path, rgb, kw):
    for img in (rgb, rgb[..., 1]):
        levels = tw.write_tiff(str(tmp_path / "p.tiff"), img, **kw)
        jlevels = jax_tw.write_tiff(str(tmp_path / "j.tiff"), img, **kw)
        assert levels == jlevels
        assert (tmp_path / "p.tiff").read_bytes() == \
            (tmp_path / "j.tiff").read_bytes()


def test_write_probability_tiff_bytes_equal_jax(tmp_path):
    p = np.random.default_rng(1).random((130, 170)).astype(np.float32)
    for thr in (None, 0.5):
        tw.write_probability_tiff(str(tmp_path / "p.tiff"), p, threshold=thr)
        jax_tw.write_probability_tiff(str(tmp_path / "j.tiff"), p,
                                      threshold=thr)
        assert (tmp_path / "p.tiff").read_bytes() == \
            (tmp_path / "j.tiff").read_bytes()
    with pytest.raises(ValueError):
        tw.write_tiff(str(tmp_path / "x.tiff"), p)


def _regions(w, h):
    return [(0, 0, w, h), (37, 11, 150, 90), (w - 40, h - 30, 100, 80),
            (-20, -10, 64, 64)]


def _assert_same_slide(path):
    with ts.TiffSlide(path) as s, jax_ts.TiffSlide(path) as j:
        assert s.level_info == j.level_info
        assert s.description == j.description and s.mpp == j.mpp
        for lv in range(s.level_count):
            w, h = s.dimensions(lv)
            assert (w, h) == j.dimensions(lv)
            for r in _regions(w, h):
                np.testing.assert_array_equal(s.read_region(lv, *r),
                                              j.read_region(lv, *r))
            info = s.level_info[lv]
            for tx, ty in ((0, 0), (info["tiles_x"] - 1,
                                    info["tiles_y"] - 1)):
                np.testing.assert_array_equal(s.read_tile(lv, tx, ty),
                                              j.read_tile(lv, tx, ty))
        for ds in (1.0, 2.5, 100.0):
            assert s.level_for_downsample(ds) == j.level_for_downsample(ds)


@pytest.mark.parametrize("kw", [
    dict(compression="deflate", tile=128, min_size=64),
    dict(compression="none", tile=64, big=True, min_size=64,
         description="Aperio |MPP = 0.5|"),
    dict(compression="deflate", predictor=True, tile=256, pyramid=False),
])
def test_reads_writer_pyramids_like_jax(tmp_path, rgb, kw):
    path = str(tmp_path / "w.tiff")
    tw.write_tiff(path, rgb, **kw)
    _assert_same_slide(path)
    with ts.TiffSlide(path) as s:
        np.testing.assert_array_equal(
            s.read_region(0, 0, 0, 420, 300), rgb)


@pytest.mark.parametrize("comp", ["tiff_lzw", "tiff_adobe_deflate", "raw",
                                  "jpeg"])
def test_reads_pil_written_files_like_jax(tmp_path, comp):
    yy, xx = np.mgrid[0:230, 0:310]
    img = np.stack([(yy + xx) % 256, yy % 256, (3 * xx) % 256],
                   -1).astype(np.uint8)
    path = str(tmp_path / f"{comp}.tiff")
    Image.fromarray(img).save(path, compression=comp)
    _assert_same_slide(path)
    with ts.TiffSlide(path) as s:
        r = s.read_region(0, 0, 0, 310, 230)
    if comp == "jpeg":
        assert np.abs(r.astype(np.int16) - img).mean() < 1.5
    else:
        np.testing.assert_array_equal(r, img)


class _ForceFallbackLib:
    """The native library, but every tile and region read reports a JPEG
    stream outside the decoder's scope: all reads go through PIL."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def tiff_read_tile(self, *a):
        return 6

    def tiff_read_region(self, *a):
        return 6


def test_pil_tile_path_equals_jax(tmp_path, rgb):
    path = str(tmp_path / "pf.tiff")
    Image.fromarray(rgb).save(path, compression="jpeg", quality=95)
    with ts.TiffSlide(path) as s, jax_ts.TiffSlide(path) as j:
        s._lib = _ForceFallbackLib(s._lib)
        j._lib = _ForceFallbackLib(j._lib)
        for r in _regions(420, 300):
            np.testing.assert_array_equal(s.read_region(0, *r),
                                          j.read_region(0, *r))
        t = s.read_tile(0, 0, 0)
        assert t.flags.writeable
        t[...] = 0  # the cached master is untouched
        np.testing.assert_array_equal(s.read_tile(0, 0, 0),
                                      j.read_tile(0, 0, 0))


@pytest.mark.parametrize("level,stride,thresh", [
    (0, None, 0.0), (0, 96, 0.0), (1, 64, 0.0), (0, 128, 0.3)])
def test_tile_source_equals_jax(tmp_path, rgb, level, stride, thresh):
    img = rgb.copy()
    img[:, :200] = 244  # background glass for the tissue filter
    path = str(tmp_path / "s.tiff")
    tw.write_tiff(path, img, tile=64, min_size=64)
    with ts.TiffSlide(path) as s, jax_ts.TiffSlide(path) as j:
        src = ts.TiffSlideSource(s, level=level, tile=128, stride=stride,
                                 tissue_threshold=thresh, thumb_max=128)
        ref = jax_ts.TiffSlideSource(j, level=level, tile=128, stride=stride,
                                     tissue_threshold=thresh, thumb_max=128)
        assert src.coords == ref.coords and src.skipped == ref.skipped
        assert src.canvas_hw == ref.canvas_hw and src.orig_hw == ref.orig_hw
        assert (src.skipped > 0) == (thresh > 0)
        for i in (0, len(src) - 1):
            a, yx = src.get(i)
            np.testing.assert_array_equal(a, ref.get(i)[0])
            assert yx == ref.get(i)[1]
        np.testing.assert_array_equal(src.read_region(10, 20, 140, 90),
                                      ref.read_region(10, 20, 140, 90))


def test_library_is_built_under_build_native():
    path = ts.build()
    assert path.parent == ts.BUILD_DIR and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libtiffreader-") and path.exists()
    assert ts.library_path() == path
    with pytest.raises(IOError):
        ts.TiffSlide(str(ts.BUILD_DIR / "no-such-slide.tiff"))

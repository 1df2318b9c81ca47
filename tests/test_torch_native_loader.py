"""The port's native PNG decoder (``data/native_loader.py``) and the loader
that reads through it (``data/loader.py``), on the CPU:

* the library is built under ``build/native/`` (``data/native_build.py``)
  with a name hashed from the source and the command; a failing build
  raises with the compiler's message (a compiler that does not exist, a
  flag g++ refuses), in a fresh build directory;
* ``png_info``; ``decode_batch`` bitwise equal to PIL and to the JAX
  package's ``decode_batch`` on RGB, gray, RGBA and palette PNGs and on
  every PNG filter type (files assembled with a forced filter per row), and
  into a caller's ``out=`` buffer;
* a 16-bit PNG takes the counted PIL path and decodes as the JAX function
  decodes it; a missing, truncated or non-PNG file raises, as does a PNG
  of another size than asked;
* ``PatchLoader`` takes the native path when the first image and mask
  agree (as the JAX loader decides), and its batches, wrap-padding
  included, equal the PIL path's bitwise; a dataset whose pairs differ in
  size is decoded by PIL.
"""

import hashlib
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.data import (
    native_loader as jax_native_loader,
)
from pdac_pathological_image_segmentation_tpu.data.loader import (
    PatchDataset as JaxPatchDataset,
    PatchLoader as JaxPatchLoader,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.data import (
    native_build,
    native_loader,
)
from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
    discover_split,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
    PatchLoader,
)
from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    generate_synthetic_patches,
)


def _write_png(path, arr, filters, color_type, depth=8):
    """A PNG assembled by hand with a forced filter per row (PIL's encoder
    picks its own, so some unfilter paths would go untested)."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    nbytes = depth // 8
    if depth == 16:
        rows = np.frombuffer(arr.astype(">u2").tobytes(), np.uint8)
    else:
        rows = arr.astype(np.uint8).reshape(-1)
    rows = rows.reshape(h, w * c * nbytes).astype(np.int32)
    bpp = c * nbytes
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        row = rows[y]
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            filt = row
        elif ft == 1:
            filt = row - left
        elif ft == 2:
            filt = row - prev
        elif ft == 3:
            filt = row - ((left + prev) >> 1)
        else:  # Paeth
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
            filt = row - pred
        raw.append(ft)
        raw.extend((filt % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body)))

    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                     0, 0, 0))
        + chunk(b"IDAT", zlib.compress(bytes(raw)))
        + chunk(b"IEND", b""))


def _both(paths, h, w, c, threads=2):
    """The port's and the JAX decode of ``paths``, with the port's PIL
    count before and after."""
    before = native_loader.decode_batch.pil_decodes
    ours = native_loader.decode_batch(paths, h, w, c, threads=threads)
    counted = native_loader.decode_batch.pil_decodes - before
    ref = jax_native_loader.decode_batch(paths, h, w, c, threads=threads)
    return ours, ref, counted


# -- the library ---------------------------------------------------------------

def test_library_is_built_under_build_native_from_its_hash():
    path = native_loader.build()
    assert path.parent == native_build.BUILD_DIR
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    digest = hashlib.sha256(
        (native_build.NATIVE_DIR / "pngloader.cpp").read_bytes()
        + b"g++ -O3 -std=c++17 -fPIC -shared -lz -lpthread").hexdigest()[:16]
    assert path.name == f"libpngloader-{digest}.so" and path.exists()
    assert native_loader.library_path() == path
    assert native_loader.build() == path  # built once


@pytest.mark.parametrize("cmd,match", [
    (("no-such-g++", "-O3", "-std=c++17", "-fPIC", "-shared"), "no-such-g"),
    (("g++", "--no-such-flag-for-the-test", "-fPIC", "-shared"),
     "no-such-flag-for-the-test"),
])
def test_failing_build_raises_with_the_compilers_message(monkeypatch,
                                                         tmp_path, cmd,
                                                         match):
    build_dir = tmp_path / "fresh"
    monkeypatch.setattr(native_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native_build, "BUILD_CMD", cmd)
    with pytest.raises(RuntimeError, match=match) as err:
        native_loader.build()
    assert "native PNG decoder failed" in str(err.value)
    assert not any(build_dir.glob("*.so"))


# -- decode_batch ----------------------------------------------------------------

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    arrays = {"rgb": rng.integers(0, 256, (40, 56, 3), dtype=np.uint8),
              "gray": rng.integers(0, 256, (40, 56), dtype=np.uint8),
              "rgba": rng.integers(0, 256, (40, 56, 4), dtype=np.uint8),
              "mask": rng.integers(0, 3, (40, 56), dtype=np.uint8)}
    for name, arr in arrays.items():
        Image.fromarray(arr).save(d / f"{name}.png")
    Image.fromarray(arrays["mask"] * 100).convert("P").save(d / "pal.png")
    return d, arrays


def test_png_info(pngs):
    d, _ = pngs
    assert native_loader.png_info(str(d / "rgb.png")) == (40, 56)
    assert native_loader.png_info(str(d / "rgb.png")) \
        == jax_native_loader.png_info(str(d / "rgb.png"))
    assert native_loader.png_info(str(d / "no-such.png")) is None
    (d / "not_png.png").write_bytes(b"GIF89a" + bytes(40))
    assert native_loader.png_info(str(d / "not_png.png")) is None


@pytest.mark.parametrize("name,channels", [
    ("rgb", 3), ("gray", 3), ("gray", 1), ("rgba", 3), ("rgba", 1),
    ("pal", 3), ("pal", 1), ("mask", 1), ("rgb", 1)])
def test_decode_equals_pil_and_jax(pngs, name, channels):
    d, _ = pngs
    paths = [str(d / f"{name}.png")] * 3
    ours, ref, counted = _both(paths, 40, 56, channels)
    assert counted == 0  # all in the native decoder's scope
    assert ours.shape == (3, 40, 56, channels) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    img = Image.open(paths[0])
    pil = np.asarray(img.convert("RGB") if channels == 3 else img)
    if channels == 1:
        pil = (pil[..., 0] if pil.ndim == 3 else pil)[..., None]
    for k in range(3):
        np.testing.assert_array_equal(ours[k], pil)


def test_decode_into_out_and_its_checks(pngs):
    d, arrays = pngs
    out = np.full((2, 40, 56, 3), 7, np.uint8)
    got = native_loader.decode_batch([str(d / "rgb.png"), str(d / "rgba.png")],
                                     40, 56, 3, threads=1, out=out)
    assert got is out
    np.testing.assert_array_equal(out[0], arrays["rgb"])
    np.testing.assert_array_equal(out[1], arrays["rgba"][..., :3])
    with pytest.raises(ValueError, match="out must be"):
        native_loader.decode_batch([str(d / "rgb.png")], 40, 56, 3, out=out)
    with pytest.raises(ValueError, match="out must be"):
        native_loader.decode_batch([str(d / "rgb.png")] * 2, 40, 56, 3,
                                   out=np.empty((2, 40, 56, 3), np.uint8)
                                   [:, ::-1])
    assert native_loader.decode_batch([], 40, 56, 3).shape == (0, 40, 56, 3)


@pytest.mark.parametrize("shape,color_type", [
    ((67, 61, 3), 2),   # RGB, odd width: the vector loops' tails
    ((64, 64, 4), 6),   # RGBA
    ((33, 49), 0),      # gray
])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4]])
def test_every_filter_type_equals_pil_and_jax(tmp_path, shape, color_type,
                                              filters):
    rng = np.random.default_rng(sum(shape) * 10 + len(filters) + filters[0])
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "f.png"
    _write_png(path, arr, filters, color_type)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    h, w = shape[:2]
    c = 1 if len(shape) == 2 else 3
    ours, ref, counted = _both([str(path)], h, w, c, threads=1)
    assert counted == 0
    np.testing.assert_array_equal(ours, ref)
    want = arr[..., None] if c == 1 else arr[..., :3]
    np.testing.assert_array_equal(ours[0], want)


@pytest.mark.parametrize("color_type,channels", [(2, 3), (0, 1), (0, 3)])
def test_16_bit_png_takes_the_counted_pil_path(tmp_path, color_type,
                                               channels):
    rng = np.random.default_rng(16)
    shape = (24, 20, 3) if color_type == 2 else (24, 20)
    arr = rng.integers(0, 65536, shape, dtype=np.uint16)
    path = tmp_path / "deep.png"
    _write_png(path, arr, [0, 4], color_type, depth=16)
    paths = [str(path), str(path)]
    ours, ref, counted = _both(paths, 24, 20, channels)
    assert counted == 2
    np.testing.assert_array_equal(ours, ref)


def test_unreadable_files_raise(tmp_path, pngs):
    d, _ = pngs
    arr = np.zeros((16, 16, 3), np.uint8)
    _write_png(tmp_path / "ok.png", arr, [4], 2)
    data = (tmp_path / "ok.png").read_bytes()
    (tmp_path / "trunc.png").write_bytes(data[:-24])
    (tmp_path / "jpeg.png").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    before = native_loader.decode_batch.pil_decodes
    for name, match in (("no-such.png", "open failed"),
                        ("trunc.png", "corrupt|inflate"),
                        ("jpeg.png", "not a PNG")):
        with pytest.raises(IOError, match=match):
            native_loader.decode_batch([str(tmp_path / "ok.png"),
                                        str(tmp_path / name)], 16, 16, 3)
        with pytest.raises(IOError):
            jax_native_loader.decode_batch([str(tmp_path / name)], 16, 16, 3)
    # a PNG of another size than asked raises without a PIL decode
    with pytest.raises(IOError, match="size mismatch"):
        native_loader.decode_batch([str(d / "rgb.png")], 16, 16, 3)
    assert native_loader.decode_batch.pil_decodes == before
    with pytest.raises(IOError):
        jax_native_loader.decode_batch([str(d / "rgb.png")], 16, 16, 3)


# -- the loader ------------------------------------------------------------------

def _batches(loader, epoch):
    return [tuple(t.numpy().copy() for t in b) for b in loader.epoch(epoch)]


@pytest.mark.parametrize("shuffle", [False, True])
def test_patch_loader_native_equals_pil_bitwise(tmp_path, shuffle):
    generate_synthetic_patches(str(tmp_path), n=7, size=48, seed=4)
    cfg = Config.from_dict({"model": "fpn", "img_size": 48, "seed": 9})
    ds = PatchDataset(*discover_split(str(tmp_path)), cfg)
    loader = PatchLoader(ds, 3, shuffle=shuffle, device="cpu", num_workers=2)
    assert loader.native_hw == (48, 48)
    jds = JaxPatchDataset(*discover_split(str(tmp_path)),
                          JaxConfig.from_dict({"model": "fpn",
                                               "img_size": 48, "seed": 9}))
    assert JaxPatchLoader(jds, 3, shuffle=shuffle,
                          num_workers=2)._native_hw == loader.native_hw
    pil = PatchLoader(ds, 3, shuffle=shuffle, device="cpu", num_workers=2)
    pil.native_hw = None
    before = native_loader.decode_batch.pil_decodes
    for epoch in (0, 1):
        got, want = _batches(loader, epoch), _batches(pil, epoch)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert [a.shape for a in g] == [a.shape for a in w]
            assert [a.dtype for a in g] == [a.dtype for a in w]
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        # the last batch: one sample and two wrap-padded from the start
        assert got[-1][2].tolist() == [True, False, False]
        np.testing.assert_array_equal(got[-1][0][1:], got[0][0][:2])
    assert native_loader.decode_batch.pil_decodes == before


def test_patch_loader_pairs_of_another_size_take_pil(tmp_path):
    generate_synthetic_patches(str(tmp_path), n=2, size=32, seed=1)
    imgs, masks = discover_split(str(tmp_path))
    for m in masks:  # masks stored at twice the image's size
        a = np.asarray(Image.open(m))
        Image.fromarray(np.kron(a, np.ones((2, 2), np.uint8))).save(m)
    ds = PatchDataset(imgs, masks, Config(model="fpn", img_size=32))
    loader = PatchLoader(ds, 2, shuffle=False, device="cpu", num_workers=1)
    assert loader.native_hw is None
    (batch,) = list(loader.epoch(0))
    assert tuple(batch.image.shape) == (2, 32, 32, 3)
    assert tuple(batch.mask.shape) == (2, 64, 64)
    assert batch.image.dtype == batch.mask.dtype == torch.uint8

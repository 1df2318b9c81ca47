"""The port's ``cli.extract`` (the headless QuPath patch exporter) against
the JAX package's, on one pyramidal TIFF written by ``data/tiffwriter.py``
with an Aperio description (MPP 0.25) and one QuPath GeoJSON: the same
returned dict, file names and pixels at downsample 1, at downsample 2 (the
pyramid's level 1 exactly), at a downsample that resizes, with
``--overlap``, ``--annotated_only``, label-order overwrite, an unlabeled
annotation skipped or labelled by ``--default_label``, and
``--include_partial``; each refusal raises on both sides; the extracted
pairs load through the port's ``PatchLoader`` on its native path."""

import os

import numpy as np
import pytest
from PIL import Image

from pdac_pathological_image_segmentation_tpu.cli import extract as jax_extract
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.cli import extract
from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
    discover_split,
)
from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
    parse_geojson,
    rasterize_shapes,
    write_geojson,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
    PatchLoader,
)
from pdac_pathological_image_segmentation_tpu_torch.data.tiffslide import (
    TiffSlide,
)
from pdac_pathological_image_segmentation_tpu_torch.data.tiffwriter import (
    write_tiff,
)

_DESC = ("Aperio Image Library v12.0.15\r\n"
         "512x512 [0,0 512x512] (240x240) JPEG/RGB Q=30"
         "|AppMag = 20|MPP = 0.25")


def _feature(ring, name=None):
    props = {"objectType": "annotation"}
    if name is not None:
        props["classification"] = {"name": name, "color": [200, 0, 0]}
    return {"type": "Feature",
            "geometry": {"type": "Polygon", "coordinates": ring},
            "properties": props}


def _rect(x0, y0, x1, y1):
    return [[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]]


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    d = tmp_path_factory.mktemp("extract")
    rng = np.random.default_rng(7)
    # smooth content plus noise: the resize path's bilinear filter matters
    yy, xx = np.mgrid[0:480, 0:512]
    img = np.stack([128 + 90 * np.sin(xx / 23.0), 128 + 90 * np.cos(yy / 17.0),
                    128 + 60 * np.sin((xx + yy) / 31.0)], -1)
    img = (img + rng.normal(0, 10, img.shape)).clip(0, 255).astype(np.uint8)
    path = str(d / "case01.svs.tiff")
    # levels 512x480, 256x240, 128x120: downsample 2 is level 1 exactly
    write_tiff(path, img, tile=128, min_size=128, description=_DESC)
    gj = str(d / "case01.geojson")
    write_geojson(gj, {"type": "FeatureCollection", "features": [
        # a tumor ring with a hole, a stroma square over part of it, an
        # unclassified triangle
        _feature([_rect(100, 80, 300, 220), _rect(150, 120, 200, 160)],
                 "Tumor"),
        _feature([_rect(250, 180, 400, 330)], "Stroma"),
        _feature([[[20, 300], [90, 300], [40, 420], [20, 300]]]),
    ]})
    return path, gj, img


def _run_both(tmp_path, argv):
    """The port's and the JAX CLI's results and output directories."""
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    res = extract.main(argv + ["--out", ours])
    jres = jax_extract.main(argv + ["--out", ref])
    assert {k: v for k, v in res.items() if k != "out"} \
        == {k: v for k, v in jres.items() if k != "out"}
    assert res["out"] == ours
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names
    assert len(names) == 2 * res["written"]
    for name in names:
        a = np.asarray(Image.open(os.path.join(ours, name)))
        b = np.asarray(Image.open(os.path.join(ref, name)))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    return res, ours


def _masks(out):
    _, masks = discover_split(out)
    return {os.path.basename(p): np.asarray(Image.open(p)) for p in masks}


@pytest.mark.parametrize("case,args,written,level", [
    # 512x480 at tile 64: 8 x 7 tiles
    ("downsample 1", ["--downsample", "1"], 56, 0),
    # pixel_size 0.5 / MPP 0.25: 256x240, 4 x 3 tiles from level 1
    ("mpp", [], 12, 1),
    # 3: level 1 read at 96², resized to 64²; 170x160 -> 2 x 2 tiles
    ("resize", ["--downsample", "3"], 4, 1),
    ("slide_mpp resize", ["--slide_mpp", "0.2", "--pixel_size", "0.5"], 9,
     1),
    # step 40 over 256x240: 5 x 5
    ("overlap", ["--overlap", "24"], 25, 1),
    ("annotated_only", ["--annotated_only"], 6, 1),
    ("label order", ["--label", "Tumor=1", "--label", "Stroma=2"], 12, 1),
    ("label order reversed", ["--label", "Stroma=2", "--label", "Tumor=1"],
     12, 1),
    ("default_label", ["--default_label", "3"], 12, 1),
    # 8 x 8 with the zero-padded bottom row
    ("include_partial", ["--downsample", "1", "--include_partial"], 64, 0),
])
def test_extract_equals_jax(slide, tmp_path, case, args, written, level):
    path, gj, _ = slide
    res, out = _run_both(tmp_path, ["--slide", path, "--annotations", gj,
                                    "--tile", "64", "--workers", "2",
                                    "--name", "case01", *args])
    assert res["written"] == written and res["level"] == level, case
    labels = set()
    for m in _masks(out).values():
        labels |= set(np.unique(m).tolist())
    if case == "default_label":
        assert 3 in labels  # the unclassified triangle, labelled
    else:
        assert 3 not in labels
    if case.startswith("label order"):
        assert labels == {0, 1, 2}
    if case == "annotated_only":
        assert all(m.any() for m in _masks(out).values())


def test_extract_tiles_hold_the_slide_and_the_shapes(slide, tmp_path):
    """At downsample 1 every image tile is ``read_region`` of its window
    and every label tile ``rasterize_shapes`` of the same shapes there; the
    unlabeled triangle is skipped without ``--default_label``."""
    path, gj, img = slide
    res, out = _run_both(tmp_path, ["--slide", path, "--annotations", gj,
                                    "--tile", "64", "--workers", "2",
                                    "--downsample", "1", "--name", "c"])
    shapes = parse_geojson(gj, label_map={"Tumor": 1}, default_label=None)
    assert len(shapes) == 1
    imgs, masks = discover_split(out)
    with TiffSlide(path) as s:
        for ip, mp in zip(imgs, masks):
            x, y = (int(os.path.basename(ip).split(f"{k}=")[1].split(",")[0])
                    for k in ("x", "y"))
            assert f"c [d=1,x={x},y={y},w=64,h=64]" in ip
            np.testing.assert_array_equal(np.asarray(Image.open(ip)),
                                          s.read_region(0, x, y, 64, 64))
            np.testing.assert_array_equal(np.asarray(Image.open(ip)),
                                          img[y:y + 64, x:x + 64])
            np.testing.assert_array_equal(
                np.asarray(Image.open(mp)),
                rasterize_shapes(shapes, 64, 64, offset=(x, y)))


@pytest.mark.parametrize("argv,match", [
    (["--tile", "64"], "MPP"),  # no MPP in the file, no --downsample
    (["--downsample", "0.5"], "upsample"),
    (["--downsample", "1", "--overlap", "64", "--tile", "64"], "overlap"),
    (["--downsample", "1", "--label", "Tumor"], "Name=value"),
    (["--downsample", "1", "--label", "Tumor=x"], "integer"),
    (["--downsample", "1", "--annotated_only", "--label", "Necrosis=1"],
     "no annotations matched"),
])
def test_refusals_raise_on_both_sides(slide, tmp_path, argv, match):
    path, gj, img = slide
    bare = str(tmp_path / "nompp.tiff")
    write_tiff(bare, img, tile=128, pyramid=False)
    full = ["--slide", bare, "--annotations", gj, *argv]
    for main in (extract.main, jax_extract.main):
        with pytest.raises(SystemExit, match=match):
            main(full + ["--out", str(tmp_path / "o")])


def test_extracted_pairs_load_through_the_native_loader(slide, tmp_path):
    path, gj, _ = slide
    out = str(tmp_path / "patches")
    extract.main(["--slide", path, "--annotations", gj, "--out", out,
                  "--tile", "64", "--workers", "2"])
    ds = PatchDataset(*discover_split(out), Config(model="fpn", img_size=64))
    assert len(ds) == 12
    loader = PatchLoader(ds, 5, shuffle=False, device="cpu", num_workers=2)
    assert loader.native_hw == (64, 64)
    seen = 0
    for batch in loader.epoch(0):
        for k in range(int(batch.valid.sum())):
            image, mask = ds[seen + k]
            np.testing.assert_array_equal(batch.image[k].numpy(), image)
            np.testing.assert_array_equal(batch.mask[k].numpy(), mask)
        seen += int(batch.valid.sum())
    assert seen == 12

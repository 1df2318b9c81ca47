"""The PyTorch port's copy of ``data/geojson.py`` against the JAX package's,
on seeded random masks: ``mask_to_polygons`` (with area filter, simplify,
scale and offset), ``clean_mask``, ``parse_geojson`` and
``rasterize_shapes`` give equal output; the round trip
``rasterize_shapes(mask_to_polygons(m)) == m`` is exact; the daemon's
``Accept: application/geo+json`` response is tested in
``tests/test_torch_serve.py``.
"""

import json

import numpy as np
import pytest

from pdac_pathological_image_segmentation_tpu.data import geojson as jax_gj
from pdac_pathological_image_segmentation_tpu_torch.data import geojson as gj


def _blobby(seed, shape=(48, 64), fill=0.5):
    rng = np.random.default_rng(seed)
    noise = rng.random(shape)
    sm = np.zeros_like(noise)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            sm += np.roll(np.roll(noise, dy, 0), dx, 1) / 25.0
    return (sm > np.quantile(sm, 1.0 - fill)).astype(np.uint8)


def _masks():
    rng = np.random.default_rng(9)
    donut = np.zeros((12, 12), np.uint8)
    donut[2:10, 2:10] = 1
    donut[4:8, 4:8] = 0
    donut[5, 5] = 1  # an island in the hole
    return [_blobby(0), _blobby(1, fill=0.3), _blobby(2, (33, 17), 0.7),
            (rng.random((20, 24)) < 0.5).astype(np.uint8), donut,
            np.zeros((8, 8), np.uint8), np.ones((8, 8), np.uint8)]


def _same_polygons(got, want):
    assert len(got) == len(want)
    for (e, hs), (je, jhs) in zip(got, want):
        np.testing.assert_array_equal(e, je)
        assert len(hs) == len(jhs)
        for h, jh in zip(hs, jhs):
            np.testing.assert_array_equal(h, jh)


@pytest.mark.parametrize("kw", [
    {}, {"min_area": 6.0}, {"simplify_tol": 1.5},
    {"scale": 2.5, "offset": (100.0, -7.0)},
])
@pytest.mark.parametrize("index", range(7))
def test_mask_to_polygons_equals_jax(index, kw):
    m = _masks()[index]
    _same_polygons(gj.mask_to_polygons(m, **kw),
                   jax_gj.mask_to_polygons(m, **kw))


@pytest.mark.parametrize("index", range(5))
def test_round_trip_exact(index):
    m = _masks()[index]
    shapes = [(1, [e] + hs) for e, hs in gj.mask_to_polygons(m)]
    np.testing.assert_array_equal(gj.rasterize_shapes(shapes, *m.shape), m)


@pytest.mark.parametrize("kw", [
    {"min_area": 10.0}, {"fill_holes_area": 20.0},
    {"min_area": 4.0, "fill_holes_area": float("inf")}, {},
])
@pytest.mark.parametrize("index", [0, 1, 3, 4])
def test_clean_mask_equals_jax(index, kw):
    m = _masks()[index]
    got = gj.clean_mask(m, **kw)
    want = jax_gj.clean_mask(m, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_b = gj.clean_mask(m.astype(bool), **kw)
    assert got_b.dtype == bool
    np.testing.assert_array_equal(got_b, want.astype(bool))


def _collection():
    a = gj.polygons_to_geojson(gj.mask_to_polygons(_blobby(3)),
                               class_name="Tumor")
    b = gj.polygons_to_geojson(gj.mask_to_polygons(_blobby(4, fill=0.2)),
                               class_name="Stroma")
    multi = {"type": "Feature", "properties": {},
             "geometry": {"type": "MultiPolygon", "coordinates": [
                 [[[0, 0], [5.5, 0], [5.5, 4.25], [0, 4.25]]],
                 [[[10, 10], [20, 10], [20, 20], [10, 20], [10, 10]],
                  [[12, 12], [14, 12], [14, 14], [12, 14], [12, 12]]]]}}
    point = {"type": "Feature", "properties": {},
             "geometry": {"type": "Point", "coordinates": [1, 1]}}
    return {"type": "FeatureCollection",
            "features": a["features"] + b["features"] + [multi, point]}


@pytest.mark.parametrize("label_map,default", [
    (None, 1), ({"Tumor": 1, "Stroma": 2}, 3), ({"Stroma": 5}, None)])
def test_parse_and_rasterize_equal_jax(tmp_path, label_map, default):
    fc = _collection()
    path = gj.write_geojson(str(tmp_path / "a.geojson"), fc)
    for obj in (fc, path, json.dumps(fc), fc["features"]):
        got = gj.parse_geojson(obj, label_map=label_map,
                               default_label=default)
        want = jax_gj.parse_geojson(obj, label_map=label_map,
                                    default_label=default)
        assert [s[0] for s in got] == [s[0] for s in want]
        for (_, rings), (_, jrings) in zip(got, want):
            for r, jr in zip(rings, jrings):
                np.testing.assert_array_equal(r, jr)
    for scale, offset in ((1.0, (0.0, 0.0)), (2.0, (3.0, 1.0)),
                          (0.75, (-2.0, 0.5))):
        np.testing.assert_array_equal(
            gj.rasterize_shapes(got, 40, 60, scale=scale, offset=offset),
            jax_gj.rasterize_shapes(want, 40, 60, scale=scale, offset=offset))
    with pytest.raises(ValueError, match="scale"):
        gj.rasterize_shapes(got, 4, 4, scale=0.0)


def test_geojson_schema_equals_jax():
    polys = gj.mask_to_polygons(_blobby(5))
    got = gj.polygons_to_geojson(polys, class_name="Tumor",
                                 measurements={"tumor_fraction": 0.25})
    want = jax_gj.polygons_to_geojson(polys, class_name="Tumor",
                                      measurements={"tumor_fraction": 0.25})
    for f in got["features"] + want["features"]:
        f.pop("id")  # a fresh uuid on each side
    assert got == want

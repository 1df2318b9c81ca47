"""The port's one-device multi-slide sweep (``infer/sweep.py``) against the
JAX ``run_sweep`` on the CPU, with carried weights (a seeded ResUNet and
FPN; the JAX side gets them through the ``convert_*_state_dict``
converters), 32² tiles and two non-square slides: probabilities within
``tests/test_torch_wsi.py``'s ``PROB_ATOL`` (5e-4) and masks as that
file's ``_assert_maps_close`` holds them, the records equal, the GeoJSON
polygons equal to the JAX ``mask_to_polygons`` of the same mask, the
``out_dir`` files, a tile source beside the numpy slides, and the sharded
sweep's refusals."""

import json
import os
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.data.geojson import (
    mask_to_polygons as jax_mask_to_polygons,
)
from pdac_pathological_image_segmentation_tpu.infer.sweep import (
    run_sweep as jax_run_sweep,
)
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_resunet_state_dict,
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
    parse_geojson,
    rasterize_shapes,
)
from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    SyntheticSlideSource,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.sweep import (
    run_sweep,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
    GridTiler,
    SlidingWindowInference,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)

TILE = 32
PROB_ATOL = 5e-4  # tests/test_torch_wsi.py's, tests/test_fpn_golden.py's bound
_State = namedtuple("_State", "params batch_stats")
CONVERT = {"unet": convert_resunet_state_dict,
           "fpn": convert_smp_fpn_state_dict}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """32² tiles: one intra-op thread is faster than many, and keeps this
    file's time steady when other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["unet", "fpn"])
def models(request):
    """(name, port model, JAX model, JAX state) from one seeded sd."""
    name = request.param
    cfg = Config(model=name, img_size=TILE, compute_dtype="float32")
    model = build_model(cfg)
    sd = seeded_state_dict(model, seed=21)
    model.load_state_dict(sd, strict=True)
    model.eval()
    jmodel = jax_build_model(JaxConfig(model=name, img_size=TILE,
                                       compute_dtype="float32"))
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, TILE, TILE, 3)), train=False)
    params, batch_stats = CONVERT[name](
        {k: v.numpy() for k, v in sd.items()}, variables["params"],
        variables["batch_stats"])
    return name, model, jmodel, _State(params, batch_stats)


def _slides():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (96, 64, 3), dtype=np.uint8),
            rng.integers(0, 256, (40, 112, 3), dtype=np.uint8)]


def _assert_maps_close(got, want):
    (p, m), (q, n) = got, want
    assert p.shape == q.shape and m.shape == n.shape
    assert p.dtype == q.dtype and m.dtype == n.dtype == np.uint8
    np.testing.assert_allclose(p.astype(np.float32), q.astype(np.float32),
                               rtol=0, atol=PROB_ATOL)
    assert (m == n).mean() >= 0.999


def _polygons(fc):
    return [f["geometry"]["coordinates"] for f in fc["features"]]


@pytest.mark.parametrize("stride", [None, 16])
def test_sweep_in_memory_matches_jax(models, stride):
    name, model, jmodel, state = models
    kw = dict(tile=TILE, stride=stride, batch_size=4, geojson=True)
    got = run_sweep(model, _slides(), device="cpu", **kw)
    want = jax_run_sweep(jmodel, state, _slides(), **kw)
    assert [r["slide"] for r in got] == [0, 1]
    for r, w in zip(got, want):
        assert r["n_tiles"] == w["n_tiles"]
        assert r["canvas_hw"] == w["canvas_hw"]
        assert r["seconds"] > 0
        _assert_maps_close((r["prob"], r["mask"]), (w["prob"], w["mask"]))
        assert r["tumor_fraction"] == pytest.approx(w["tumor_fraction"],
                                                    abs=1e-3)
        # the polygons: the JAX tracer's on the port's own mask
        want_fc = [[ring.tolist() for ring in (ext, *holes)]
                   for ext, holes in jax_mask_to_polygons(r["mask"])]
        assert _polygons(r["geojson"]) == want_fc
        assert r["n_regions"] == len(want_fc)
        assert r["geojson"]["type"] == "FeatureCollection"
    assert got[0]["canvas_hw"] == (96, 64) and got[1]["canvas_hw"] == (40, 112)
    # the sweep is the runner, slide by slide
    direct = SlidingWindowInference(model, tile=TILE, batch_size=4).run(
        GridTiler(_slides()[1], tile=TILE, stride=stride))
    np.testing.assert_array_equal(got[1]["prob"], direct[0])
    np.testing.assert_array_equal(got[1]["mask"], direct[1])


def test_sweep_out_dir_files(models, tmp_path):
    name, model, jmodel, state = models
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    kw = dict(tile=TILE, batch_size=8, geojson=True)
    got = run_sweep(model, _slides(), out_dir=str(ours), **kw)
    jax_run_sweep(jmodel, state, _slides(), out_dir=str(ref), **kw)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and len(names) == 6
    for r in got:
        assert "prob" not in r and "mask" not in r and "geojson" not in r
        i = r["slide"]
        prob = np.load(ours / f"slide_{i:04d}_prob.npy")
        mask = np.load(ours / f"slide_{i:04d}_mask.npy")
        _assert_maps_close(
            (prob, mask), (np.load(ref / f"slide_{i:04d}_prob.npy"),
                           np.load(ref / f"slide_{i:04d}_mask.npy")))
        assert prob.shape == tuple(r["canvas_hw"])
        gj = ours / f"slide_{i:04d}_annotations.geojson"
        fc = json.loads(gj.read_text())
        assert len(fc["features"]) == r["n_regions"]
        for f in fc["features"]:
            assert f["properties"]["measurements"] == {
                "tumor_fraction": r["tumor_fraction"]}
        # the annotations rasterize back to the saved mask exactly
        back = rasterize_shapes(parse_geojson(str(gj)), *mask.shape)
        np.testing.assert_array_equal(back.astype(bool), mask.astype(bool))


def test_sweep_takes_tile_sources_and_an_infer_step(models):
    """A tile source goes through its ``get``; an ``infer_step`` with no
    model runs on ``device``."""
    name, model, jmodel, state = models
    source = SyntheticSlideSource(80, tile=TILE, stride=24, seed=3)
    (got,) = run_sweep(model, [source], tile=TILE, batch_size=6)
    (want,) = jax_run_sweep(jmodel, state, [source], tile=TILE, batch_size=6)
    assert got["n_tiles"] == want["n_tiles"] == len(source)
    _assert_maps_close((got["prob"], got["mask"]),
                       (want["prob"], want["mask"]))
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_infer_step,
    )

    (stepped,) = run_sweep(None, [source], tile=TILE, batch_size=6,
                           infer_step=make_infer_step(model, TILE),
                           device="cpu")
    np.testing.assert_array_equal(stepped["prob"], got["prob"])


def test_sharded_sweep_raises_naming_the_roadmap(models):
    _, model, _, _ = models
    for kw in ({"sharded": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4.5"):
            run_sweep(model, _slides(), tile=TILE, **kw)

"""The PyTorch port's band-sharded whole-slide runner
(``infer/wsi_sharded.py``), its sweep and ``cli.overlay --sharded``, on the
CPU over ``["cpu"] * 8`` (eight bands, one device named eight times).

* Against the JAX ``ShardedSlidingWindow`` on the 8-device CPU mesh, with
  carried weights (a seeded FPN at 32² tiles, the JAX side through
  ``convert_smp_fpn_state_dict``): probabilities within 5e-4
  (``tests/test_torch_wsi.py``'s bound), masks ≥ 99.9% equal.
* Against the port's own one-device ``SlidingWindowInference``: within
  2e-5 and masks equal (``tests/test_wsi_sharded.py``'s bound; rolled mode
  stores float16, 1e-3, its mask thresholded before the cast), in the JAX
  file's cases: blend and stride, a short slide, TTA, band input and
  window upload, uncertainty, rolled mode (and an irregular height), the
  refusals, band input never decoding windows.
(The sharded sweep and ``cli.overlay --sharded``:
``tests/test_torch_wsi_sharded_cli.py``.)
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.infer.wsi_sharded import (
    ShardedSlidingWindow as JaxSharded,
)
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
    GridTiler,
    SlidingWindowInference,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi_sharded import (
    ShardedSlidingWindow,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)

TILE = 32
PROB_ATOL = 5e-4  # tests/test_torch_wsi.py's bound against JAX
SELF_ATOL = 2e-5  # tests/test_wsi_sharded.py's bound against one device
DEVICES = ["cpu"] * 8
_State = namedtuple("_State", "params batch_stats")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fpn():
    """(port FPN, JAX FPN, JAX state, 8-device mesh) from one seeded sd."""
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
    return model, jmodel, _State(params, batch_stats), jax_create_mesh(8)


def _slide(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _one_device(model, tiler, **kw):
    return SlidingWindowInference(model, tile=TILE, batch_size=8,
                                  num_workers=2, device="cpu",
                                  **kw).run(tiler)


def _assert_self(got, want, atol=SELF_ATOL):
    assert len(got) == len(want)
    assert got[0].shape == want[0].shape
    for g, w in zip(got[::2], want[::2]):  # probabilities, uncertainty
        np.testing.assert_allclose(g.astype(np.float32), w, rtol=0,
                                   atol=atol)
    np.testing.assert_array_equal(got[1], want[1])


def _assert_jax(got, want, unc=False):
    np.testing.assert_allclose(got[0].astype(np.float32),
                               np.asarray(want[0], np.float32), rtol=0,
                               atol=PROB_ATOL)
    assert (got[1] == want[1]).mean() >= 0.999
    if unc:
        np.testing.assert_allclose(got[2].astype(np.float32),
                                   np.asarray(want[2], np.float32), rtol=0,
                                   atol=1e-5)


# -- against the JAX runner ---------------------------------------------------

@pytest.mark.parametrize("mode", ["window", "band", "uncertainty", "rolled"])
def test_sharded_matches_jax_runner(fpn, mode):
    model, jmodel, state, jmesh = fpn
    h, w = (256, 32) if mode == "uncertainty" else (320, 96)
    tiler = GridTiler(_slide(0, h, w), tile=TILE, stride=16)
    kw = dict(tile=TILE, batch_per_device=4, blend="hann",
              band_input=mode != "window")
    if mode == "uncertainty":
        kw.update(tta=True, uncertainty=True)
    if mode == "rolled":
        kw.update(roll_h=TILE)
    got = ShardedSlidingWindow(model, DEVICES, **kw).run(tiler)
    want = JaxSharded(jmodel, state, jmesh, **kw).run(tiler)
    assert got[0].dtype == np.asarray(want[0]).dtype
    _assert_jax(got, want, unc=mode == "uncertainty")


# -- against the one-device runner --------------------------------------------

@pytest.mark.parametrize("blend,stride", [("hann", 16), ("uniform", 32)])
def test_sharded_matches_single_device(fpn, blend, stride):
    tiler = GridTiler(_slide(0, 320, 96), tile=TILE, stride=stride)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=4, blend=blend).run(tiler)
    assert got[0].dtype == np.float32 and got[1].dtype == np.uint8
    _assert_self(got, _one_device(fpn[0], tiler, blend=blend))


def test_sharded_short_slide_pads_empty_bands(fpn):
    tiler = GridTiler(_slide(1, 64, 64), tile=TILE, stride=TILE)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=2, blend="uniform").run(tiler)
    assert got[0].shape == (64, 64)
    _assert_self(got, _one_device(fpn[0], tiler, blend="uniform"))


def test_sharded_tta(fpn):
    tiler = GridTiler(_slide(2, 288, 32), tile=TILE, stride=TILE)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=2, blend="uniform",
                               tta=True).run(tiler)
    _assert_self(got, _one_device(fpn[0], tiler, blend="uniform", tta=True))


@pytest.mark.parametrize("band_input", [False, True])
def test_sharded_uncertainty_matches_single_device(fpn, band_input):
    tiler = GridTiler(_slide(3, 256, 48), tile=TILE, stride=16)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=4, blend="hann", tta=True,
                               uncertainty=True,
                               band_input=band_input).run(tiler)
    want = _one_device(fpn[0], tiler, blend="hann", tta=True,
                       uncertainty=True)
    _assert_self(got, want)
    assert float(got[2].max()) > 0.0


def test_sharded_band_input_never_decodes_windows(fpn):
    """Band input plans from ``source.coords`` and reads bands: ``get(i)``
    would decode every overlapping window on the host."""

    class CountingTiler(GridTiler):
        gets = 0

        def get(self, i):
            type(self).gets += 1
            return super().get(i)

    slide = _slide(7, 320, 96)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=4).run(
        CountingTiler(slide, tile=TILE, stride=16))
    assert CountingTiler.gets == 0
    _assert_self(got, _one_device(fpn[0], GridTiler(slide, tile=TILE,
                                                    stride=16)))


@pytest.mark.parametrize("band_input", [False, True])
def test_rolled_matches_single_device(fpn, band_input):
    """768 rows over 8 bands: 96-row regions through 32-row rolls, tiles
    crossing roll and band boundaries; float16 storage."""
    tiler = GridTiler(_slide(11, 768, 96), tile=TILE, stride=16)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=4, blend="hann",
                               band_input=band_input, roll_h=TILE).run(tiler)
    assert got[0].dtype == np.float16
    _assert_self(got, _one_device(fpn[0], tiler, blend="hann"), atol=1e-3)


def test_rolled_irregular_height_and_uncertainty(fpn):
    tiler = GridTiler(_slide(12, 700, 64), tile=TILE, stride=TILE)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=2, blend="uniform",
                               roll_h=TILE).run(tiler)
    _assert_self(got, _one_device(fpn[0], tiler, blend="uniform"), atol=1e-3)
    tiler = GridTiler(_slide(13, 512, 32), tile=TILE, stride=16)
    got = ShardedSlidingWindow(fpn[0], DEVICES, tile=TILE,
                               batch_per_device=4, blend="hann", tta=True,
                               uncertainty=True, roll_h=TILE).run(tiler)
    _assert_self(got, _one_device(fpn[0], tiler, blend="hann", tta=True,
                                  uncertainty=True), atol=1e-3)


def test_sharded_refusals(fpn):
    model = fpn[0]
    with pytest.raises(ValueError, match="roll_h"):
        ShardedSlidingWindow(model, DEVICES, tile=TILE, roll_h=16)

    class WindowsOnly:
        def __init__(self, tiler):
            self._t, self.canvas_hw = tiler, tiler.canvas_hw

        def __len__(self):
            return len(self._t)

        def get(self, i):
            return self._t.get(i)

    src = WindowsOnly(GridTiler(_slide(6, 320, 96), tile=TILE, stride=TILE))
    with pytest.raises(ValueError, match="read_region"):
        ShardedSlidingWindow(model, DEVICES, tile=TILE,
                             band_input=True).run(src)
    mc = build_model(Config(model="fpn", img_size=TILE, num_classes=3))
    with pytest.raises(ValueError, match="multi-class"):
        ShardedSlidingWindow(mc, DEVICES, tile=TILE)
    with pytest.raises(ValueError, match="infer_step"):
        ShardedSlidingWindow(None, DEVICES, tile=TILE)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedSlidingWindow(model, ["cuda"], tile=TILE)

"""The band-sharded sweep and ``cli.overlay --sharded`` of the PyTorch port
against the JAX package on the CPU, over ``["cpu"] * 8`` (the JAX side on
its 8-device CPU mesh), with carried weights (a seeded FPN at 32² tiles):

* ``run_sweep(sharded=True)`` against the JAX ``run_sweep(sharded=True)``
  (probabilities within 5e-4, masks ≥ 99.9%, the records) and the port's
  own one-device sweep (2e-5, masks equal);
* ``cli.overlay --slide --sharded`` (and rolled with ``--band_h``) against
  the JAX CLI with ``num_devices: 8``; ``--sharded --int8`` against the
  port's one-device ``--int8`` and the JAX CLI's; the JAX CLI's refusals
  kept (``--artifact`` or ``--banded`` with ``--sharded``).
"""

import numpy as np
import pytest
import yaml

from pdac_pathological_image_segmentation_tpu.cli import overlay as jax_cli
from pdac_pathological_image_segmentation_tpu.infer.sweep import (
    run_sweep as jax_run_sweep,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    overlay as cli_overlay,
)
from pdac_pathological_image_segmentation_tpu_torch.data.tiffwriter import (
    write_tiff,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.sweep import (
    run_sweep,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
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

from test_torch_wsi_sharded import (  # noqa: F401 (fixtures)
    DEVICES,
    PROB_ATOL,
    SELF_ATOL,
    TILE,
    _assert_jax,
    _assert_self,
    _one_torch_thread,
    _slide,
    fpn,
)


# -- the sweep and the CLI ----------------------------------------------------

def test_sharded_sweep_matches_jax(fpn):
    model, jmodel, state, jmesh = fpn
    rng = np.random.default_rng(5)
    slides = [rng.integers(0, 256, (96, 64, 3), dtype=np.uint8),
              rng.integers(0, 256, (40, 112, 3), dtype=np.uint8)]
    kw = dict(tile=TILE, stride=16, batch_size=16, sharded=True)
    got = run_sweep(model, slides, mesh=DEVICES, **kw)
    want = jax_run_sweep(jmodel, state, slides, mesh=jmesh, **kw)
    assert [r["slide"] for r in got] == [r["slide"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert g["n_tiles"] == w["n_tiles"]
        assert tuple(g["canvas_hw"]) == tuple(w["canvas_hw"])
        _assert_jax((g["prob"], g["mask"]), (w["prob"], w["mask"]))
        assert abs(g["tumor_fraction"] - w["tumor_fraction"]) < 1e-3
    one = run_sweep(model, slides, device="cpu", tile=TILE, stride=16,
                    batch_size=16)
    for g, w in zip(got, one):
        _assert_self((g["prob"], g["mask"]), (w["prob"], w["mask"]))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A deflate pyramidal TIFF, one port-written ``best.pth`` and a config
    with ``num_devices: 8``."""
    root = tmp_path_factory.mktemp("overlay_sharded")
    write_tiff(str(root / "slide.tiff"), _slide(7, 300, 64), tile=32,
               min_size=32)
    cfg = Config(model="fpn", img_size=TILE, compute_dtype="float32")
    model = build_model(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=13), strict=True)
    save_checkpoint(str(root / "pth"), model, make_optimizer(model, 1e-4), 1,
                    0.5, {"lr": 1e-4, "best": 0.5, "num_bad_epochs": 0},
                    EarlyStop().state_dict(), is_best=True)
    raw = {"model": "fpn", "backbone": "resnet18", "img_size": TILE,
           "batch_size": 16, "num_worker": 2, "compute_dtype": "float32",
           "num_devices": 8}
    (root / "cfg.yaml").write_text(yaml.safe_dump(raw))
    return root


def _cli(cli_run, name, extra, jax=False):
    argv = ["--config", str(cli_run / "cfg.yaml"), "--pth_path",
            str(cli_run / "pth" / "best.pth"), "--slide",
            str(cli_run / "slide.tiff"), "--stride", "16",
            "--save_path", str(cli_run / name)] + extra
    if jax:
        out = jax_cli.main(argv)
    else:
        out = cli_overlay.main(argv + ["--device", "cpu"])
    return out, np.load(cli_run / name / "probability_map.npy")


@pytest.mark.parametrize("extra", [["--blend", "hann"],
                                   ["--band_h", "32"]])
def test_cli_overlay_sharded_matches_jax(cli_run, extra):
    """``cli.overlay --slide --sharded`` (eight bands; ``--band_h``: rolled,
    float16 maps) against the JAX CLI on 8 devices: probabilities within
    5e-4, masks ≥ 99.9% equal."""
    name = "_".join(a.strip("-") for a in extra)
    ours, p = _cli(cli_run, name + "_p", ["--sharded"] + extra)
    ref, jp = _cli(cli_run, name + "_j", ["--sharded"] + extra, jax=True)
    assert p.shape == jp.shape == (300, 64) and p.dtype == jp.dtype
    assert ours["n_tiles"] == ref["n_tiles"]
    np.testing.assert_allclose(p.astype(np.float32), jp.astype(np.float32),
                               rtol=0, atol=PROB_ATOL)
    assert np.mean((p >= 0.5) == (jp >= 0.5)) >= 0.999


def test_cli_overlay_sharded_int8(cli_run):
    """``--sharded --int8``: the same int8 step per band as ``--int8`` on
    one device (within 2e-5, masks equal: only the stitching differs), and
    against the JAX CLI's ``--sharded --int8`` the int8 agreement of
    ``test_torch_wsi.py`` (the JAX path is jitted, and XLA's fusions move
    int8 roundings): masks ≥ 99% equal, tumor fractions within 1%."""
    int8 = ["--int8", "--stride", "32"]
    ours, p = _cli(cli_run, "int8_p", ["--sharded"] + int8)
    one, p1 = _cli(cli_run, "int8_one", int8)
    ref, jp = _cli(cli_run, "int8_j", ["--sharded"] + int8, jax=True)
    assert ours["n_tiles"] == one["n_tiles"] == ref["n_tiles"]
    np.testing.assert_allclose(p, p1, rtol=0, atol=SELF_ATOL)
    np.testing.assert_array_equal(p >= 0.5, p1 >= 0.5)
    assert np.mean((p >= 0.5) == (jp >= 0.5)) >= 0.99
    assert abs(ours["tumor_fraction"] - ref["tumor_fraction"]) < 0.01


@pytest.mark.parametrize("flags,match", [
    (["--artifact", "model.pdacpt"], "--artifact does not compose"),
    (["--banded"], "mutually exclusive")])
def test_cli_overlay_keeps_the_jax_refusals(cli_run, flags, match):
    """As the JAX CLI (``cli/overlay.py:180-183``, ``:280-281``):
    ``--sharded`` takes neither an artifact nor ``--banded``."""
    with pytest.raises(SystemExit, match=match):
        cli_overlay.main(["--config", str(cli_run / "cfg.yaml"),
                          "--pth_path", str(cli_run / "pth"), "--device",
                          "cpu", "--save_path", str(cli_run / "refused"),
                          "--sharded"] + flags)

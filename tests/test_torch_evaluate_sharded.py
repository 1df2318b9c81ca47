"""The PyTorch port's batch-sharded evaluation (``infer/evaluate.py`` with
``mesh=``, ``cli/test.py`` with ``num_devices``) against the JAX
``Evaluator`` on ``create_mesh(n)`` and against the port's one-device run,
on the CPU (``[cpu] * n``; conftest forces 8 JAX CPU devices), f32 at 64².

* FPN/resnet18 over 2 and 4 devices, ResUNet over 2, a 3-class ResUNet
  (Dice + CE with class weights) over 2: ``test_score``, ``test_loss``,
  ``best_dice`` and ``dice_at_0.5`` within 1e-4 of the JAX run on the same
  mesh size, ``best_threshold`` within one bucket, ``metrics.csv`` and
  ``threshold_sweep.csv`` within 1e-4 (``tests/test_torch_evaluate.py``'s
  bounds).
* Sharded against one device: scores within 1e-6, ``metrics.csv`` rows in
  dataset order and within 1e-6, each batch's histograms equal but for
  pixels within 1e-6 of a bucket edge.
* 10 patches at batch 4 over 4 devices: the last batch's last two shards
  hold wrap padding only.
* Batches whose first shard is all tumor: the mean of the shards' Dice is
  more than 10x the bound away from the batch's Dice, which both sides
  report.
* A batch size the mesh does not divide raises ``ValueError`` on both
  sides; ``cli.test`` with ``num_devices: 2`` evaluates over
  ``[cpu] * 2``.
"""

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.data.discovery import (
    discover_split as jax_discover_split,
)
from pdac_pathological_image_segmentation_tpu.data.loader import (
    PatchDataset as JaxPatchDataset,
)
from pdac_pathological_image_segmentation_tpu.data.synthetic import (
    generate_synthetic_patches,
)
from pdac_pathological_image_segmentation_tpu.infer.evaluate import (
    Evaluator as JaxEvaluator,
)
from pdac_pathological_image_segmentation_tpu.parallel.mesh import create_mesh
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.cli import test as cli_test
from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
    discover_split,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
    Evaluator,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.ops import metrics
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    normalize,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.dice import SMOOTH
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

from test_torch_evaluate import (
    _assert_csv_close,
    _near_edges,
    _probabilities,
    _read_csv,
)

SIZE = 64
BINS = metrics.SWEEP_BINS
CPU = torch.device("cpu")
JAX_BOUND = 1e-4  # port against JAX (tests/test_torch_evaluate.py)
SELF_BOUND = 1e-6  # port sharded against port on one device


def _raw_cfg(model, test_path, **extra):
    return {"model": model, "backbone": "resnet18", "img_size": SIZE,
            "batch_size": 4, "num_worker": 2, "seed": 41,
            "compute_dtype": "float32", "test_path": str(test_path),
            **extra}


def _write_best_pth(raw, pth_dir, seed):
    """A ``best.pth`` the port's trainer would write, of ``raw``'s model,
    with seeded weights."""
    cfg = Config.from_dict(raw)
    model = build_model(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=seed), strict=True)
    save_checkpoint(str(pth_dir), model, make_optimizer(model, 1e-4), 3, 0.5,
                    {"lr": 1e-4, "best": 0.5, "num_bad_epochs": 0},
                    EarlyStop().state_dict(), is_best=True)


def _evaluate(raw, pth_dir, out, mesh=None, jax_devices=None):
    """The port's ``Evaluator`` over ``mesh`` (one CPU device when None)
    or, with ``jax_devices``, the JAX one over ``create_mesh(n)``, on
    ``raw``'s test split: ``(evaluator, result)``, the CSVs under
    ``out``."""
    kw = dict(metrics_csv=str(out / "metrics.csv"),
              sweep_csv=str(out / "sweep.csv"), verbose=False)
    if jax_devices is not None:
        cfg = JaxConfig.from_dict(raw)
        ev = JaxEvaluator(cfg, str(pth_dir / "best.pth"),
                          mesh=create_mesh(jax_devices))
        data = JaxPatchDataset(*jax_discover_split(raw["test_path"]), cfg)
    else:
        cfg = Config.from_dict(raw)
        ev = Evaluator(cfg, str(pth_dir), device="cpu", mesh=mesh)
        data = PatchDataset(*discover_split(raw["test_path"]), cfg)
    return ev, ev.run(data, **kw)


def _assert_scores(got, want, bound, binary=True):
    assert got["n_samples"] == want["n_samples"]
    keys = ["test_score", "test_loss"] + (
        ["best_dice", "dice_at_0.5"] if binary else [])
    for k in keys:
        assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k])
    for k in metrics.METRIC_NAMES:
        assert abs(got["metrics"][k] - want["metrics"][k]) <= bound, k
    if binary:
        assert abs(got["best_threshold"] - want["best_threshold"]) <= 1 / BINS


def _assert_csv_within(got_path, want_path, bound):
    """Every row of two CSVs in the same order, the text columns equal and
    the numbers within ``bound`` (the files round to 6 decimals: a value
    on a rounding edge may read 1e-6 apart)."""
    got, want = _read_csv(got_path), _read_csv(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(np.asarray(g[2:], float),
                                   np.asarray(w[2:], float), rtol=0,
                                   atol=bound + 1e-9, err_msg=str(g[:2]))


def _assert_sweep_close(got_path, want_path, p, q):
    """The sweeps within 1e-4 but at the edges k/256 that some pixel's
    probability lies within 1e-6 of on either side (``p``, ``q``): such a
    pixel may fall in bucket k on one side and k − 1 on the other, which
    moves that row's recall by 1/positives, so those rows are held within
    1e-3 (``tests/test_torch_evaluate.py``'s sweep test)."""
    got = np.asarray(_read_csv(got_path)[1:], float)
    want = np.asarray(_read_csv(want_path)[1:], float)
    assert got.shape == want.shape == (BINS + 1, 7)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    near = _near_edges(p, q)
    edges = {int(k) for pr in (p, q) for k in np.round(pr[near] * BINS)}
    off_edge = np.asarray([k not in edges for k in range(BINS + 1)])
    np.testing.assert_allclose(got[off_edge], want[off_edge], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[~off_edge], want[~off_edge], rtol=0,
                               atol=1e-3)


def _batches(ds, batch):
    """The loader's batches of ``ds`` in order, the last wrap-padded:
    ``(images, masks, valid)`` host tensors."""
    n = len(ds)
    for start in range(0, n, batch):
        idx = [(start + i) % n for i in range(batch)]
        yield (torch.from_numpy(np.stack([ds[i][0] for i in idx])),
               torch.from_numpy(np.stack([ds[i][1] for i in idx])),
               torch.tensor([start + i < n for i in range(batch)]))


# -- binary models against the JAX Evaluator on the same mesh size ----------

@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("test_split")
    generate_synthetic_patches(str(root), n=10, size=SIZE, seed=21)
    return root


@pytest.fixture(scope="module")
def one_device(test_split, tmp_path_factory):
    """Each model's ``best.pth`` and the port's one-device run on it."""
    runs = {}
    for model in ("fpn", "unet"):
        run = tmp_path_factory.mktemp(f"sharded_{model}")
        raw = _raw_cfg(model, test_split)
        _write_best_pth(raw, run / "pth", seed=31)
        runs[model] = (run, raw) + _evaluate(raw, run / "pth", run / "one")
    return runs


@pytest.fixture(scope="module",
                params=[("fpn", 2), ("fpn", 4), ("unet", 2)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def sharded(request, one_device):
    model, n = request.param
    run, raw, one, one_result = one_device[model]
    ours, got = _evaluate(raw, run / "pth", run / f"port{n}",
                          mesh=[CPU] * n)
    ref, want = _evaluate(raw, run / "pth", run / f"jax{n}", jax_devices=n)
    ds = PatchDataset(*discover_split(raw["test_path"]), ours.cfg)
    p, q = _probabilities(ours, ref, np.stack([ds[i][0]
                                               for i in range(len(ds))]))
    return {"run": run, "n": n, "ours": ours, "one": one, "got": got,
            "want": want, "one_result": one_result, "p": p, "q": q}


def test_sharded_evaluator_matches_jax_mesh(sharded):
    run, n = sharded["run"], sharded["n"]
    assert sharded["ours"].mesh == [CPU] * n
    _assert_scores(sharded["got"], sharded["want"], JAX_BOUND)
    assert sharded["got"]["n_samples"] == 10
    _assert_csv_close(run / f"port{n}" / "metrics.csv",
                      run / f"jax{n}" / "metrics.csv", text_columns=2)
    _assert_sweep_close(run / f"port{n}" / "sweep.csv",
                        run / f"jax{n}" / "sweep.csv", sharded["p"],
                        sharded["q"])


def test_sharded_evaluator_matches_one_device(sharded):
    run, n = sharded["run"], sharded["n"]
    _assert_scores(sharded["got"], sharded["one_result"], SELF_BOUND)
    rows = _read_csv(run / f"port{n}" / "metrics.csv")
    assert [r[0] for r in rows[1:]] == [str(i) for i in range(10)] + [
        "macro", "micro"]
    _assert_csv_within(run / f"port{n}" / "metrics.csv",
                       run / "one" / "metrics.csv", SELF_BOUND)


def test_sharded_histograms_match_one_device(sharded):
    """Each batch's histograms over the mesh against one device: equal
    but for pixels within 1e-6 of a bucket edge on either side."""
    ours, one = sharded["ours"], sharded["one"]
    ds = PatchDataset(*discover_split(ours.cfg.test_path), ours.cfg)
    for images, masks, valid in _batches(ds, ours.cfg.batch_size):
        got = ours._step(images, masks, valid)[-1].numpy()
        want = one._step(images, masks, valid)[-1].numpy()
        x = normalize(images.permute(0, 3, 1, 2))
        with torch.no_grad():
            # the shards' probabilities as each shard computes them
            sharded = torch.cat([ours.model(part) for part in
                                 x.chunk(len(ours.mesh))])
            probs = [torch.sigmoid(out[:, 0]).numpy()
                     for out in (sharded, one.model(x))]
        near = _near_edges(*probs) & valid.numpy()[:, None, None]
        assert int(np.abs(got - want).sum()) <= 2 * int(near.sum())
        assert got.sum() == want.sum() == int(valid.sum()) * SIZE * SIZE


def test_padded_shards_hold_no_valid_row(one_device):
    """10 patches at batch 4 over 4 devices: the last batch is rows 8, 9
    and two wrap-padded rows, so its last two shards are padding only;
    they run and count nothing, and the batch's loss and score are those
    of its two valid rows on one device (the whole run against JAX is
    ``test_sharded_evaluator_matches_jax_mesh[fpn-4]``)."""
    run, raw, one, _ = one_device["fpn"]
    ours = Evaluator(Config.from_dict(raw), str(run / "pth"),
                     mesh=[CPU] * 4)
    ds = PatchDataset(*discover_split(raw["test_path"]), ours.cfg)
    *_, (images, masks, valid) = _batches(ds, 4)
    assert valid.tolist() == [True, True, False, False]
    loss, score, shards, hists = ours._step(images, masks, valid)
    assert len(shards) == 4 and all(len(s.counts) == 1 for s in shards)
    for shard in shards[2:]:
        assert float(shard.counts.sum()) == 0.0
    assert [float(s.counts.sum()) for s in shards[:2]] == [SIZE * SIZE] * 2
    assert int(hists.sum()) == 2 * SIZE * SIZE
    want = one._step(images[:2], masks[:2], valid[:2])
    assert abs(float(loss) - float(want[0])) <= SELF_BOUND
    assert abs(float(score) - float(want[1])) <= SELF_BOUND


# -- the batch's Dice, not a mean over shards --------------------------------

@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    """8 patches, the first two of each batch of 4 (the first shard over
    2 devices, in the dataset's seeded order) all tumor, and an FPN
    ``best.pth``."""
    root = tmp_path_factory.mktemp("skewed")
    generate_synthetic_patches(str(root / "test"), n=8, size=SIZE, seed=23)
    raw = _raw_cfg("fpn", root / "test")
    ds = PatchDataset(*discover_split(raw["test_path"]),
                      Config.from_dict(raw))
    for i, path in enumerate(ds.mask_paths):
        if i % 4 < 2:
            Image.fromarray(np.ones((SIZE, SIZE), np.uint8)).save(path)
    _write_best_pth(raw, root / "pth", seed=33)
    return root, raw


def test_sharded_score_is_the_batch_dice_not_a_mean_of_shards(skewed):
    root, raw = skewed
    one, one_result = _evaluate(raw, root / "pth", root / "one")
    _, got = _evaluate(raw, root / "pth", root / "port2", mesh=[CPU] * 2)
    _, want = _evaluate(raw, root / "pth", root / "jax2", jax_devices=2)
    # the mean over shards of each shard's hard Dice, batch by batch
    ds = PatchDataset(*discover_split(raw["test_path"]), one.cfg)
    shard_means = []
    for images, masks, valid in _batches(ds, 4):
        counts = one._step(images, masks, valid)[2][0].counts[:, 0]
        dice = [(2 * c[:, 0].sum() + SMOOTH)
                / (2 * c[:, 0].sum() + c[:, 1].sum() + c[:, 2].sum()
                   + SMOOTH) for c in (counts[:2], counts[2:])]
        shard_means.append(float(np.mean(dice)))
    mean_of_shards = float(np.mean(shard_means))
    gap = abs(mean_of_shards - one_result["test_score"])
    assert gap > 10 * JAX_BOUND, (mean_of_shards, one_result["test_score"])
    assert abs(got["test_score"] - one_result["test_score"]) <= SELF_BOUND
    assert abs(got["test_score"] - want["test_score"]) <= JAX_BOUND
    assert abs(got["test_loss"] - one_result["test_loss"]) <= SELF_BOUND
    assert abs(got["test_loss"] - want["test_loss"]) <= JAX_BOUND


# -- three classes -----------------------------------------------------------

def test_sharded_three_classes_match_jax_mesh(tmp_path):
    """A 3-class ResUNet with Dice + CE and class weights over 2 devices:
    the macro Dice, the CE over the valid pixels and the per-class
    ``metrics.csv`` against the JAX run on ``create_mesh(2)`` and the
    port's one-device run; no sweep."""
    generate_synthetic_patches(str(tmp_path / "test"), n=6, size=SIZE,
                               seed=25, num_classes=3)
    raw = _raw_cfg("unet", tmp_path / "test", num_classes=3,
                   loss="dice_ce", class_weights=[1.0, 2.0, 2.0])
    _write_best_pth(raw, tmp_path / "pth", seed=35)
    _, got = _evaluate(raw, tmp_path / "pth", tmp_path / "port2",
                       mesh=[CPU] * 2)
    _, want = _evaluate(raw, tmp_path / "pth", tmp_path / "jax2",
                        jax_devices=2)
    _, one = _evaluate(raw, tmp_path / "pth", tmp_path / "one")
    assert got["n_samples"] == 6 and "best_threshold" not in got
    _assert_scores(got, want, JAX_BOUND, binary=False)
    _assert_scores(got, one, SELF_BOUND, binary=False)
    assert "dice_c2" in _read_csv(tmp_path / "port2" / "metrics.csv")[0]
    _assert_csv_close(tmp_path / "port2" / "metrics.csv",
                      tmp_path / "jax2" / "metrics.csv", text_columns=2)
    assert not (tmp_path / "port2" / "sweep.csv").exists()


# -- refusals and the CLI ----------------------------------------------------

def test_batch_the_mesh_does_not_divide_raises_on_both_sides(one_device):
    run, raw, _, _ = one_device["fpn"]
    with pytest.raises(ValueError, match="divide"):
        _evaluate(raw, run / "pth", run / "port3", mesh=[CPU] * 3)
    assert not (run / "port3").exists()
    with pytest.raises(ValueError, match="divisible"):
        _evaluate(raw, run / "pth", run / "jax3", jax_devices=3)


def test_cli_test_num_devices_shards_on_the_cpu(one_device, tmp_path,
                                                monkeypatch):
    """``cli.test --device cpu`` with ``num_devices: 2`` evaluates over
    ``[cpu] * 2`` and writes the one-device run's numbers; without
    ``num_devices`` it stays on one device."""
    run, raw, _, one = one_device["unet"]
    meshes = []

    class Spy(Evaluator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            meshes.append(self.mesh)

    monkeypatch.setattr(cli_test, "Evaluator", Spy)
    results = {}
    for name, extra in (("two", {"num_devices": 2}), ("unset", {})):
        cfg_path = tmp_path / f"{name}.yaml"
        cfg_path.write_text(yaml.safe_dump(dict(raw, **extra)))
        results[name] = cli_test.main([
            "--config", str(cfg_path), "--save_path", str(tmp_path / name),
            "--pth_path", str(run / "pth"), "--max_figures", "0",
            "--device", "cpu"])
    assert meshes == [[CPU] * 2, [CPU]]
    _assert_scores(results["two"], one, SELF_BOUND)
    _assert_scores(results["unset"], one, 0.0)
    _assert_csv_within(tmp_path / "two" / "metrics.csv",
                       run / "one" / "metrics.csv", SELF_BOUND)

"""The PyTorch port's evaluation (``ops/metrics.py``, ``infer/evaluate.py``,
``cli/test.py``, ``make_predict_step``) against the JAX package, on the CPU.

* The metric functions on seeded inputs: confusion counts and histograms
  exactly (the ``prob == 1.0`` bucket, bucket edges and padded samples
  included), the sweep and the derived metrics to float rounding.
* ``Evaluator`` against the JAX ``Evaluator`` on one port-written
  ``best.pth`` (the JAX side reads it through
  ``load_reference_model_checkpoint``), for FPN and for ResUNet, f32 at
  64², 10 samples at batch 4 (a wrap-padded last batch): ``test_score``
  and ``test_loss``, every ``metrics.csv`` cell and every
  ``threshold_sweep.csv`` cell within 1e-4
  (``tests/test_resunet_golden.py``'s bound), and the histograms equal
  but for pixels whose probability lies within 1e-6 of a bucket edge.
* ``cli.test --device cpu`` writes its figures and CSVs; a ``--pth_path``
  that names no checkpoint raises ``FileNotFoundError``.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

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
from pdac_pathological_image_segmentation_tpu.ops import metrics as jax_metrics
from pdac_pathological_image_segmentation_tpu.parallel.mesh import create_mesh
from pdac_pathological_image_segmentation_tpu.train.objective import (
    make_objective as jax_make_objective,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_predict_step as jax_make_predict_step,
)
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
    resolve_pth,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.ops import metrics
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    denormalize,
    normalize,
)
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    save_checkpoint,
)
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    make_optimizer,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_predict_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
    EarlyStop,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)

SIZE = 64
BINS = metrics.SWEEP_BINS


# -- the metric functions ----------------------------------------------------

def _labels(seed, n=5):
    rng = np.random.default_rng(seed)
    preds = (rng.random((n, 16, 16)) < 0.5).astype(np.float32)
    masks = (rng.random((n, 16, 16)) < 0.3).astype(np.float32)
    preds[0] = 0.0  # an empty prediction
    masks[1] = 0.0  # an empty mask
    valid = np.array([True, True, False, True, True][:n])
    return preds, masks, valid


@pytest.mark.parametrize("with_valid", [True, False])
def test_per_sample_confusion_matches_jax(with_valid):
    preds, masks, valid = _labels(0)
    v = valid if with_valid else None
    got = metrics.per_sample_confusion(
        torch.from_numpy(preds), torch.from_numpy(masks),
        None if v is None else torch.from_numpy(v))
    want = jax_metrics.per_sample_confusion(
        jnp.asarray(preds), jnp.asarray(masks),
        None if v is None else jnp.asarray(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 1, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_per_sample_confusion_multiclass_matches_jax():
    rng = np.random.default_rng(1)
    preds = rng.integers(0, 3, (4, 8, 8)).astype(np.int32)
    masks = rng.integers(0, 3, (4, 8, 8)).astype(np.int32)
    got = metrics.per_sample_confusion(torch.from_numpy(preds),
                                       torch.from_numpy(masks), num_classes=3)
    want = jax_metrics.per_sample_confusion(jnp.asarray(preds),
                                            jnp.asarray(masks), num_classes=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _probs(seed):
    """Probabilities with exact 0.0, exact 1.0 (the extra bucket), every
    bucket edge k/256 and values just below and above edges."""
    rng = np.random.default_rng(seed)
    p = rng.random((5, 24, 24)).astype(np.float32)
    edges = (np.arange(BINS + 1) / BINS).astype(np.float32)
    flat = p.reshape(-1)
    flat[: BINS + 1] = edges
    flat[BINS + 1: 2 * (BINS + 1)] = np.nextafter(edges, np.float32(-1))
    flat[2 * (BINS + 1): 2 * (BINS + 1) + 40] = 1.0
    flat[-40:] = 0.0
    return np.clip(p, 0.0, 1.0)


@pytest.mark.parametrize("with_valid", [True, False])
def test_prob_histograms_match_jax_exactly(with_valid):
    probs = _probs(2)
    masks = (np.random.default_rng(3).random(probs.shape) < 0.4).astype(
        np.uint8)
    valid = np.array([True, False, True, True, False]) if with_valid else None
    got = metrics.prob_histograms(
        torch.from_numpy(probs), torch.from_numpy(masks),
        None if valid is None else torch.from_numpy(valid))
    want = np.asarray(jax_metrics.prob_histograms(
        jnp.asarray(probs), jnp.asarray(masks),
        None if valid is None else jnp.asarray(valid)))
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, BINS + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    # prob == 1.0 owns the last bucket: exactly the forty saturated pixels
    # of the first sample, which is valid in both cases
    saturated = (probs == 1.0)
    if valid is not None:
        saturated = saturated & valid[:, None, None]
    assert int(got[:, BINS].sum()) == int(saturated.sum()) >= 40
    n_valid = probs.size if valid is None else int(valid.sum()) * 24 * 24
    assert int(got.sum()) == n_valid


def test_threshold_sweep_and_derive_metrics_match_jax():
    probs = _probs(4)
    masks = (np.random.default_rng(5).random(probs.shape) < 0.4).astype(
        np.uint8)
    hists = metrics.prob_histograms(torch.from_numpy(probs),
                                    torch.from_numpy(masks)).numpy()
    got, want = metrics.threshold_sweep(hists), jax_metrics.threshold_sweep(
        hists)
    assert sorted(got) == sorted(want) == sorted(
        ("threshold",) + metrics.METRIC_NAMES)
    for k in want:
        assert got[k].shape == (BINS + 1,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    preds, msks, valid = _labels(6)
    counts = metrics.per_sample_confusion(
        torch.from_numpy(preds), torch.from_numpy(msks),
        torch.from_numpy(valid))
    ours = metrics.derive_metrics(counts)
    ref = jax_metrics.derive_metrics(jnp.asarray(counts.numpy()))
    assert metrics.METRIC_NAMES == jax_metrics.METRIC_NAMES
    for k in metrics.METRIC_NAMES:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, err_msg=k)
    # numpy counts give numpy metrics (the host-side path)
    assert isinstance(metrics.derive_metrics(counts.numpy())["dice"],
                      np.ndarray)


def test_denormalize_inverts_normalize():
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, 3, 8, 8)).astype(np.float32))
    back = denormalize(normalize(x))
    torch.testing.assert_close(back, x / 255.0, rtol=0, atol=1e-6)
    assert float(denormalize(torch.full((1, 3, 1, 1), 50.0)).max()) == 1.0


# -- the Evaluator against the JAX Evaluator ---------------------------------

@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("test_split")
    generate_synthetic_patches(str(root), n=10, size=SIZE, seed=21)
    return root


def _raw_cfg(model, test_path):
    return {"model": model, "backbone": "resnet18", "img_size": SIZE,
            "batch_size": 4, "num_worker": 2, "seed": 41,
            "compute_dtype": "float32", "test_path": str(test_path)}


def _write_best_pth(model_name, pth_dir, seed):
    """A ``best.pth`` the port's trainer would write: seeded weights, an
    Adam state, the scheduler and the early stop."""
    cfg = Config(model=model_name, img_size=SIZE, compute_dtype="float32")
    model = build_model(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=seed), strict=True)
    save_checkpoint(str(pth_dir), model, make_optimizer(model, 1e-4), 3, 0.5,
                    {"lr": 1e-4, "best": 0.5, "num_bad_epochs": 0},
                    EarlyStop().state_dict(), is_best=True)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_csv_close(got_path, want_path, text_columns):
    got, want = _read_csv(got_path), _read_csv(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g[:text_columns] == w[:text_columns]
        np.testing.assert_allclose(np.asarray(g[text_columns:], float),
                                   np.asarray(w[text_columns:], float),
                                   rtol=0, atol=1e-4, err_msg=str(g[:2]))


@pytest.fixture(scope="module", params=["fpn", "unet"])
def evaluated(request, test_split, tmp_path_factory):
    model_name = request.param
    run = tmp_path_factory.mktemp(f"eval_{model_name}")
    _write_best_pth(model_name, run / "pth", seed=31)
    raw = _raw_cfg(model_name, test_split)
    ours = Evaluator(Config.from_dict(raw), str(run / "pth"), device="cpu")
    ref = JaxEvaluator(JaxConfig.from_dict(raw),
                       str(run / "pth" / "best.pth"), mesh=create_mesh(1))
    ds = PatchDataset(*discover_split(str(test_split)), Config.from_dict(raw))
    jds = JaxPatchDataset(*jax_discover_split(str(test_split)),
                          JaxConfig.from_dict(raw))
    results = {side: ev.run(data, metrics_csv=str(run / side / "metrics.csv"),
                            sweep_csv=str(run / side / "sweep.csv"),
                            verbose=False)
               for side, ev, data in (("port", ours, ds), ("jax", ref, jds))}
    # both sides' probabilities over the whole split, for the bucket edges
    images = np.stack([ds[i][0] for i in range(len(ds))])
    p, q = _probabilities(ours, ref, images)
    return {"run": run, "ours": ours, "ref": ref, "results": results,
            "ds": ds, "p": p, "q": q}


def _probabilities(ours, ref, images):
    """The port's and the JAX model's f32 probabilities of ``images``."""
    with torch.no_grad():
        x = normalize(torch.from_numpy(images).permute(0, 3, 1, 2))
        p = torch.sigmoid(ours.model(x)[:, 0]).numpy()
    q = np.asarray(jax.nn.sigmoid(ref.model.apply(
        {"params": ref.state.params, "batch_stats": ref.state.batch_stats},
        jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), train=False)[..., 0]))
    return p, q


def _near_edges(*probs, within=1e-6):
    """Per pixel: does any of ``probs`` lie within ``within`` of an edge
    k/256?  Such a pixel may fall in bucket k on one side and k − 1 on the
    other."""
    near = np.zeros(probs[0].shape, bool)
    for pr in probs:
        scaled = pr.astype(np.float64) * BINS
        near |= np.abs(scaled - np.round(scaled)) < within * BINS
    return near


def test_evaluator_scores_match_jax(evaluated):
    got, want = evaluated["results"]["port"], evaluated["results"]["jax"]
    assert got["n_samples"] == want["n_samples"] == 10
    for k in ("test_score", "test_loss", "best_dice", "dice_at_0.5"):
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    assert abs(got["best_threshold"] - want["best_threshold"]) <= 1 / BINS
    for k in metrics.METRIC_NAMES:
        assert abs(got["metrics"][k] - want["metrics"][k]) < 1e-4, k


def test_evaluator_metrics_csv_matches_jax(evaluated):
    run = evaluated["run"]
    _assert_csv_close(run / "port" / "metrics.csv", run / "jax" / "metrics.csv",
                      text_columns=2)
    rows = _read_csv(run / "port" / "metrics.csv")
    assert [r[0] for r in rows[1:]] == [str(i) for i in range(10)] + [
        "macro", "micro"]


def test_evaluator_threshold_sweep_csv_matches_jax(evaluated):
    """Every row within 1e-4 but the rows of edges k/256 that a pixel
    straddles: its probability lands in bucket k on one side and k − 1 on
    the other (f32 convolutions summed in two orders move probabilities by
    up to about 2e-6).  Every straddling pixel lies within 1e-6 of its
    edge, and one such pixel shifts its row's recall by 1/positives
    (1.5e-4 here), so those rows are held within 1e-3.  Measured at this
    seed: FPN 26 pixels within 1e-6 of an edge, 4 of them straddling 4
    edges, |Δp| ≤ 1.8e-6; ResUNet 28 and none, |Δp| ≤ 5.7e-7."""
    run = evaluated["run"]
    got = np.asarray(_read_csv(run / "port" / "sweep.csv")[1:], float)
    want = np.asarray(_read_csv(run / "jax" / "sweep.csv")[1:], float)
    assert got.shape == want.shape == (BINS + 1, 7)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    p, q = evaluated["p"], evaluated["q"]
    bp, bq = (np.minimum((pr * BINS).astype(np.int64), BINS) for pr in (p, q))
    straddle = bp != bq
    near = _near_edges(p, q)
    assert not (straddle & ~near).any() and int(straddle.sum()) <= 8
    edges = {int(k) for lo, hi in zip(np.minimum(bp, bq)[straddle],
                                      np.maximum(bp, bq)[straddle])
             for k in range(lo + 1, hi + 1)}
    off_edge = np.asarray([k not in edges for k in range(BINS + 1)])
    np.testing.assert_allclose(got[off_edge], want[off_edge], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[~off_edge], want[~off_edge], rtol=0,
                               atol=1e-3)


def test_evaluator_histograms_match_jax_but_at_bucket_edges(evaluated):
    """The first batch through both sides' steps: the probabilities agree
    within 5e-6 and the histograms are equal except for pixels whose
    probability lies within 1e-6 of an edge k/256, each of which may move
    one count between two buckets."""
    ours, ref, ds = evaluated["ours"], evaluated["ref"], evaluated["ds"]
    images = np.stack([ds[i][0] for i in range(4)])
    masks = np.stack([ds[i][1] for i in range(4)])
    valid = np.array([True, True, True, False])
    got = ours._step(torch.from_numpy(images), torch.from_numpy(masks),
                     torch.from_numpy(valid))[-1].numpy()
    want = np.asarray(ref._step(ref.state, jnp.asarray(images),
                                jnp.asarray(masks), jnp.asarray(valid))[-1])
    p, q = evaluated["p"][:4], evaluated["q"][:4]
    np.testing.assert_allclose(p, q, rtol=0, atol=5e-6)
    near = _near_edges(p, q)
    near &= valid[:, None, None]
    assert int(np.abs(got - want).sum()) <= 2 * int(near.sum())
    assert got.sum() == want.sum() == 3 * SIZE * SIZE


def test_predict_step_matches_jax(evaluated):
    """``make_predict_step``: the objective's hard labels, equal to the JAX
    step's but where |p − 0.5| < 1e-5."""
    ours, ref, ds = evaluated["ours"], evaluated["ref"], evaluated["ds"]
    images = np.stack([ds[i][0] for i in range(3)])
    got = make_predict_step(ours.model, SIZE, make_objective(ours.cfg))(
        torch.from_numpy(images)).numpy()
    want = np.asarray(jax_make_predict_step(
        ref.model, SIZE, jax_make_objective(ref.cfg))(
        ref.state, jnp.asarray(images)))
    assert got.shape == want.shape == (3, SIZE, SIZE)
    p = evaluated["p"][:3]
    differ = got != want
    assert not differ.any() or np.abs(p[differ] - 0.5).max() < 1e-5


# -- the CLI -----------------------------------------------------------------

def test_cli_test_writes_figures_and_csvs(test_split, tmp_path):
    _write_best_pth("unet", tmp_path / "pth", seed=32)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_raw_cfg("unet", test_split)))
    out = tmp_path / "out"
    result = cli_test.main(["--config", str(cfg_path), "--save_path",
                            str(out), "--pth_path",
                            str(tmp_path / "pth" / "best.pth"),
                            "--max_figures", "3", "--device", "cpu"])
    assert result["n_figures"] == 3
    assert sorted(p.name for p in (out / "figure").iterdir()) == [
        f"figure_{i}.png" for i in (1, 2, 3)]
    assert len(_read_csv(out / "metrics.csv")) == 1 + 10 + 2
    assert len(_read_csv(out / "threshold_sweep.csv")) == 1 + BINS + 1
    assert 0.0 <= result["test_score"] <= 1.0
    assert {"best_threshold", "best_dice", "dice_at_0.5"} <= set(result)


def test_cli_test_without_a_checkpoint_raises(test_split, tmp_path):
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_raw_cfg("fpn", test_split)))
    for missing in (tmp_path / "nowhere", tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            cli_test.main(["--config", str(cfg_path), "--save_path",
                           str(tmp_path / "out"), "--pth_path", str(missing),
                           "--device", "cpu"])


def test_resolve_pth_prefers_best_then_latest(tmp_path):
    (tmp_path / "latest.pth").write_bytes(b"")
    assert resolve_pth(str(tmp_path)) == str(tmp_path / "latest.pth")
    (tmp_path / "best.pth").write_bytes(b"")
    assert resolve_pth(str(tmp_path)) == str(tmp_path / "best.pth")
    assert resolve_pth(str(tmp_path / "latest.pth")) == str(
        tmp_path / "latest.pth")
    (tmp_path / "notes.txt").write_text("x")
    with pytest.raises(FileNotFoundError):
        resolve_pth(str(tmp_path / "notes.txt"))

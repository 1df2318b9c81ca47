"""``cli.train`` and ``cli.test`` on three classes (BASELINE.json config
#2's multi-class regions with ``stain: macenko``) in the PyTorch port, on
the CPU at 64², f32.

``cli.train`` on 3-class patches with ``stain: macenko`` and ``loss:
dice_ce`` with class weights, two epochs; then ``cli.test`` on its
``best.pth`` against the JAX ``Evaluator``: scores, the per-class metrics
and ``metrics.csv`` within 1e-4, and no threshold sweep.
"""

import csv
import math

import numpy as np
import pytest
import yaml

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.data.discovery import (
    discover_split as jax_discover_split,
)
from pdac_pathological_image_segmentation_tpu.data.loader import (
    PatchDataset as JaxPatchDataset,
)
from pdac_pathological_image_segmentation_tpu.infer.evaluate import (
    Evaluator as JaxEvaluator,
)
from pdac_pathological_image_segmentation_tpu.parallel.mesh import (
    create_mesh,
)
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    test as cli_test,
    train as cli_train,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.metrics import (
    METRIC_NAMES,
)

from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    SIZE,
    one_torch_thread,
    write_class_patches,
)

NC = 3
WEIGHTS = [1.0, 2.0, 2.0]


# -- cli.train, then cli.test against the JAX Evaluator ------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("three_class")
    for split, n, seed in (("train", 8, 0), ("val", 4, 1), ("test", 6, 2)):
        write_class_patches(root / split, n, seed)
    raw = {"train_path": str(root / "train"), "val_path": str(root / "val"),
           "test_path": str(root / "test"), "model": "unet",
           "img_size": SIZE, "batch_size": 4, "epochs": 2, "lr": 1e-3,
           "seed": 41, "num_worker": 2, "compute_dtype": "float32",
           "num_classes": NC, "stain": "macenko", "loss": "dice_ce",
           "class_weights": WEIGHTS, "num_devices": 1}
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    result = cli_train.main(["--config", str(cfg_path), "--save_path",
                             str(root / "out"), "--device", "cpu"])
    return root, raw, cfg_path, result


def test_cli_train_three_classes_with_macenko(trained):
    root, _, _, result = trained
    assert [h["epoch"] for h in result["history"]] == [0, 1]
    assert all(math.isfinite(h["train_loss"]) and 0 <= h["val_score"] <= 1
               for h in result["history"])
    assert (root / "out" / "pth" / "best.pth").is_file()


def test_cli_test_three_classes_matches_jax_evaluator(trained):
    root, raw, cfg_path, _ = trained
    got = cli_test.main(["--config", str(cfg_path), "--save_path",
                         str(root / "eval"), "--pth_path",
                         str(root / "out" / "pth"), "--device", "cpu",
                         "--max_figures", "0"])
    ref = JaxEvaluator(JaxConfig.from_dict(raw),
                       str(root / "out" / "pth" / "best.pth"),
                       mesh=create_mesh(1))
    jds = JaxPatchDataset(*jax_discover_split(str(root / "test")),
                          JaxConfig.from_dict(raw))
    want = ref.run(jds, metrics_csv=str(root / "jax" / "metrics.csv"),
                   verbose=False)
    assert got["n_samples"] == want["n_samples"] == 6
    for k in ("test_score", "test_loss"):
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    for k in METRIC_NAMES:
        assert abs(got["metrics"][k] - want["metrics"][k]) < 1e-4, k
    assert "best_threshold" not in got and "best_threshold" not in want
    assert not (root / "eval" / "threshold_sweep.csv").exists()
    with open(root / "eval" / "metrics.csv") as f:
        ours = list(csv.reader(f))
    with open(root / "jax" / "metrics.csv") as f:
        theirs = list(csv.reader(f))
    assert ours[0] == theirs[0] and "dice_c2" in ours[0]
    assert len(ours) == len(theirs) == 6 + 3
    for g, w in zip(ours[1:], theirs[1:]):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(np.asarray(g[2:], float),
                                   np.asarray(w[2:], float), rtol=0,
                                   atol=1e-4, err_msg=g[0])

"""``cli.train`` and the ``Trainer`` over data-parallel ranks on the CPU
(gloo ranks spawned by ``tests/torch_dist_worker.py``, or by ``cli.train``
itself), mirroring ``tests/test_multihost.py``: under an existing group of
2 ranks, 2 epochs then a resume, the same metrics on both ranks, the
scalar writer and the checkpoint saver on the chief only, a
``Diagnostics/GNS`` row; ``num_devices: 2`` spawning its ranks; one rank's
GNS is NaN and not logged; ``num_devices`` must equal a launcher's world
size.
"""

import math

import numpy as np
import pytest
import torch
import yaml

from pdac_pathological_image_segmentation_tpu_torch.cli import (
    train as cli_train,
)
from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    generate_synthetic_patches,
)
from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
from pdac_pathological_image_segmentation_tpu_torch.train.loop import TAGS

import torch_dist_worker as worker

SIZE = 64
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Each rank on one intra-op thread (``cli.train`` hands its spawned
    CPU ranks the caller's threads, divided among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- the trainer and the CLI --------------------------------------------------

@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_patches")
    for split, n, seed in (("train", 16, 0), ("val", 8, 1)):
        generate_synthetic_patches(str(root / split), n=n, size=SIZE,
                                   seed=seed)
    return root


def _config(path, patches, epochs, **extra):
    raw = {"train_path": str(patches / "train"),
           "val_path": str(patches / "val"), "model": "fpn",
           "img_size": SIZE, "batch_size": 8, "epochs": epochs, "lr": LR,
           "num_worker": 2, "compute_dtype": "float32", "gns_every": 1,
           **extra}
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _rows(save):
    return [line.split(",") for line in
            (save / "log_dir" / "scalars.csv").read_text().splitlines()]


def test_cli_train_in_a_two_rank_group(patches, tmp_path):
    """The launcher path: ranks that joined a group run ``cli.train``: the
    same history on both, the writer and the saver on rank 0 only, a
    ``Diagnostics/GNS`` row at each epoch whose estimate is finite (the
    first one is; the estimate of G² can come out negative on a small
    batch, and then, as in the JAX trainer, no row), and a resume to a
    third epoch."""
    save = tmp_path / "out"
    first = _config(tmp_path / "two.yaml", patches, 2, num_devices=2)
    again = _config(tmp_path / "three.yaml", patches, 3)
    ranks = worker.run_ranks(2, tmp_path / "rdzv", [
        ("train_case", {"config": first, "save_path": str(save)}),
        ("train_case", {"config": again, "save_path": str(save)})])
    for run in (0, 1):
        a, b = ranks[0][run], ranks[1][run]
        keys = ("train_loss", "train_score", "val_loss", "val_score", "lr",
                "gns")
        np.testing.assert_array_equal(
            [[h[k] for k in keys] for h in a["history"]],
            [[h[k] for k in keys] for h in b["history"]])
        assert a["held"] == [(True, True)] and b["held"] == [(False, False)]
    assert [h["epoch"] for h in ranks[0][0]["history"]] == [0, 1]
    assert [h["epoch"] for h in ranks[0][1]["history"]] == [2]
    history = ranks[0][0]["history"] + ranks[0][1]["history"]
    assert math.isfinite(history[0]["gns"])
    rows = _rows(save)
    assert [int(r[0]) for r in rows if r[1] == "Diagnostics/GNS"] == [
        h["epoch"] + 1 for h in history if math.isfinite(h["gns"])]
    assert len([r for r in rows if r[1] == "Loss/Train_Loss"]) == 3
    assert (save / "pth" / "latest.pth").exists()


def test_cli_train_spawns_num_devices_ranks(patches, tmp_path, capfd):
    """``num_devices: 2`` under ``--device cpu`` spawns two gloo ranks and
    returns rank 0's history; the chief printed the epoch once and wrote
    one row per tag, ``Diagnostics/GNS`` with the history's estimate."""
    save = tmp_path / "out"
    result = cli_train.main(["--config", _config(tmp_path / "a.yaml",
                                                 patches, 1, num_devices=2),
                             "--save_path", str(save), "--device", "cpu"])
    assert [h["epoch"] for h in result["history"]] == [0]
    first = result["history"][0]["gns"]
    assert math.isfinite(first)
    assert capfd.readouterr().out.count("epoch1: Train_score:") == 1
    rows = _rows(save)
    assert sorted(r[1] for r in rows) == sorted(TAGS + ("Diagnostics/GNS",))
    assert [float(r[2]) for r in rows if r[1] == "Diagnostics/GNS"] == [
        pytest.approx(first)]
    assert (save / "pth" / "latest.pth").exists()


def test_one_rank_gns_is_nan_and_not_logged(patches, tmp_path):
    """With one rank the estimate is NaN (b == B): no ``Diagnostics/GNS``
    row, as in the JAX trainer."""
    save = tmp_path / "out"
    result = cli_train.main(["--config", _config(tmp_path / "c.yaml",
                                                 patches, 1),
                             "--save_path", str(save), "--device", "cpu"])
    assert math.isnan(result["history"][0]["gns"])
    assert not [r for r in _rows(save) if r[1] == "Diagnostics/GNS"]


def test_num_devices_must_equal_the_launchers_world(patches, tmp_path,
                                                    monkeypatch):
    """Under a launcher (or in a group) ``num_devices`` is not a request
    for more ranks: one that differs from the world size raises."""
    monkeypatch.setattr(mesh, "launched", lambda: True)
    monkeypatch.setattr(mesh, "initialize_distributed", lambda **kw: None)
    cfg = _config(tmp_path / "d.yaml", patches, 1, num_devices=2)
    with pytest.raises(ValueError, match="world size is 1"):
        cli_train.main(["--config", cfg, "--save_path", str(tmp_path / "o"),
                        "--device", "cpu"])

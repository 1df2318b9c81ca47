"""The trainer's host side in the PyTorch port, on the CPU at 64².

* ``AsyncCheckpointSaver``: its files equal ``save_checkpoint``'s byte for
  byte, taken from the state at ``save()`` even when training moves on
  before the write lands; ``restore_checkpoint`` reads them back; a write
  that fails re-raises on ``wait()``.
* ``profile_epoch``: the epoch's trace lands in ``log_dir/profile``,
  ``device_op_summary`` returns its rows (CPU operators here: no card),
  the step times and top rows are printed; ``StepTimer`` is the JAX one.
* The scalar writer: ``scalars.csv`` always, TensorBoard events with the
  four tags where ``torch.utils.tensorboard`` imports, CSV alone where it
  does not.
* ``parity_mode`` trains (the parity chain) and its resume resets the best
  to 0, as the JAX trainer's does.
* The loader fills a batch larger than its split by wrapping around it
  (the JAX loader's batch would come out short of its ``valid``).
"""

import csv
import sys

import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.data.synthetic import (
    generate_synthetic_patches,
)
from pdac_pathological_image_segmentation_tpu.utils.profiling import (
    StepTimer as JaxStepTimer,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
    discover_split,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
    PatchLoader,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    AsyncCheckpointSaver,
    restore_checkpoint,
    save_checkpoint,
)
from pdac_pathological_image_segmentation_tpu_torch.train.loop import (
    TAGS,
    Trainer,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    make_optimizer,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    step_generator,
)
from pdac_pathological_image_segmentation_tpu_torch.utils import profiling
from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
    EarlyStop,
)

from torch_model_parity import one_torch_thread  # noqa: F401

SIZE = 64


SMALL = {"model": "pspnet", "backbone": "mobilenet_v2", "img_size": SIZE,
         "compute_dtype": "float32"}


def _small_model():
    """PSPNet on mobilenet_v2, the smallest of the registry's models: its
    files are 27 MB against ResUNet's 160, and these tests write many."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_model(Config.from_dict(SMALL))


def _trained_model():
    """The small model and its Adam after one step."""
    model = _small_model().train()
    opt = make_optimizer(model, 1e-3)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 3, SIZE, SIZE), np.float32))
    model(x, step_generator(0, 0, 0)).square().mean().backward()
    opt.step()
    return model, opt


META = (3, 0.625, {"lr": 1e-3, "best": 0.625, "num_bad_epochs": 1})


def test_async_saver_writes_the_inline_bytes_from_the_saved_state(tmp_path):
    model, opt = _trained_model()
    es = EarlyStop().state_dict()
    save_checkpoint(str(tmp_path / "inline"), model, opt, *META, es, True)
    saver = AsyncCheckpointSaver()
    saver.save(str(tmp_path / "async"), model, opt, *META, es, True)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():  # training moves on before the write lands
        for p in model.parameters():
            p.add_(1.0)
    saver.wait()
    for name in ("latest.pth", "best.pth"):
        assert ((tmp_path / "async" / name).read_bytes()
                == (tmp_path / "inline" / name).read_bytes()), name
    fresh = _small_model()
    fresh_opt = make_optimizer(fresh, 1e-3)
    meta = restore_checkpoint(str(tmp_path / "async"), fresh, fresh_opt)
    assert meta["epoch"] == 3 and meta["previous_best"] == 0.625
    assert meta["scheduler"]["num_bad_epochs"] == 1
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]), k
    # a save in flight is joined by the next one
    saver.save(str(tmp_path / "again"), model, opt, *META, es, False)
    saver.save(str(tmp_path / "again"), model, opt, 4, *META[1:], es, False)
    saver.wait()
    assert torch.load(tmp_path / "again" / "latest.pth",
                      weights_only=True)["epoch"] == 4
    assert not (tmp_path / "again" / "best.pth").exists()


def test_async_saver_reraises_a_failed_write_on_wait(tmp_path):
    model, opt = _trained_model()
    blocked = tmp_path / "a_file"
    blocked.write_text("not a directory")
    saver = AsyncCheckpointSaver()
    saver.save(str(blocked), model, opt, *META, EarlyStop().state_dict(),
               False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.wait()  # reported once


def test_step_timer_is_the_jax_one(monkeypatch):
    clock = iter([0.0, 0.010, 1.0, 1.030, 2.0, 2.020])
    ticks = [next(clock) for _ in range(6)]
    timers = [profiling.StepTimer(), JaxStepTimer()]
    for timer in timers:
        it = iter(ticks)
        monkeypatch.setattr("time.perf_counter", lambda: next(it))
        for _ in range(3):
            timer.start()
            timer.stop()
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].summary()["steps"] == 3
    timers[0].reset()
    assert timers[0].summary() == {}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("patches")
    for split, n, seed in (("train", 8, 0), ("val", 4, 1)):
        generate_synthetic_patches(str(root / split), n=n, size=SIZE,
                                   seed=seed)
    return root


def _trainer(data_root, out, **extra):
    cfg = Config.from_dict({**SMALL, "batch_size": 4, "lr": 1e-3,
                            "num_worker": 2, **extra})
    ds = [PatchDataset(*discover_split(str(data_root / s)), cfg)
          for s in ("train", "val")]
    return Trainer(cfg, str(out), *ds, device="cpu")


def _csv_rows(out):
    with open(out / "log_dir" / "scalars.csv") as f:
        return list(csv.reader(f))


def test_profile_epoch_writes_a_trace_and_prints_its_summary(
        data_root, tmp_path, capsys):
    result = _trainer(data_root, tmp_path, epochs=2, profile_epoch=1).train()
    printed = capsys.readouterr().out
    traces = list((tmp_path / "log_dir" / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    rows = profiling.device_op_summary(str(tmp_path / "log_dir" / "profile"),
                                       top=5)
    assert len(rows) == 5 and all(us > 0 for us, _, _ in rows)
    assert any(name.startswith("aten::") for _, name, _ in rows)
    assert "profile of epoch 1: step times" in printed
    assert f"{rows[0][0] / 1e3:10.3f} ms  {rows[0][1]}" in printed
    assert result["history"][1]["step_time"]["steps"] == 2


def test_device_op_summary_takes_kernel_events_and_gzip(tmp_path):
    """A trace with device kernels sums those alone, by name, the largest
    first; a gzipped trace reads the same; no trace gives no rows."""
    import gzip
    import json

    events = [{"ph": "X", "cat": "kernel", "name": "gn_fwd_cluster",
               "dur": 5.0},
              {"ph": "X", "cat": "kernel", "name": "gn_fwd_cluster",
               "dur": 7.0},
              {"ph": "X", "cat": "kernel", "name": "augment_out_kernel",
               "dur": 3.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 99.0}]
    with gzip.open(tmp_path / "t.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert profiling.device_op_summary(str(tmp_path)) == [
        (12.0, "gn_fwd_cluster", "gn_fwd_cluster"),
        (3.0, "augment_out_kernel", "augment_out_kernel")]
    assert profiling.device_op_summary(str(tmp_path / "none")) == []


def test_scalars_go_to_csv_and_tensorboard(data_root, tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    _trainer(data_root, tmp_path, epochs=1).train()
    rows = _csv_rows(tmp_path)
    assert sorted(r[1] for r in rows) == sorted(TAGS)
    acc = EventAccumulator(str(tmp_path / "log_dir"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == sorted(TAGS)
    for r in rows:
        (event,) = acc.Scalars(r[1])
        assert event.step == 1 and abs(event.value - float(r[2])) < 1e-6


def test_scalars_go_to_csv_alone_without_tensorboard(data_root, tmp_path,
                                                     monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _trainer(data_root, tmp_path, epochs=1).train()
    assert sorted(r[1] for r in _csv_rows(tmp_path)) == sorted(TAGS)
    assert not list((tmp_path / "log_dir").glob("events.out.tfevents.*"))


def test_parity_mode_trains_and_its_resume_resets_the_best(data_root,
                                                          tmp_path, capsys):
    first = _trainer(data_root, tmp_path, epochs=1, parity_mode=True).train()
    assert first["best_val_score"] > 0
    capsys.readouterr()
    second = _trainer(data_root, tmp_path, epochs=2, parity_mode=True).train()
    assert "resumed from epoch 0, best=0.0000" in capsys.readouterr().out
    assert [h["epoch"] for h in second["history"]] == [1]
    assert second["best_val_score"] == second["history"][0]["val_score"]


def test_a_batch_larger_than_the_split_wraps_around_it(data_root):
    """4 val patches at batch 10: one batch of 10, the split's 4 first
    (valid) and then the split again from its start, cyclically; the same
    rule as a final partial batch of a larger split."""
    cfg = Config(img_size=SIZE, seed=7)
    loader = PatchLoader(PatchDataset(*discover_split(str(data_root / "val")),
                                      cfg), 10, shuffle=False, device="cpu",
                         num_workers=1)
    (batch,) = list(loader.epoch(0))
    assert tuple(batch.image.shape) == (10, SIZE, SIZE, 3)
    assert batch.valid.tolist() == [True] * 4 + [False] * 6
    order = [0, 1, 2, 3] * 3
    for i in range(10):
        assert torch.equal(batch.image[i], batch.image[order[i]]), i

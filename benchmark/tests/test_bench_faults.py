"""Each fault a cell can have, planted underneath the timed path, turns the
run's ``correct`` false; the same run without it is correct.  The runs
skip the harness's look for a card and run on the CPU at small sizes,
with the cells' own limits; train cells in float32, where the sound run
follows the reference to rounding."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import small_cell

PKG = "pdac_pathological_image_segmentation_tpu_torch"
SLIDES = ["fpn_r18.slide_bf16", "fpn_r18.slide_int8"]
TRAINS = ["resunet_r18.train_b128", "fpn_r18.train_b128"]


def run(cell):
    return harness.driver(cell.traffic).run(cell)


def _shift_logits(step, by: float):
    def altered(images):
        p = step(images).clamp(1e-6, 1 - 1e-6)
        return torch.sigmoid(torch.log(p) - torch.log1p(-p) + by)
    return altered


def plant_slide_answer_altered(monkeypatch):
    """Every window's logits shifted by 1 where the step produces them."""
    from pdac_pathological_image_segmentation_tpu_torch.infer import wsi

    init = wsi.BandedSlidingWindow.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        self._infer = _shift_logits(self._infer, 1.0)

    monkeypatch.setattr(wsi.BandedSlidingWindow, "__init__", patched)


def plant_slide_half_batch(monkeypatch):
    """Half of each batch's windows never stitched."""
    from pdac_pathological_image_segmentation_tpu_torch.infer import wsi

    batches = wsi.BandedSlidingWindow._band_prob_batches

    def patched(self, *a, **k):
        for out, local in batches(self, *a, **k):
            half = max(1, len(local) // 2)
            yield out[:half], local[:half]

    monkeypatch.setattr(wsi.BandedSlidingWindow, "_band_prob_batches",
                        patched)


def plant_train_state_unchanged(monkeypatch):
    """The optimizer's step leaves the parameters and its state as they
    were."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def plant_train_half_batch(monkeypatch):
    """The loss over the first half of the batch, the mean over it."""
    from pdac_pathological_image_segmentation_tpu_torch.train import (
        objective,
    )

    whole = objective.binary_dice_loss

    def half(logits, masks, valid=None, reduce=None):
        n = logits.shape[0] // 2
        return whole(logits[:n], masks[:n],
                     None if valid is None else valid[:n], reduce)

    monkeypatch.setattr(objective, "binary_dice_loss", half)


def plant_train_answer_altered(monkeypatch):
    """The logits shifted by 1 where the model produces them."""
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        fpn,
        resunet,
    )

    for cls in (fpn.FPN, resunet.ResUNet):
        forward = cls.forward
        monkeypatch.setattr(
            cls, "forward",
            lambda self, x, generator=None, f=forward: f(self, x,
                                                         generator) + 1.0)


@pytest.mark.parametrize("workload", SLIDES)
@pytest.mark.parametrize("plant", [None, plant_slide_answer_altered,
                                   plant_slide_half_batch])
def test_slide_faults(monkeypatch, workload, plant):
    if plant is not None:
        plant(monkeypatch)
    out = run(small_cell(workload, seed=2 ** 32 + 17))
    assert out.correct is (plant is None), out.checks
    assert out.failed == (0 if plant is None else out.attempted)


@pytest.mark.parametrize("workload", TRAINS)
@pytest.mark.parametrize("plant", [None, plant_train_state_unchanged,
                                   plant_train_half_batch,
                                   plant_train_answer_altered])
def test_train_faults(monkeypatch, workload, plant):
    if plant is not None:
        plant(monkeypatch)
    out = run(small_cell(workload, seed=2 ** 32 + 19, dtype="float32"))
    assert out.correct is (plant is None), out.checks


def plant_int8_scales_halved(monkeypatch):
    """The int8 step's activation scales at half of what calibration
    measured, so the largest activations clip."""
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized,
    )

    calibrate = quantized.calibrate
    monkeypatch.setattr(quantized, "calibrate", lambda *a, **k: {
        site: s / 2 for site, s in calibrate(*a, **k).items()})


def test_int8_calibration_fault(monkeypatch):
    plant_int8_scales_halved(monkeypatch)
    out = run(small_cell("fpn_r18.slide_int8", seed=2 ** 32 + 17))
    assert not out.correct, out.checks

"""The plain reference against the program on the CPU at small sizes."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.reference import models
from benchmark.reference import slide as ref_slide
from benchmark.tests.conftest import configs, small_cell


@pytest.mark.parametrize("name", ["fpn_r18", "resunet_r18"])
def test_forward_matches_the_program_in_float32(name):
    """The program's tile→mask step (normalize folded into the stem) and
    the plain model give the same probabilities on the same weights."""
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_infer_step,
    )

    cfg = dict(configs()[name], img_size=64, compute_dtype="float32")
    sd = harness.weights(cfg, 11, "cpu")
    _, model = harness.program_model(cfg, sd, "cpu")
    windows = torch.stack([ref_slide.field(y, 64, 64, 64, 5, "cpu")
                           for y in (0, 96, 640)])
    got = make_infer_step(model, 64)(windows)
    ref = harness.reference_model(cfg, sd, "cpu").eval()
    with torch.no_grad():
        want = torch.sigmoid(ref(models.normalize_u8(windows))[:, 0])
    assert got.shape == want.shape == (3, 64, 64)
    # float32 rounding through some twenty layers: the folded normalize
    # is exact in real arithmetic, not in float32 (seen: 1.7e-5)
    assert float((got - want).abs().max()) < 1e-4


def test_field_is_the_programs_slide():
    from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
        DeviceSlideSource,
    )

    src = DeviceSlideSource(1024, tile=64, stride=32, seed=9041, device="cpu")
    assert torch.equal(src.read_region(320, 96, 200, 300),
                       ref_slide.field(320, 96, 200, 300, 9041, "cpu"))


@pytest.mark.parametrize("workload", ["fpn_r18.slide_bf16",
                                      "fpn_r18.slide_int8"])
def test_slide_cell_is_correct(workload):
    """A whole small slide through the program's runner, band carry-over
    included, passes the cell's own limits."""
    cell = small_cell(workload, seed=2 ** 31 + 3)
    out = harness.driver(cell.traffic).run(cell)
    assert out.correct, out.checks
    assert [c[0] for c in out.checks] == list(cell.limits["limits"])
    assert out.attempted == 1 and out.work["windows"] == 11 ** 2


@pytest.mark.parametrize("workload", ["resunet_r18.train_b128",
                                      "fpn_r18.train_b128"])
def test_train_steps_match_the_reference_in_float32(workload):
    """The program's steps in float32 (the non-fused augmentation on the
    same draws) follow the plain reference to rounding: augmentation
    draws and geometry, dropout, Dice, backward and Adam."""
    cell = small_cell(workload, seed=2 ** 33 + 1, dtype="float32")
    assert harness.driver(cell.traffic).run(cell).correct
    tools = harness.load_module(harness.HERE / "tools" / "limits.py",
                                "bench_tools_limits")
    got = next(r for r in tools.train_readings(cell, cell.seed)
               if r["side"] == "program")
    assert got["loss_gap"] < 1e-5
    assert got["grad_diff_median"] < 1e-4
    assert got["change_gap_median"] < 1e-3

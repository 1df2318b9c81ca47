"""Each cell's control fails the cell's own limits: the plain reference put
in the program's place one precision below the configuration's (fp8 below
bf16, int4 below int8).  At the CPU's sizes here; at the cell's own sizes
on a card (marked ``chip``), where the limits were read."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import small_cell

SLIDES = ["fpn_r18.slide_bf16", "fpn_r18.slide_int8"]
TRAINS = ["resunet_r18.train_b128", "fpn_r18.train_b128"]


def _tools():
    return harness.load_module(harness.HERE / "tools" / "limits.py",
                               "bench_tools_limits")


def _fails(cell, readings: dict) -> bool:
    _, failed = harness.judge(cell.limits, [readings])
    return failed == 1


def _slide_control(cell, seed):
    drv = harness.driver(cell.traffic)
    tr, dev = cell.traffic, torch.device(cell.device)
    sd = harness.weights(cell.config, seed, dev)
    slides = [(None, drv.field_seed(seed, 0), drv.check_blocks(tr, seed, 0))]
    return drv.reference_readings(cell, sd, dev, slides,
                                  cell.limits["mask_margin_logit"], True)[0]


@pytest.mark.parametrize("workload", SLIDES)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 2 ** 40 + 5])
def test_slide_control_fails(workload, seed):
    cell = small_cell(workload, seed)
    assert _fails(cell, _slide_control(cell, seed))


@pytest.mark.parametrize("workload", TRAINS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 2 ** 40 + 5])
def test_train_control_fails(workload, seed):
    cell = small_cell(workload, seed)
    rows = _tools().train_readings(cell, seed)
    control = next(r for r in rows if r["side"] == "control_fp8")
    assert _fails(cell, control)


@pytest.mark.chip
@pytest.mark.parametrize("workload", SLIDES + TRAINS)
def test_control_fails_at_the_cells_size(card, workload):
    cell = harness.cell(harness.benchmark(), workload, 0, 0.0, False)
    tools = _tools()
    read = (tools.slide_readings if cell.traffic["driver"] == "slide"
            else tools.train_readings)
    rows = read(cell, 2 ** 31 + 101)
    control = next(r for r in rows if r["side"].startswith("control"))
    assert _fails(cell, control)

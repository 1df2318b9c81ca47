"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``): cells of the benchmark's configurations and traffic
cut to sizes the CPU runs in seconds, with the cells' own limits."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness

BENCH = harness.benchmark()
# the traffic's sizes cut for the CPU: a 384² slide of 64² windows, and
# batches of 4 64² patches; everything else as the cell has it
SMALL = {
    "slide": dict(slide_side=384, tile=64, stride=32, batch=8, band_rows=128,
                  check_block=32, check_blocks=10, calibration_windows=4),
    "train": dict(batch=4, tile=64, patches=16, make_chunk=8, trace_steps=2),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small_cell(workload: str, seed: int = 7, *, dtype: str | None = None,
               trace: bool = False, limits: dict | None = None):
    """The workload's cell at the CPU's sizes: ``dtype`` sets the
    configuration's compute dtype."""
    cell = harness.cell(BENCH, workload, seed, 0.01, trace)
    cell.device = "cpu"
    cell.traffic = dict(cell.traffic, **SMALL[cell.traffic["driver"]])
    cell.config = dict(cell.config, img_size=cell.traffic["tile"])
    if dtype:
        cell.config["compute_dtype"] = dtype
    if limits is not None:
        cell.limits = limits
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(4)
    yield


def configs() -> dict:
    return {c["name"]: json.loads((harness.ROOT / c["file"]).read_text())
            for c in BENCH["configs"]}


def workloads(driver: str) -> list:
    """The names of ``BENCHMARK.json``'s cells whose traffic runs
    ``driver``, in its order."""
    return [w["name"] for w in BENCH["workloads"]
            if harness.read_json(harness.HERE / "traffic"
                                 / f"{w['traffic']}.json")["driver"] == driver]

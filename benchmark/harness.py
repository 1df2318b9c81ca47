"""What every driver shares: the cell, its files, the program's model and
the comparison against limits.

A cell is found by name: ``BENCHMARK.json`` names its configuration and
traffic; ``configs/<config>.json`` holds the sizes (and may name its plain
reference module, ``reference/models.py::build``), ``traffic/<mix>.json``
the parameters and the driver (``drivers/<driver>.py``), and
``limits/<workload>.json`` the limit of each number the check compares.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pdac_pathological_image_segmentation_tpu")
# keys of a configuration file that the program reads from ``Config.extras``
PROGRAM_EXTRAS = ("loss",)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: ``e2e`` end-to-end values by metric name,
    ``work`` the counts the per-layer readers need, ``checks`` ``[(name,
    value, limit)]`` (a number passes at or under its limit)."""

    attempted: int
    failed: int
    e2e: dict
    work: dict
    checks: list
    peak_bytes: int
    trace: dict | None = None

    @property
    def correct(self) -> bool:
        return all(value <= limit for _, value, limit in self.checks)


def judge(limits: dict, readings: list) -> tuple:
    """``(checks, failed)`` of the readings of each unit checked (a slide,
    a run of steps): each number of ``limits["limits"]`` at its worst over
    the units beside its limit, and the units with a number beyond its
    limit."""
    bounds = limits["limits"]
    failed = sum(any(r[k] > v for k, v in bounds.items()) for r in readings)
    return [(k, max(r[k] for r in readings), v)
            for k, v in bounds.items()], failed


def log(cell: Cell, what: str) -> None:
    """A line on standard error, stamped with the seconds since the run
    started."""
    print(f"[{time.perf_counter() - cell.t_start:8.3f} s] {what}",
          file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str, seed: int, seconds: float,
         trace: bool, here: Path = HERE) -> Cell:
    """The cell named ``workload`` with its files read."""
    work = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if work is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = read_json(here.parent / conf["file"])
    if "reference" in config:
        config["reference"] = str(here.parent / config["reference"])
    return Cell(name=workload, config=config,
                traffic=read_json(here / "traffic" / f"{work['traffic']}.json"),
                limits=read_json(here / "limits" / f"{workload}.json"),
                seed=seed, seconds=seconds, trace=trace)


def driver(traffic: dict, here: Path = HERE):
    name = traffic["driver"]
    return load_module(here / "drivers" / f"{name}.py", f"bench_driver_{name}")


def forbidden_modules(modules) -> list:
    """Names in ``modules`` whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def program_model(cfg: dict, state_dict: dict, device):
    """The program's model of ``cfg`` on ``device`` with ``state_dict``
    loaded (every name checked), built without initializing weights."""
    import torch

    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )

    pcfg = program_config(cfg)
    with torch.device("meta"):
        model = build_model(pcfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict)
    return pcfg, model


def program_config(cfg: dict):
    """The program's ``Config`` of a configuration file's dict: every key
    that names one of its fields, and those of :data:`PROGRAM_EXTRAS`."""
    from pdac_pathological_image_segmentation_tpu_torch import Config

    fields = {f.name for f in dataclasses.fields(Config)} - {"extras"}
    return Config.from_dict({k: v for k, v in cfg.items()
                             if k in fields or k in PROGRAM_EXTRAS})


def reference_model(cfg: dict, state_dict: dict, device):
    """The plain float32 model with ``state_dict``, TF32 off."""
    import torch

    from benchmark.reference import models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = models.build(cfg).to(device)
    model.load_state_dict(state_dict)
    return model


def meta_reference(cfg: dict):
    import torch

    from benchmark.reference import models

    with torch.device("meta"):
        return models.build(cfg)


def weights(cfg: dict, seed: int, device) -> dict:
    from benchmark.weights import seeded_state_dict

    return seeded_state_dict(meta_reference(cfg), seed, device)


def sub_seed(seed: int, *parts: int) -> int:
    """A 62-bit seed from ``seed`` and ``parts`` (SeedSequence)."""
    import numpy as np

    state = np.random.SeedSequence([int(seed) % 2 ** 64,
                                    *parts]).generate_state(2)
    return (int(state[0]) << 30 ^ int(state[1])) % 2 ** 62

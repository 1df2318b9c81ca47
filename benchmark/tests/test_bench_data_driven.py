"""A configuration, a traffic mix, a per-layer metric and an architecture's
plain reference dropped in as new files with new entries in
``BENCHMARK.json`` are found by name and run, with no edit to a file the
benchmark already has."""

from __future__ import annotations

import hashlib
import json
import shutil

from benchmark import harness
from benchmark.reference import models
from benchmark.tests.conftest import SMALL

READER = '''
def read(summary):
    steps = summary["work"].get("steps")
    return None if not steps else 100.0 * steps / (steps + 1)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    return root


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = _checkout(tmp_path)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())

    here = root / "benchmark"
    cfg = json.loads((here / "configs" / "resunet_r18.json").read_text())
    (here / "configs" / "resunet_r18_b.json").write_text(
        json.dumps(dict(cfg, name="resunet_r18_b", img_size=64)))
    mix = json.loads((here / "traffic" / "train_b128.json").read_text())
    (here / "traffic" / "train_small.json").write_text(
        json.dumps(dict(mix, **SMALL["train"])))
    (here / "metrics" / "steps_share.train.py").write_text(READER)
    limits = json.loads(
        (here / "limits" / "resunet_r18.train_b128.json").read_text())
    (here / "limits" / "resunet_r18_b.train_small.json").write_text(
        json.dumps(limits))
    bench["configs"].append(dict(bench["configs"][1], name="resunet_r18_b",
                                 file="benchmark/configs/resunet_r18_b.json"))
    bench["workloads"].append({"name": "resunet_r18_b.train_small",
                               "config": "resunet_r18_b",
                               "traffic": "train_small", "chips": 1,
                               "why": "a cell added as data"})
    bench["per_layer"].append({"name": "steps_share.train", "unit": "%",
                               "better": "higher", "source": "program_span",
                               "layer": "train step",
                               "moves": "train_patches_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_patches_per_s":
            m["workloads"].append("resunet_r18_b.train_small")

    cell = harness.cell(bench, "resunet_r18_b.train_small", 5, 0.01, True,
                        here=here)
    assert cell.config["name"] == "resunet_r18_b"
    assert cell.traffic["batch"] == SMALL["train"]["batch"]
    cell.device = "cpu"
    cell.config["compute_dtype"] = "float32"
    out = harness.driver(cell.traffic, here=here).run(cell)
    assert out.correct, out.checks

    run = harness.load_module(here / "run.py", "run_copy")
    summary = dict(out.trace, work=out.work, config=cell.config,
                   traffic=cell.traffic)
    metrics = run.per_layer(bench, cell.name, summary, here)
    # the new reader, and the old ones that list no cells or list this one
    assert "steps_share.train" in metrics
    assert metrics["steps_share.train"]["unit"] == "%"
    assert "mfu.train" not in metrics  # lists its cells; not this one
    values = dict(out.e2e)
    assert set(run.end_to_end(bench, cell.name, values)) == {
        "train_patches_per_s", "setup_s"}

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


REFERENCE = '''
from benchmark.reference.models import FPN


class FPNByFile(FPN):
    """FPN's plain reference, reached through a configuration's file."""

    dropout_draws = 0

    def draw_dropout(self, n, g, device):
        type(self).dropout_draws += 1
        return super().draw_dropout(n, g, device)


MODEL = FPNByFile
'''


def test_a_reference_file_and_a_config_make_a_new_architecture(tmp_path):
    """An architecture's plain reference as a new module that a new
    configuration names: the small train cell runs through it, correct,
    with its dropout drawn by the model's own method."""
    root = _checkout(tmp_path)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())

    here = root / "benchmark"
    (here / "reference" / "fpn_by_file.py").write_text(REFERENCE)
    cfg = json.loads((here / "configs" / "fpn_r18.json").read_text())
    (here / "configs" / "fpn_by_file.json").write_text(json.dumps(dict(
        cfg, name="fpn_by_file",
        reference="benchmark/reference/fpn_by_file.py")))
    mix = json.loads((here / "traffic" / "train_b128.json").read_text())
    (here / "traffic" / "train_small.json").write_text(
        json.dumps(dict(mix, **SMALL["train"])))
    (here / "limits" / "fpn_by_file.train_small.json").write_text(
        (here / "limits" / "fpn_r18.train_b128.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="fpn_by_file",
                                 file="benchmark/configs/fpn_by_file.json"))
    bench["workloads"].append({"name": "fpn_by_file.train_small",
                               "config": "fpn_by_file",
                               "traffic": "train_small", "chips": 1,
                               "why": "an architecture added as files"})

    cell = harness.cell(bench, "fpn_by_file.train_small", 9, 0.01, False,
                        here=here)
    cell.device = "cpu"
    cell.config = dict(cell.config, img_size=cell.traffic["tile"],
                       compute_dtype="float32")
    arch = type(models.build(cell.config))
    assert arch.__name__ == "FPNByFile" and arch.dropout_draws == 0
    out = harness.driver(cell.traffic, here=here).run(cell)
    assert out.correct, out.checks
    assert arch.dropout_draws == cell.traffic["check_steps"]

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before

"""A configuration, a traffic mix and a per-layer metric dropped in as new
files with new entries in ``BENCHMARK.json`` are found by name and run,
with no edit to a file the benchmark already has."""

from __future__ import annotations

import hashlib
import json
import shutil

from benchmark import harness
from benchmark.tests.conftest import SMALL

READER = '''
def read(summary):
    steps = summary["work"].get("steps")
    return None if not steps else 100.0 * steps / (steps + 1)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
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

"""One run of one cell of the benchmark of the PyTorch port.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  It makes the cell's inputs and weights from ``--seed``, sets up and
warms the program (``setup_s``, from this process's start), measures for
``--seconds`` and checks what the window produced against the plain
reference.  With ``--trace 0`` it reports the cell's end-to-end metrics;
with ``--trace 1`` it profiles the window (or a bounded slice of it) and
reports the cell's per-layer metrics, each read by its own reader
(``metrics/<name>.py``).  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.  A run without the cards,
or whose process holds JAX or the JAX package once the window has closed,
prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches of the program's builds live at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))


def card_info() -> dict:
    """Name, power limit and clocks of card 0 from ``nvidia-smi``, where
    it answers."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout
        name, limit, sm, sm_max = (v.strip() for v in
                                   out.splitlines()[0].split(","))
        return {"power_limit": limit, "clocks_sm": sm, "clocks_max_sm": sm_max}
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return {}


def per_layer(bench: dict, workload: str, summary: dict, here: Path) -> dict:
    """The per-layer metrics of ``workload`` whose readers find something
    in ``summary``."""
    from benchmark import harness

    e2e = {m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])}
    out = {}
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (workload not in cells) if cells else (m["moves"] not in e2e):
            continue
        reader = harness.load_module(here / "metrics" / f"{m['name']}.py",
                                     "bench_metric_" + m["name"].replace(
                                         ".", "_"))
        value = reader.read(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(bench: dict, workload: str, values: dict) -> dict:
    out = {}
    for m in bench["end_to_end"]:
        if workload in m.get("workloads", [workload]):
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def result(bench: dict, cell, outcome, device: dict) -> dict:
    """The result line of a run (without printing it)."""
    here = ROOT / "benchmark"
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed}
    if cell.trace:
        summary = dict(outcome.trace, work=outcome.work, config=cell.config,
                       traffic=cell.traffic)
        line["metrics"] = per_layer(bench, cell.name, summary, here)
        device = dict(device, busy_s=outcome.trace["busy_s"],
                      window_s=outcome.trace["window_s"])
        line["device"] = device
        line["breakdown"] = outcome.trace["breakdown"]
    else:
        line["metrics"] = end_to_end(bench, cell.name, outcome.e2e)
        line["device"] = device
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in outcome.checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    bench = harness.benchmark(ROOT)
    cell = harness.cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace))
    cell.t_start = T_START
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell asks for {chips} card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, **card_info()}

    outcome = harness.driver(cell.traffic).run(cell)

    held = harness.forbidden_modules(sys.modules)
    if held:
        print(f"no result: the process holds {', '.join(held)}",
              file=sys.stderr)
        return 2
    device["memory_peak_bytes"] = outcome.peak_bytes
    line = result(bench, cell, outcome, device)
    for name, value, limit in outcome.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

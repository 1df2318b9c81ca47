"""A traced run of a slide cell, its window split by span.

    python3 benchmark/tools/spans.py --workload <slide cell> --seed <n> \\
        [--out split.json]

Runs the cell as ``run.py --trace 1`` does (the driver, its traced slide,
its check), with the trace summary's ``spans`` key added from the same
profiler events by :func:`benchmark.spans.summarize`, and prints one JSON
line: ``run.py``'s result line, the four readers of the runner's spans
(``metrics/{stitch,band_turn,batch_issue}_idle_share.slide.py``,
``metrics/padded_window_share.slide.py``), the split itself, the idle
outside every span and the share of the window's idle that the ``wsi.``
spans hold.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

READERS = ("stitch_idle_share.slide", "band_turn_idle_share.slide",
           "batch_issue_idle_share.slide", "padded_window_share.slide")
# The readers' ``per_layer`` entries as ``BENCHMARK.json`` would list them
# once ``benchmark/trace.py::summarize`` returns the split; this tool goes
# away with that edit.
PENDING = [{"name": name, "unit": "%", "better": "lower",
            "source": "device_trace", "layer": "WSI runner",
            "moves": "slide_s",
            "workloads": ["fpn_r18.slide_bf16", "fpn_r18.slide_int8"]}
           for name in READERS]


def traced_split(run, cell, device: dict) -> dict:
    """``run.py``'s result line of a traced run of ``cell`` (``run`` is
    ``run.py`` loaded), with the split and the runner's readers added."""
    from benchmark import harness, spans, trace

    def summary(self, top: int = 10) -> dict:
        events = self._prof.profiler.kineto_results.events()
        return dict(trace.summarize(events, top),
                    spans=spans.summarize(events))

    plain, trace.Trace.summary = trace.Trace.summary, summary
    try:
        outcome = harness.driver(cell.traffic).run(cell)
    finally:
        trace.Trace.summary = plain
    bench = harness.benchmark(ROOT)
    bench = dict(bench, per_layer=bench["per_layer"] + PENDING)
    line = run.result(bench, cell, outcome, device)
    split = outcome.trace["spans"]
    idle = outcome.trace["window_s"] - outcome.trace["busy_s"]
    line["spans"] = split
    line["idle_s"] = idle
    line["idle_outside_spans_s"] = idle - sum(v["idle_s"]
                                              for v in split.values())
    runner = sum(v["idle_s"] for k, v in split.items()
                 if k.startswith("wsi."))
    line["wsi_idle_cover"] = runner / idle if idle > 0 else None
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from benchmark import harness

    # run.py first: it points the kernels' build caches into the checkout
    run = harness.load_module(ROOT / "benchmark" / "run.py", "bench_run")
    import torch

    if not torch.cuda.is_available():
        print("no result: no card", file=sys.stderr)
        return 2
    cell = harness.cell(harness.benchmark(ROOT), args.workload, args.seed,
                        0.0, True)
    cell.t_start = run.T_START
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, **run.card_info()}
    text = json.dumps(traced_split(run, cell, device))
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

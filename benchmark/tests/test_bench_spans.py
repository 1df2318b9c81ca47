"""The window split by span (``benchmark/spans.py``) and the readers of the
runner's spans, on made-up events."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, spans, trace
from benchmark.tests.conftest import configs, small_cell
from benchmark.tests.test_bench_trace import CUDA, Event

T = 100  # the window opens at T: a span before it is not counted


def _window_events():
    """A window of 100 units on thread 1, spans nested and overlapping
    (``wsi.band.write`` opens before ``wsi.band.fetch`` closes), one span
    partly past the window's end, two spans on thread 2, an operator, an
    annotation's copy on the device, and four kernels."""
    a = dict(annotation=True)
    ev = [
        Event(trace.WINDOW, T, 100, **a),
        Event("wsi.plan", 10, 20, **a),  # warm-up, before the window
        Event("slide.run", T + 2, 88, **a),
        Event("wsi.plan", T + 2, 8, **a),
        Event("wsi.batch.cut", T + 10, 10, **a),
        Event("wsi.batch.infer", T + 20, 10, **a),
        Event("wsi.batch.stitch", T + 30, 20, **a),
        Event("aten::add_", T + 35, 5),
        Event("wsi.band.fetch", T + 50, 20, **a),
        Event("wsi.band.write", T + 65, 20, **a),
        Event("slide.keep", T + 90, 15, **a),
        Event("loader.read", T + 5, 35, thread=2, **a),
        Event("loader.read", T + 60, 20, thread=2, **a),
        Event("wsi.batch.stitch", T + 40, 10, CUDA, annotation=True),
    ]
    for s, e in ((12, 33), (45, 55), (60, 62), (88, 92)):
        ev.append(Event("k", T + s, e - s, CUDA))
    return ev


def test_calls_self_and_exact_idle():
    got = spans.summarize(_window_events())
    # (calls, host, self, idle) in units of 1e-9 s
    want = {
        "slide.run": (1, 88, 5, 3),  # children cover [2, 85]
        "wsi.plan": (1, 8, 8, 8),
        "wsi.batch.cut": (1, 10, 10, 2),  # the gap [0, 12] crosses into it
        "wsi.batch.infer": (1, 10, 10, 0),
        "wsi.batch.stitch": (1, 20, 20, 12),
        "wsi.band.fetch": (1, 20, 20, 8),  # gaps [55, 60] and [62, 65]
        "wsi.band.write": (1, 20, 20, 20),  # innermost from 65: [65, 85]
        "slide.keep": (1, 10, 10, 8),  # clipped at the window's end
        "loader.read": (2, 55, 55, 0),  # another thread
    }
    assert set(got) == set(want)
    for name, (calls, host, own, idle) in want.items():
        assert got[name] == pytest.approx({
            "calls": calls, "host_s": host / 1e9, "self_s": own / 1e9,
            "idle_s": idle / 1e9}), name


def test_the_spans_and_the_idle_outside_them_make_the_window_idle():
    """Σ idle_s + the idle outside every span = window_s − busy_s of the
    trace summary, on this file's window and on ``test_bench_trace.py``'s
    (a gap [0, 1] outside every span there)."""
    s = 1_000_000_000
    other = [
        Event(trace.WINDOW, 0, 10 * s, annotation=True),
        Event("slide.run", 0, 8 * s, annotation=True),
        Event("aten::copy_", 6 * s, 2 * s),
        Event("k1", 1 * s, 3 * s, CUDA),
        Event("k2", 2 * s, 3 * s, CUDA),
        Event("k1", 7 * s, 1 * s, CUDA),
    ]
    for events, outside in ((_window_events(), 2e-9), (other, 2.0)):
        whole = trace.summarize(events)
        idle = sum(v["idle_s"] for v in spans.summarize(events).values())
        assert idle + outside == pytest.approx(
            whole["window_s"] - whole["busy_s"])
    assert spans.summarize(other) == {"slide.run": {
        "calls": 1, "host_s": 8.0, "self_s": 8.0, "idle_s": 3.0}}


@pytest.mark.parametrize("seed", range(6))
def test_idle_matches_a_unit_by_unit_count(seed):
    """Random nested spans and kernels on a grid of 200 units: each
    span's ``idle_s`` equals the units in which no kernel runs and it is
    the latest-started open span, and ``self_s`` the units of it that no
    span inside it covers."""
    rng = np.random.default_rng(seed)
    n = 200
    ev = [Event(trace.WINDOW, 0, n, annotation=True)]
    owner = np.full(n, -1)  # innermost span per unit
    covered = np.zeros(n, bool)  # any span per unit
    want_self = {}

    def nest(lo, hi, depth, label):
        t = lo
        while t < hi - 2 and len(want_self) < 40:
            s = int(rng.integers(t, hi - 1))
            e = int(rng.integers(s + 1, min(hi, s + 60) + 1))
            name = f"{label}.{len(want_self)}"
            ev.append(Event(name, s, e - s, annotation=True))
            owner[s:e] = len(want_self)
            covered[s:e] = True
            want_self[name] = [s, e]
            if depth < 3:
                nest(s, e, depth + 1, name)
            t = e + int(rng.integers(0, 10))

    nest(0, n, 0, "s")
    busy = np.zeros(n, bool)
    for _ in range(12):
        s = int(rng.integers(0, n - 1))
        e = int(rng.integers(s + 1, min(n, s + 25) + 1))
        ev.append(Event("k", s, e - s, CUDA))
        busy[s:e] = True
    got = spans.summarize(ev)
    names = list(want_self)
    for i, name in enumerate(names):
        s, e = want_self[name]
        inner = np.zeros(n, bool)
        for other, (s2, e2) in want_self.items():
            if other.startswith(name + "."):
                inner[s2:e2] = True
        assert got[name]["idle_s"] == pytest.approx(
            ((owner == i) & ~busy).sum() / 1e9), name
        assert got[name]["self_s"] == pytest.approx(
            (e - s - inner[s:e].sum()) / 1e9), name
    outside = (~covered & ~busy).sum() / 1e9
    total = sum(v["idle_s"] for v in got.values())
    assert total + outside == pytest.approx((~busy).sum() / 1e9)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "r_" + name.replace(".", "_"))


def test_the_runner_readers_read_slides_and_nothing_else():
    s = 1e9
    split = {name: {"calls": calls, "host_s": 1.0, "self_s": 1.0,
                    "idle_s": idle / s}
             for name, calls, idle in (
                 ("slide.run", 1, 0.2 * s), ("wsi.plan", 1, 0.05 * s),
                 ("wsi.band.wait", 10, 0.1 * s),
                 ("wsi.band.fetch", 10, 0.15 * s),
                 ("wsi.band.write", 10, 0.2 * s),
                 ("wsi.batch.cut", 199, 0.3 * s),
                 ("wsi.batch.infer", 199, 0.1 * s),
                 ("wsi.batch.stitch", 199, 2.0 * s))}
    slide = {"window_s": 10.0, "busy_s": 6.0, "config": configs()["fpn_r18"],
             "traffic": {"tile": 512, "precision": "bf16", "batch": 128},
             "kernels": {}, "spans": split,
             "work": {"windows": 25281, "batches": 199}}
    assert _reader("stitch_idle_share.slide").read(slide) == \
        pytest.approx(20.0)
    assert _reader("band_turn_idle_share.slide").read(slide) == \
        pytest.approx(5.0)
    assert _reader("batch_issue_idle_share.slide").read(slide) == \
        pytest.approx(4.0)
    assert _reader("padded_window_share.slide").read(slide) == \
        pytest.approx(100.0 * 191 / 25472)
    # a train window, and a slide window of a program without the
    # runner's spans (or a summary without the split), give nothing
    train = dict(slide, work={"patches": 128, "steps": 16},
                 spans={"train.step": split["slide.run"]})
    bare = dict(slide, spans={"slide.run": split["slide.run"]})
    unsplit = {k: v for k, v in slide.items() if k != "spans"}
    for name in ("stitch_idle_share.slide", "band_turn_idle_share.slide",
                 "batch_issue_idle_share.slide",
                 "padded_window_share.slide"):
        for summary in (train, bare, unsplit):
            assert _reader(name).read(summary) is None, name


def test_a_small_traced_slide_is_split_by_the_runner_spans():
    """``tools/spans.py`` on the bf16 slide cell cut to the CPU's sizes
    (a 384² slide, three bands, batches of 8): the readers give numbers,
    the padded share is the grid's, and the runner's spans hold the idle
    of the window but for the benchmark's own few statements."""
    cell = small_cell("fpn_r18.slide_bf16", dtype="float32", trace=True)
    run = harness.load_module(harness.HERE / "run.py", "run_for_spans")
    tool = harness.load_module(harness.HERE / "tools" / "spans.py",
                               "tool_spans")
    line = tool.traced_split(run, cell, {"platform": "cpu"})
    assert line["correct"], line["checks"]
    split, tr = line["spans"], cell.traffic
    assert split["wsi.plan"]["calls"] == 1
    assert split["wsi.band.fetch"]["calls"] == 3
    windows = 11 * 11  # 384² at stride 32 in 64² windows
    batches = split["wsi.batch.infer"]["calls"]
    assert split["wsi.batch.cut"]["calls"] == batches
    assert split["wsi.batch.stitch"]["calls"] == batches
    assert line["metrics"]["padded_window_share.slide"]["value"] == \
        pytest.approx(100.0 * (batches * tr["batch"] - windows)
                      / (batches * tr["batch"]))
    for name in tool.READERS:
        assert line["metrics"][name]["value"] >= 0.0, name
    assert line["wsi_idle_cover"] > 0.9
    assert line["idle_outside_spans_s"] >= -1e-9

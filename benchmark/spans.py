"""The traced window's time by span, from the profiler's events.

:func:`summarize` splits a window (the ``bench.window`` span, as
:mod:`benchmark.trace` finds it) by every other annotation in it, on any
thread, each call clipped to the window, and returns ``{name: {"calls",
"host_s", "self_s", "idle_s"}}``:

* ``calls``: the span's calls that overlap the window;
* ``host_s``: the sum of their durations;
* ``self_s``: that less the part that spans inside them on the same
  thread (their children) cover;
* ``idle_s``: the window time in which the card ran no operation and this
  span was the innermost open span (the latest started) on the window's
  thread, by intersecting intervals; 0 for spans on other threads.

The idle outside every span is ``window_s − busy_s − Σ idle_s``: the
spans' idle and it add up to the window's idle exactly.  The program's
spans (``wsi.*``, ``utils/profiling.py::span``) are what the readers
``metrics/*_share.slide.py`` read, under the summary's ``spans`` key.

:func:`_window` and :func:`_gaps` repeat what ``trace.summarize`` does
inline (the window span, the gaps between the merged device intervals):
they must stay alike, or the sum rule above breaks.  Where
``trace.summarize`` labels each gap at its midpoint
(``trace._innermost``), :func:`_innermost_segments` labels whole pieces
of the window, so that a gap that crosses a span's edge is split there.
"""

from __future__ import annotations

import heapq

import torch

from benchmark.trace import WINDOW, _annotation, _device_op, _merge


def _window(events):
    window = next((e for e in events if e.name() == WINDOW
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  None)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return (window.start_ns(), window.start_ns() + window.duration_ns(),
            window.start_thread_id())


def _gaps(busy, w0, w1):
    """The stretches of ``[w0, w1]`` outside the merged ``busy``."""
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps


def _innermost_segments(spans, w0, w1):
    """``[(start, end, name or None)]``: ``[w0, w1]`` cut where any of
    ``spans`` ``(start, end, name)`` opens or closes, each piece labelled
    with the latest-started span open over all of it: of two that start
    together the shorter, and of two alike the one :func:`_self_ns` makes
    the child."""
    spans = sorted(spans, key=lambda v: (v[0], -v[1]))
    points = sorted({w0, w1, *(s for s, _, _ in spans),
                     *(e for _, e, _ in spans)})
    heap, out, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(spans) and spans[i][0] <= a:
            s, e, name = spans[i]
            heapq.heappush(heap, (-s, e, -i, name))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        out.append((a, b, heap[0][3] if heap else None))
    return out


def _self_ns(spans):
    """``[(name, duration, self time)]`` of one thread's ``spans``
    ``(start, end, name)``: a span's children are the spans that lie inside
    it, each given to the innermost span that holds it."""
    stack, nodes = [], []
    for s, e, name in sorted(spans, key=lambda v: (v[0], -v[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        parent = next((p for p in reversed(stack) if p[1] >= e), None)
        node = (s, e, name, [])
        if parent is not None:
            parent[3].append([s, e])
        stack.append(node)
        nodes.append(node)
    return [(name, e - s, e - s - sum(b - a for a, b in _merge(kids)))
            for s, e, name, kids in nodes]


def summarize(events) -> dict:
    w0, w1, thread = _window(events)
    device, threads = [], {}
    for e in events:
        s = e.start_ns()
        lo, hi = max(s, w0), min(s + e.duration_ns(), w1)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _device_op(e) and hi > lo:
                device.append((lo, hi))
        elif _annotation(e) and e.name() != WINDOW and hi > lo:
            threads.setdefault(e.start_thread_id(), []).append(
                (lo, hi, e.name()))
    out = {}
    for spans in threads.values():
        for name, host, own in _self_ns(spans):
            rec = out.setdefault(name, [0, 0, 0, 0])
            rec[0] += 1
            rec[1] += host
            rec[2] += own
    gaps = _gaps(_merge(device), w0, w1)
    i = 0
    for a, b, name in _innermost_segments(threads.get(thread, []), w0, w1):
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            if name is not None:
                out[name][3] += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return {name: {"calls": calls, "host_s": host / 1e9,
                   "self_s": own / 1e9, "idle_s": idle / 1e9}
            for name, (calls, host, own, idle) in out.items()}


def idle_share(summary: dict, names) -> float | None:
    """100 × the summed ``idle_s`` of the spans ``names`` over the
    window's length; None where the summary holds no ``wsi.`` span (a
    train window, or a program without the runner's spans)."""
    spans = summary.get("spans") or {}
    if not summary.get("window_s") or not any(
            n.startswith("wsi.") for n in spans):
        return None
    idle = sum(spans[n]["idle_s"] for n in names if n in spans)
    return 100.0 * idle / summary["window_s"]

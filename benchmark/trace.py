"""The traced run's profile, summarized in process.

``Trace`` wraps a window in ``torch.profiler`` (CPU and CUDA activities)
and a ``bench.window`` span; the benchmark's own spans inside it come from
:func:`span`.  Nothing is written to disk: :meth:`Trace.summary` reads the
profiler's events and keeps

* ``window_s``: the ``bench.window`` span's length;
* ``busy_s``: the union of the device's operations (kernels, copies and
  fills) over the window, so operations that overlap count once;
* ``kernels``: device seconds by operation name;
* ``breakdown``: the ten operations that took most device time, and the
  device's idle time by what the window's thread was doing then (the
  innermost benchmark span and the innermost operator or runtime call
  open at each gap's midpoint), the ten largest.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
SPANS = ("bench.", "slide.", "train.")  # the benchmark's own span names
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A benchmark span (a profiler annotation; free when not tracing)."""
    return record_function(name)


class Trace(contextlib.AbstractContextManager):
    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._prof = None
        self._span = None

    def __enter__(self):
        if self.enabled:
            self._prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._span = record_function(WINDOW)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._span.__exit__(*exc)
            self._prof.__exit__(*exc)
        return False

    def summary(self, top: int = 10) -> dict:
        events = self._prof.profiler.kineto_results.events()
        return summarize(events, top)


def _device_op(e) -> bool:
    """Whether a device event is an operation (not an annotation's copy
    on the device's timeline); older profilers name no activity type."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return not _annotation(e)


def _annotation(e) -> bool:
    test = getattr(e, "is_user_annotation", None)
    return test() if test is not None else e.name().startswith(SPANS)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(points, intervals):
    """For each sorted point, the latest-starting ``(start, end, name)`` of
    ``intervals`` that contains it, else None."""
    intervals = sorted(intervals)
    starts = [iv[0] for iv in intervals]
    heap, out, i = [], [], 0
    for t in points:
        j = bisect.bisect_right(starts, t)
        for k in range(i, j):
            s, e, name = intervals[k]
            heapq.heappush(heap, (-s, e, name))
        i = max(i, j)
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def summarize(events, top: int = 10) -> dict:
    window = next((e for e in events if e.name() == WINDOW
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  None)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0 = window.start_ns()
    w1 = w0 + window.duration_ns()
    thread = window.start_thread_id()
    device, spans, ops, kernels = [], [], [], {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _device_op(e):
                continue
            lo, hi = max(s, w0), min(s + d, w1)
            if hi > lo:
                device.append((lo, hi))
            kernels[e.name()] = kernels.get(e.name(), 0.0) + d / 1e9
        elif e.start_thread_id() == thread and e.name() != WINDOW:
            (spans if _annotation(e) else ops).append(
                (s, s + d, e.name()))
    busy = _merge(device)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    mids = [(s + e) // 2 for s, e in gaps]
    idle = {}
    for (s, e), sp, op in zip(gaps, _innermost(mids, spans),
                              _innermost(mids, ops)):
        label = f"{sp or 'outside spans'} > {op or 'python'}"
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[k, v] for k, v in by_time[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }


def kernel_seconds(summary: dict, patterns) -> float:
    """Device seconds of the operations whose names hold any of
    ``patterns``."""
    return sum(v for k, v in summary["kernels"].items()
               if any(p in k for p in patterns))

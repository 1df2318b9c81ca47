"""Step timing and tracing (the JAX package's ``utils/profiling.py``).

* :class:`StepTimer`: per-step wall-clock statistics (mean, p50, p95) on
  the host clock, reported per epoch without waiting for the device;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``*.pt.trace.json``) into a directory, with the card's
  activity when asked for (the ``profile_epoch`` config extra);
* :func:`device_op_summary`: the newest trace's device kernels (or, in a
  trace with none, its CPU operators) summed by name.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


class StepTimer:
    def __init__(self) -> None:
        self._times: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self) -> None:
        if self._last is not None:
            self._times.append(time.perf_counter() - self._last)
            self._last = None

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps": int(t.size),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
        }

    def reset(self) -> None:
        self._times.clear()
        self._last = None


TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = False):
    """Profile the block with ``torch.profiler`` (CPU operators, and the
    card's kernels when ``cuda``) and write its Chrome trace to
    ``log_dir/trace_<ns>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}{TRACE_SUFFIX}"))


def _load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_op_summary(trace_dir: str, top: int = 20) -> List[tuple]:
    """The newest trace under ``trace_dir`` (``*.pt.trace.json``, gzipped
    or not), its device-kernel events (``cat == "kernel"``) summed by
    name; in a trace without any (a CPU-only run), its CPU operators
    (``cat == "cpu_op"``).  Returns ``[(total_us, name, long_name), ...]``,
    the largest first: ``name`` cut to 80 characters, ``long_name`` to
    200."""
    files = (glob.glob(os.path.join(trace_dir, "**", f"*{TRACE_SUFFIX}"),
                       recursive=True)
             + glob.glob(os.path.join(trace_dir, "**",
                                      f"*{TRACE_SUFFIX}.gz"),
                         recursive=True))
    if not files:
        return []
    events = _load_trace(max(files, key=os.path.getmtime)).get(
        "traceEvents", [])
    complete = [e for e in events if e.get("ph") == "X"]
    cat = ("kernel" if any(e.get("cat") == "kernel" for e in complete)
           else "cpu_op")
    agg: Dict[str, float] = {}
    for e in complete:
        if e.get("cat") == cat:
            name = str(e.get("name", "?"))
            agg[name] = agg.get(name, 0.0) + float(e.get("dur", 0.0))
    rows = sorted(((us, name[:80], name[:200]) for name, us in agg.items()),
                  reverse=True)
    return rows[:top]

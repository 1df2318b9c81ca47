"""The banded runner's spans (``infer/wsi.py::BandedSlidingWindow``,
``utils/profiling.py::span``) under the CPU profiler, on a small
``DeviceSlideSource`` on the CPU: 72² at stride 8 in 16² windows, three
bands of 24 rows holding 24, 24 and 16 windows, batches of 5 (so each
band's last batch is short).

* Band input and window upload: every span name of the mode is there,
  ``wsi.batch.infer`` once a batch, ``wsi.band.fetch`` once a band, no
  span per window, every span on the calling thread (a profiler that
  records every thread finds none on the prefetch thread or the pool);
* no ``wsi.batch.stitch`` lies inside (or across) a ``wsi.batch.cut`` or
  ``wsi.batch.infer``: the generator closes them before it yields;
* the maps are bit-equal with and without a profiler running;
* ``span`` is the one shared no-op context when no profiler runs.
"""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    DeviceSlideSource,
)
from pdac_pathological_image_segmentation_tpu_torch.infer import wsi
from pdac_pathological_image_segmentation_tpu_torch.utils import profiling

SIZE, TILE, STRIDE, BAND, BATCH = 72, 16, 8, 24, 5
BANDS = 3
# windows whose top edge lies in each band: rows 0-16, 24-40, 48-56
BATCHES = -(-24 // BATCH) * 2 + -(-16 // BATCH)
PER_BAND = ("wsi.band.wait", "wsi.band.fetch", "wsi.band.write")
PER_BATCH = ("wsi.batch.cut", "wsi.batch.infer", "wsi.batch.stitch")


def _step(images):
    """A tile→probability step on the CPU: each pixel's mean level."""
    return images.float().mean(-1) / 255.0


def _runner(band_input):
    return wsi.BandedSlidingWindow(
        None, tile=TILE, batch_size=BATCH, band_h=BAND, infer_step=_step,
        device="cpu", num_workers=2, band_input=band_input)


def _profiled(runner, source):
    """``(maps, [(name, start, end, thread)] of the wsi. spans)`` of one
    run under a profiler that records every thread."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        maps = runner.run(source)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("wsi.")]
    return maps, spans


@pytest.mark.parametrize("band_input", [True, False])
def test_spans_name_each_piece_of_a_run(band_input):
    source = DeviceSlideSource(SIZE, tile=TILE, stride=STRIDE, seed=3,
                               device="cpu")
    runner = _runner(band_input)
    plain = runner.run(source)
    maps, spans = _profiled(runner, source)

    for got, want in zip(maps, plain, strict=True):
        np.testing.assert_array_equal(got, want)

    calls = Counter(name for name, *_ in spans)
    per_band = PER_BAND if band_input else ("wsi.band.fetch",
                                            "wsi.band.write")
    assert calls == Counter({"wsi.plan": 1,
                             **{n: BANDS for n in per_band},
                             **{n: BATCHES for n in PER_BATCH}})

    caller = {t for name, _, _, t in spans if name == "wsi.plan"}
    assert {t for *_, t in spans} == caller

    issue = [(s, e) for name, s, e, _ in spans
             if name in ("wsi.batch.cut", "wsi.batch.infer")]
    for name, s, e, _ in spans:
        if name == "wsi.batch.stitch":
            assert all(e <= s2 or e2 <= s for s2, e2 in issue)


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("wsi.plan")
    assert isinstance(off, contextlib.nullcontext)
    assert off is profiling.span("wsi.band.wait")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.span("wsi.plan")
        with on:
            pass
    assert not isinstance(on, contextlib.nullcontext)
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name() == "wsi.plan"] == ["wsi.plan"]
    assert profiling.span("wsi.plan") is off

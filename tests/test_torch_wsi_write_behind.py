"""The banded runner's write-behind (``infer/wsi.py::BandedSlidingWindow``):
each band's host maps are written on a writer thread while the next band
computes.  On the CPU, on a small ``DeviceSlideSource``: 72² at stride 8 in
16² windows, three bands of 24 rows, batches of 5, and a mean-level step
(each window's probabilities depend on its pixels alone).

* The maps are bit-equal to ``SlidingWindowInference`` on the same source
  (float32 maps), with and without the TTA-disagreement map, in band-input
  and window-upload modes;
* a writer slowed by a delay still leaves every row written when ``run``
  returns, and the caller's wait on it is counted;
* an exception raised on the writer reaches the caller, and no thread that
  ``run`` started outlives it;
* ``last_run["band_writes_behind"]`` is the band count less one, and 0 for
  a slide of one band.
"""

import threading
import time

import numpy as np
import pytest

from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    DeviceSlideSource,
)
from pdac_pathological_image_segmentation_tpu_torch.infer import wsi

SIZE, TILE, STRIDE, BAND, BATCH = 72, 16, 8, 24, 5
BANDS = 3


def _step(images):
    """A tile→probability step on the CPU: each pixel's mean level."""
    return images.float().mean(-1) / 255.0


def _source(seed=3):
    return DeviceSlideSource(SIZE, tile=TILE, stride=STRIDE, seed=seed,
                             device="cpu")


def _banded(band_h=BAND, **kw):
    return wsi.BandedSlidingWindow(
        None, tile=TILE, batch_size=BATCH, band_h=band_h, infer_step=_step,
        device="cpu", num_workers=2, **kw)


@pytest.mark.parametrize("band_input", [True, False])
@pytest.mark.parametrize("uncertainty", [False, True])
def test_banded_maps_equal_whole_canvas_run(band_input, uncertainty):
    kw = dict(tta=uncertainty, uncertainty=uncertainty)
    source = _source()
    runner = _banded(band_input=band_input, **kw)
    got = runner.run(source, prob_dtype=np.float32)
    want = wsi.SlidingWindowInference(
        None, tile=TILE, batch_size=BATCH, infer_step=_step, device="cpu",
        num_workers=2, **kw).run(source)
    assert len(got) == len(want) == (3 if uncertainty else 2)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert runner.last_run["band_writes_behind"] == BANDS - 1


def test_slow_writer_leaves_every_row_written(monkeypatch):
    source = _source()
    want = _banded().run(source)
    delay = 0.05
    write = wsi.BandedSlidingWindow._write_band

    def slow(outs, y0, host):
        time.sleep(delay)
        write(outs, y0, host)

    monkeypatch.setattr(wsi.BandedSlidingWindow, "_write_band",
                        staticmethod(slow))
    runner = _banded()
    got = runner.run(source)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    # the last band's write is waited for whole
    assert runner.last_run["band_write_wait_s"] >= delay
    assert runner.last_run["band_writes_behind"] == BANDS - 1


@pytest.mark.parametrize("failing_band", [0, BANDS - 1])
def test_writer_exception_reaches_caller_and_threads_end(monkeypatch,
                                                         failing_band):
    write = wsi.BandedSlidingWindow._write_band

    def failing(outs, y0, host):
        if y0 == failing_band * BAND:
            raise OSError("host map write failed")
        write(outs, y0, host)

    monkeypatch.setattr(wsi.BandedSlidingWindow, "_write_band",
                        staticmethod(failing))
    runner = _banded()
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="host map write failed"):
        runner.run(_source())
    assert set(threading.enumerate()) <= before


def test_one_band_slide_writes_nothing_behind():
    source = _source()
    runner = _banded(band_h=SIZE)
    one = runner.run(source)
    assert runner.last_run["bands"] == 1
    assert runner.last_run["band_writes_behind"] == 0
    assert runner.last_run["band_write_wait_s"] >= 0.0
    for g, w in zip(one, _banded().run(source), strict=True):
        np.testing.assert_array_equal(g, w)

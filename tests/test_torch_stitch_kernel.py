"""The batch stitch (``ops/stitch.py::stitch_tiles_into``): on CPU canvases
the plain loop of slice adds, on CUDA canvases one launch of
``csrc/stitch.cu`` a batch.

CPU cases: the blend window is one cached tensor per ``(tile, mode,
device)`` and equals ``_blend_window_np``; CPU canvases take the plain
loop and launch nothing, and a banded run on the CPU counts no launch;
origins are clamped into the canvas and the span they cover is what the
kernel is launched over; the wrapper's checks raise on what the kernel
does not take; a padded batch's extra windows are never added.

Card cases (marker ``chip``; they skip without a card): the kernel's maps
equal the plain loop's bit for bit (``torch.equal``) on the same CUDA
inputs, at the slide cells' shape (128 windows of 512² into a 4,608 ×
40,960 band canvas at stride 256, and a padded batch of 112), at every
clamped edge and overlap, in every blend, binary and with 3 channels, for
k = 1, 32, 128 and 1,000; two launches repeat bit for bit; the call does
not synchronise the host with the card; a banded run synchronises the
caller's thread with the card only to fetch each band's maps; and a
40,960² ``DeviceSlideSource`` slide at batch 128 in bands of 4,096 rows
launches 199 times with maps equal to the loop's.  Run them on a card with
``python -m pytest --noconftest tests/test_torch_stitch_kernel.py``.
This file imports no JAX.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    DeviceSlideSource,
)
from pdac_pathological_image_segmentation_tpu_torch.infer import wsi
from pdac_pathological_image_segmentation_tpu_torch.ops import stitch

BLENDS = ("uniform", "hann", "pyramid")


@pytest.fixture
def card():
    """Skips the test where no card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _probs(rng, k, tile, channels=0, dtype=torch.float32, device="cpu"):
    shape = (k, tile, tile) + ((channels,) if channels else ())
    p = torch.from_numpy(rng.random(shape, dtype=np.float32))
    return p.to(device=device, dtype=dtype)


def _canvases(rng, hw, channels=0, device="cpu"):
    """Canvases that already hold earlier batches' sums."""
    h, w = hw
    shape = (h, w) + ((channels,) if channels else ())
    accum = torch.from_numpy(rng.random(shape, dtype=np.float32) * 3)
    weight = torch.from_numpy(rng.random((h, w), dtype=np.float32) * 2)
    return accum.to(device), weight.to(device)


def _grid(hw, tile, stride, k=None, lo=-7, hi=9):
    """Row-major window origins at ``stride``, the last ones past the
    canvas edge, nudged by up to a few pixels past every edge."""
    h, w = hw
    ys = list(range(lo, h - tile + hi, stride))
    xs = list(range(lo, w - tile + hi, stride))
    yx = np.asarray([(y, x) for y in ys for x in xs], np.int64)
    return yx if k is None else yx[:k]


# -- CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", BLENDS)
def test_blend_window_is_one_cached_tensor(mode):
    win = stitch.blend_window(32, mode)
    assert stitch.blend_window(32, mode, "cpu") is win
    assert stitch.blend_window(32, mode, torch.device("cpu")) is win
    assert win.dtype == torch.float32 and tuple(win.shape) == (32, 32)
    assert torch.equal(win, torch.from_numpy(stitch._blend_window_np(32,
                                                                     mode)))
    assert stitch.blend_window(48, mode) is not win
    with torch.inference_mode():  # first asked for under inference_mode
        fresh = stitch.blend_window(40, mode)
    assert not fresh.is_inference()


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("blend", BLENDS)
def test_cpu_canvases_take_the_loop(blend, channels):
    rng = np.random.default_rng(11)
    hw, tile = (70, 90), 32
    coords = _grid(hw, tile, 12)
    probs = _probs(rng, len(coords), tile, channels)
    a0, w0 = _canvases(rng, hw, channels)
    launches = stitch.stitch_tiles_into.launches
    a, w = stitch.stitch_tiles_into(a0.clone(), w0.clone(), probs, coords,
                                    blend=blend)
    ra, rw = stitch.stitch_tiles_into_reference(a0.clone(), w0.clone(),
                                                probs, coords, blend=blend)
    assert torch.equal(a, ra) and torch.equal(w, rw)
    assert stitch.stitch_tiles_into.launches == launches


def test_padded_windows_are_never_added():
    rng = np.random.default_rng(5)
    coords = _grid((64, 64), 16, 8, k=10)
    probs = _probs(rng, 16, 16)
    padded = probs.clone()
    padded[10:] = float("nan")
    a, w = stitch.stitch_tiles(padded, coords, (64, 64))
    ra, rw = stitch.stitch_tiles(probs[:10], coords, (64, 64))
    assert torch.equal(a, ra) and torch.equal(w, rw)


def test_clamped_span():
    yx, span = stitch.clamped_span([(-5, 3), (40, 100), (8, -1)], 16,
                                   (50, 60))
    assert yx.dtype == np.int32
    assert yx.tolist() == [[0, 3], [34, 44], [8, 0]]
    assert span == (0, 50, 0, 60)
    yx, span = stitch.clamped_span(np.asarray([(16, 24), (16, 32)]), 16,
                                   (64, 64))
    assert span == (16, 32, 24, 48)
    yx, span = stitch.clamped_span(np.zeros((0, 2), np.int64), 16, (64, 64))
    assert yx.shape == (0, 2) and span == (0, 0, 0, 0)
    with pytest.raises(ValueError, match="smaller than"):
        stitch.clamped_span([(0, 0)], 16, (15, 64))
    with pytest.raises(ValueError, match="smaller than"):
        stitch.stitch_tiles(torch.zeros((1, 16, 16)), [(0, 0)], (64, 8))


@pytest.mark.parametrize("case,exc,match", [
    ("weight f16", ValueError, "contiguous float32"),
    ("accum strided", ValueError, "contiguous float32"),
    ("probs int", TypeError, "float32, bfloat16 or float16"),
    ("weight shape", ValueError, "do not fit"),
    ("channels", ValueError, "do not fit"),
    ("tile", ValueError, "do not fit"),
    ("too few", ValueError, "coordinates for"),
    ("too many rows", ValueError, "limits"),
    ("too wide", ValueError, "limits"),
])
def test_kernel_checks_raise(case, exc, match):
    accum, weight = torch.zeros((64, 64)), torch.zeros((64, 64))
    probs, k = torch.zeros((4, 16, 16)), 4
    if case == "weight f16":
        weight = weight.half()
    elif case == "accum strided":
        accum = torch.zeros((64, 128))[:, ::2]
    elif case == "probs int":
        probs = probs.int()
    elif case == "weight shape":
        weight = torch.zeros((64, 65))
    elif case == "channels":
        accum = torch.zeros((64, 64, 3))
        probs = torch.zeros((4, 16, 16, 2))
    elif case == "tile":
        probs = torch.zeros((4, 16, 12))
    elif case == "too few":
        k = 5
    elif case == "too many rows":  # 65,536 patches of 16 rows
        accum = torch.empty((16 * 65535 + 1, 64), device="meta")
        weight = torch.empty((16 * 65535 + 1, 64), device="meta")
        probs = torch.empty((4, 16, 16), device="meta")
    elif case == "too wide":  # a row of 2**31 - 256 elements
        accum = torch.empty((64, 2 ** 29 - 64, 4), device="meta")
        weight = torch.empty((64, 2 ** 29 - 64), device="meta")
        probs = torch.empty((4, 16, 16, 4), device="meta")
    with pytest.raises(exc, match=match):
        stitch._check(accum, weight, probs, k)
    # channelled, with the probabilities in any strides: taken
    stitch._check(torch.zeros((64, 64, 3)), torch.zeros((64, 64)),
                  torch.zeros((4, 16, 16, 3)).permute(0, 2, 1, 3), 4)
    # the most rows the grid takes: 65,535 patches of 16
    rows = torch.empty((16 * 65535, 64), device="meta")
    stitch._check(rows, rows, torch.empty((4, 16, 16), device="meta"), 4)


@pytest.mark.parametrize("uncertainty", [False, True])
def test_cpu_run_counts_no_launch(uncertainty):
    runner = wsi.BandedSlidingWindow(
        None, tile=16, batch_size=5, band_h=24, device="cpu", num_workers=1,
        infer_step=lambda im: im.float().mean(-1) / 255.0,
        tta=uncertainty, uncertainty=uncertainty)
    runner.run(DeviceSlideSource(72, tile=16, stride=8, seed=3,
                                 device="cpu"))
    assert runner.last_run["stitch_launches"] == 0
    assert runner.last_run["bands"] == 3


# -- the card -----------------------------------------------------------------


def _both(accum, weight, probs, coords, blend):
    """``(kernel's canvases, loop's canvases)`` from the same inputs."""
    ra, rw = stitch.stitch_tiles_into_reference(
        accum.clone(), weight.clone(), probs, coords, blend=blend)
    launches = stitch.stitch_tiles_into.launches
    a, w = stitch.stitch_tiles_into(accum.clone(), weight.clone(), probs,
                                    coords, blend=blend)
    assert stitch.stitch_tiles_into.launches == launches + 1
    torch.cuda.synchronize()
    return (a, w), (ra, rw)


def _assert_equal(got, want):
    for g, r in zip(got, want, strict=True):
        assert torch.equal(g, r), float((g - r).abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [128, 112])
def test_card_main_path_shape(card, k, dtype):
    """A band canvas of the slide cells: 4,096 + 512 rows of 40,960, one
    batch of 128 windows at stride 256 crossing a window row, and a padded
    last batch whose 16 rows past k hold NaN."""
    rng = np.random.default_rng(k)
    hw, tile = (4608, 40960), 512
    coords = _grid(hw, tile, 256, lo=0, hi=1)[100:100 + k]
    probs = _probs(rng, 128, tile, dtype=dtype, device="cuda")
    probs[k:] = float("nan")
    accum, weight = _canvases(rng, hw, device="cuda")
    got, want = _both(accum, weight, probs, coords, "hann")
    _assert_equal(got, want)
    assert not torch.equal(got[0], accum)


@pytest.mark.chip
@pytest.mark.parametrize("stride", [16, 32, 64])
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("blend", BLENDS)
def test_card_edges_and_overlaps(card, blend, channels, stride):
    """Windows of 64² at stride t/4, t/2 and t, nudged past every edge of a
    canvas whose sides are no multiple of anything the kernel tiles by."""
    rng = np.random.default_rng(stride + channels)
    hw, tile = (301, 517), 64
    coords = _grid(hw, tile, stride)
    probs = _probs(rng, len(coords), tile, channels, device="cuda")
    accum, weight = _canvases(rng, hw, channels, device="cuda")
    got, want = _both(accum, weight, probs, coords, blend)
    _assert_equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("k", [1, 32, 128, 1000])
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("blend", BLENDS)
def test_card_any_batch(card, blend, channels, k):
    """k windows at random origins (repeats included: k = 1,000 of 48²
    in a 300 × 400 canvas), in float32, bfloat16 and float16; the
    channelled probabilities as the multi-class step gives them, an NHWC
    view of NCHW memory."""
    rng = np.random.default_rng(k)
    hw, tile = (300, 400), 48
    coords = np.stack([rng.integers(-20, hw[0] - tile + 20, k),
                       rng.integers(-20, hw[1] - tile + 20, k)], 1)
    accum, weight = _canvases(rng, hw, channels, device="cuda")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        probs = _probs(rng, k, tile, channels, dtype, "cuda")
        if channels:
            probs = probs.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        got, want = _both(accum, weight, probs, coords, blend)
        _assert_equal(got, want)


@pytest.mark.chip
def test_card_repeats_and_does_not_sync(card):
    rng = np.random.default_rng(3)
    hw, tile = (1024, 4096), 512
    coords = _grid(hw, tile, 256, lo=0, hi=1)
    probs = _probs(rng, len(coords), tile, device="cuda")
    accum, weight = _canvases(rng, hw, device="cuda")
    runs = []
    for _ in range(2):
        a, w = accum.clone(), weight.clone()
        stitch.stitch_tiles_into(a, w, probs, coords)  # warm
        torch.cuda.synchronize()
        a, w = accum.clone(), weight.clone()
        torch.cuda.set_sync_debug_mode("error")
        try:
            stitch.stitch_tiles_into(a, w, probs, coords)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        runs.append((a, w))
    torch.cuda.synchronize()
    _assert_equal(*runs)


@pytest.mark.chip
def test_card_slide_launches_once_a_batch(card, monkeypatch):
    """A 40,960² slide made on the card, at the slide cells' batch, stride,
    bands and blend, through a cheap step: 199 launches, and maps equal
    to the ones the loop stitches."""
    def step(images):
        return torch.sigmoid(images.float().mean(-1) / 32.0 - 6.0)

    dev = torch.device("cuda", torch.cuda.current_device())

    def run():
        runner = wsi.BandedSlidingWindow(
            None, tile=512, batch_size=128, band_h=4096, blend="hann",
            infer_step=step, device=dev)
        maps = runner.run(DeviceSlideSource(40960, tile=512, stride=256,
                                            seed=7, device=dev))
        return maps, runner.last_run

    (prob, mask), stats = run()
    assert stats["stitch_launches"] == 199 and stats["bands"] == 10

    def loop(*args, **kw):
        return stitch.stitch_tiles_into_reference(*args, **kw)

    loop.launches = 0
    monkeypatch.setattr(wsi, "stitch_tiles_into", loop)
    (rprob, rmask), rstats = run()
    assert rstats["stitch_launches"] == 0
    assert np.array_equal(prob.view(np.uint16), rprob.view(np.uint16))
    assert np.array_equal(mask, rmask)


@pytest.mark.chip
def test_card_runner_syncs_only_to_fetch_bands(card):
    """An 8,192² slide made on the card, in two bands of 4,096 rows at the
    slide cells' batch, stride and blend, through a cheap step: the sync
    debug mode reports one synchronisation on the caller's thread a band,
    the fetch of its maps, and none from the stitch."""
    def step(images):
        return torch.sigmoid(images.float().mean(-1) / 32.0 - 6.0)

    dev = torch.device("cuda", torch.cuda.current_device())
    runner = wsi.BandedSlidingWindow(
        None, tile=512, batch_size=128, band_h=4096, blend="hann",
        infer_step=step, device=dev)
    source = DeviceSlideSource(8192, tile=512, stride=256, seed=1,
                               device=dev)
    runner.run(source)  # warm
    torch.cuda.synchronize()
    caller = threading.get_ident()
    syncs = {"caller": 0, "other": 0}

    def show(message, *args, **kw):
        if "synchronizing CUDA operation" in str(message):
            syncs["caller" if threading.get_ident() == caller
                  else "other"] += 1

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            runner.run(source)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert runner.last_run["bands"] == 2
    assert runner.last_run["stitch_launches"] == 8
    assert syncs["caller"] == runner.last_run["bands"], syncs

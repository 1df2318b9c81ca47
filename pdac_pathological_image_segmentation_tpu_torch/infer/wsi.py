"""Full-slide sliding-window inference with on-device stitching and TTA (the
JAX package's ``infer/wsi.py``).

Supersedes the reference's missing ``visualize/predict_overlay.ipynb``
(SURVEY.md §3.5, ``configs/visualize_config.yaml:3-9``):

* tiles stream through the tile→mask step (``train/steps.py``) in large
  batches, uploaded through pinned memory;
* optional test-time augmentation averages sigmoid probabilities over the
  8 dihedral transforms (flips × rot90), inverted on the device;
* probability tiles are overlap-blended into the slide canvas on the device
  (``ops/stitch.py``); the host fetches the finished map once;
* slides whose canvas does not fit the card stream through
  :class:`BandedSlidingWindow`, whose device memory is one band.

Tile sources: :class:`GridTiler` (an in-memory slide),
:class:`PyHISTTileSource` (the reference's tile PNGs + ``tile_selection.tsv``),
``data.tiffslide.TiffSlideSource`` and ``data.synthetic.SyntheticSlideSource``
(host) and ``DeviceSlideSource`` (made on the device).  A source has
``len()``, ``get(i) → (tile_u8, (y, x))`` and ``canvas_hw``;
``read_region(y, x, h, w)`` lets the banded runner upload whole bands (a
numpy band) or take them as they are (a tensor on the runner's device).
"""

from __future__ import annotations

import csv
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from pdac_pathological_image_segmentation_tpu_torch import (
    device_to_host,
    host_to_device,
    resolve_device,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.stitch import (
    finalize_canvas,
    stitch_tiles,
    stitch_tiles_into,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.tissue import (
    tissue_fraction_np,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.profiling import (
    span,
)

# matplotlib's tab10 palette (RGB, 0..255): class k ≥ 1 of a multi-class
# overlay takes entry (k − 1) mod 10, as the JAX package's figure does
TAB10 = np.array([
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207),
], np.float32) / 255.0


# ---------------------------------------------------------------------------
# tile sources
# ---------------------------------------------------------------------------


class GridTiler:
    """Sliding-window tiler over an in-memory H×W×3 uint8 slide.

    ``tissue_threshold > 0`` skips background tiles (tiles whose tissue
    fraction per ``ops/tissue.py`` falls below the threshold)."""

    def __init__(self, slide: np.ndarray, tile: int = 512,
                 stride: Optional[int] = None,
                 tissue_threshold: float = 0.0) -> None:
        assert slide.ndim == 3 and slide.shape[2] == 3
        self.tile = tile
        self.stride = stride or tile
        self.orig_hw = tuple(slide.shape[:2])
        h, w = slide.shape[:2]
        if h < tile or w < tile:
            # slides smaller than one tile: edge-pad up to the tile so every
            # tile has the (tile, tile, 3) shape; the runner crops the
            # canvas back to ``orig_hw``
            pad_h, pad_w = max(tile - h, 0), max(tile - w, 0)
            slide = np.pad(slide, ((0, pad_h), (0, pad_w), (0, 0)),
                           mode="edge")
            h, w = slide.shape[:2]
        self.slide = slide
        ys = list(range(0, max(h - tile, 0) + 1, self.stride))
        xs = list(range(0, max(w - tile, 0) + 1, self.stride))
        # make sure the right/bottom edges are covered
        if ys[-1] != h - tile and h > tile:
            ys.append(h - tile)
        if xs[-1] != w - tile and w > tile:
            xs.append(w - tile)
        self.coords = [(y, x) for y in ys for x in xs]
        if tissue_threshold > 0.0:
            self.coords = [
                (y, x) for (y, x) in self.coords
                if tissue_fraction_np(slide[y:y + tile, x:x + tile])
                >= tissue_threshold
            ]
        self.canvas_hw = (h, w)

    def __len__(self) -> int:
        return len(self.coords)

    def get(self, i: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        y, x = self.coords[i]
        return self.slide[y:y + self.tile, x:x + self.tile], (y, x)

    def read_region(self, y: int, x: int, h: int, w: int) -> np.ndarray:
        """(h, w, 3) uint8 region at pixel (y, x) of the (edge-padded)
        slide, zero-filled outside — the band-input read used by
        ``BandedSlidingWindow``."""
        out = np.zeros((h, w, 3), np.uint8)
        sh, sw = self.slide.shape[:2]
        y1, x1 = min(y + h, sh), min(x + w, sw)
        if y1 > y and x1 > x:
            out[:y1 - y, :x1 - x] = self.slide[y:y1, x:x1]
        return out


class PyHISTTileSource:
    """The reference's visualization inputs: tile PNGs + a PyHIST
    ``tile_selection.tsv`` with grid coordinates (columns ``Tile``,
    ``Row``, ``Column``, ``Keep``; reference
    ``configs/visualize_config.yaml:6-9``)."""

    def __init__(self, tile_dir: str, tsv_path: str, tile: int = 512,
                 keep_only: bool = True,
                 tissue_threshold: float = 0.0,
                 num_workers: int = 8) -> None:
        self.tile_dir = tile_dir
        self.tile = tile
        self.entries: List[Tuple[str, int, int]] = []
        max_row = max_col = 0
        with open(tsv_path, "r") as f:
            reader = csv.DictReader(f, delimiter="\t")
            for row in reader:
                keep = str(row.get("Keep", "1")).strip()
                if keep_only and keep not in ("1", "True", "true"):
                    continue
                name = row["Tile"]
                r, c = int(row["Row"]), int(row["Column"])
                max_row, max_col = max(max_row, r), max(max_col, c)
                self.entries.append((name, r, c))
        self.canvas_hw = ((max_row + 1) * tile, (max_col + 1) * tile)
        if tissue_threshold > 0.0 and self.entries:
            # same keep/skip stage as GridTiler: decode once (threaded) and
            # drop background tiles below the tissue fraction threshold
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                fracs = list(pool.map(
                    lambda e: tissue_fraction_np(self._decode(e[0])),
                    self.entries,
                ))
            self.entries = [e for e, f in zip(self.entries, fracs)
                            if f >= tissue_threshold]

    def __len__(self) -> int:
        return len(self.entries)

    def _decode(self, name: str) -> np.ndarray:
        path = os.path.join(self.tile_dir, name)
        if not os.path.exists(path) and not name.endswith(".png"):
            path = path + ".png"
        return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)

    def get(self, i: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        name, r, c = self.entries[i]
        img = self._decode(name)
        return img, (r * self.tile, c * self.tile)


# ---------------------------------------------------------------------------
# TTA
# ---------------------------------------------------------------------------


def _make_tta_infer(infer_step, tta: bool, with_variance: bool = False):
    """Wrap a tile→prob step with dihedral-8 TTA, averaged on the device.

    ``with_variance=True`` also returns the per-pixel population variance
    across the 8 transform predictions, ``max(E[p²] − E[p]², 0)``, from
    running sum and sum-of-squares accumulators (no extra forward)."""
    if not tta:
        if with_variance:
            raise ValueError("uncertainty maps require tta=True "
                             "(variance across the dihedral-8 passes)")
        return infer_step

    def step(images: torch.Tensor):
        total = total_sq = None
        for flip in (False, True):
            imgs = images.flip(2) if flip else images
            for k in range(4):
                p = infer_step(torch.rot90(imgs, k, dims=(1, 2)))
                # invert: rot90 by -k, then unflip
                p = torch.rot90(p, -k, dims=(1, 2))
                if flip:
                    p = p.flip(2)
                total = p if total is None else total + p
                if with_variance:
                    psq = p * p
                    total_sq = psq if total_sq is None else total_sq + psq
        mean = total / 8.0
        if not with_variance:
            return mean
        var = (total_sq / 8.0 - mean * mean).clamp_min(0.0)
        return mean, var

    return step


def _runner_device(model, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if model is None:
        raise ValueError("pass device= with an infer_step and no model")
    return next(model.parameters()).device


def _divided(accum: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``accum / weight`` where a tile covered the pixel, else 0."""
    return torch.where(weight > 0, accum / weight.clamp_min(1e-12), 0.0)


# ---------------------------------------------------------------------------
# sliding-window runner
# ---------------------------------------------------------------------------


class SlidingWindowInference:
    """Stream tiles → tile→mask step (+TTA) → on-device overlap-blend
    canvas → (probability map, hard mask).

    Binary models stitch one canvas and threshold at 0.5; multi-class
    models (``num_classes > 1``) stitch an ``(H, W, C)`` softmax canvas
    and the mask is the per-pixel argmax class map (``ops/stitch.py``).

    ``model`` is an eval-ready module on its device; ``infer_step``
    (``step(images_u8) → probs`` on the device, e.g. a serving artifact's
    ``step``) replaces the default step, and then ``device`` names where it
    runs.  ``uncertainty=True`` (requires ``tta``) stitches a second canvas
    of TTA disagreement; ``run`` then returns ``(prob, mask,
    uncertainty)``."""

    def __init__(self, model, tile: int = 512, batch_size: int = 32,
                 tta: bool = False, blend: str = "hann",
                 num_workers: int = 8, stain: str = "none",
                 infer_step=None, uncertainty: bool = False,
                 device=None) -> None:
        from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
            make_infer_step,
        )

        self.device = _runner_device(model, device)
        self.tile = tile
        self.batch_size = batch_size
        self.blend = blend
        self.uncertainty = uncertainty
        self._infer = _make_tta_infer(
            infer_step or make_infer_step(model, tile, stain=stain), tta,
            with_variance=uncertainty,
        )
        self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def _batches(self, source) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(source)
        for start in range(0, n, self.batch_size):
            idxs = list(range(start, min(start + self.batch_size, n)))
            pairs = list(self._pool.map(source.get, idxs))
            images = np.stack([p[0] for p in pairs])
            coords = np.asarray([p[1] for p in pairs], dtype=np.int64)
            # the final partial batch runs at its own size
            yield images, coords

    @torch.inference_mode()
    def run(self, source) -> Tuple[np.ndarray, ...]:
        """Returns host (prob_map, binary_mask), each ``canvas_hw`` (cropped
        to ``orig_hw``) — plus an uncertainty map when constructed with
        ``uncertainty=True``."""
        accum = weight = var_accum = var_weight = None
        for images, coords in self._batches(source):
            out = self._infer(
                host_to_device(torch.from_numpy(images), self.device))
            probs, vars_ = out if self.uncertainty else (out, None)
            if accum is None:
                accum, weight = stitch_tiles(
                    probs, coords, tuple(source.canvas_hw), blend=self.blend)
                if vars_ is not None:
                    var_accum, var_weight = stitch_tiles(
                        vars_, coords, tuple(source.canvas_hw),
                        blend=self.blend)
            else:
                stitch_tiles_into(accum, weight, probs, coords,
                                  blend=self.blend)
                if vars_ is not None:
                    # its own weight canvas, as in the JAX runner
                    stitch_tiles_into(var_accum, var_weight, vars_, coords,
                                      blend=self.blend)
        if accum is None:
            raise ValueError("tile source is empty")
        prob, mask = finalize_canvas(accum, weight)
        maps = [prob, mask]
        if self.uncertainty:
            maps.append(_divided(var_accum, var_weight))
        host = device_to_host(maps)
        # crop back any tiler padding (slides smaller than one tile)
        oh, ow = getattr(source, "orig_hw", host[0].shape[:2])
        return tuple(m[:oh, :ow] for m in host)


class BandedSlidingWindow:
    """Sliding-window inference for slides whose canvas does not fit the
    card (or host RAM): the canvas lives as one horizontal band of
    ``band_h + tile`` rows on the device; a tile belongs to the band that
    holds its top edge (it spills at most ``tile`` rows into the next band,
    which are carried over as the next band's starting accumulation).
    Finalized rows stream to host arrays (``prob_dtype`` float16 by default:
    a 40k×40k probability map is 3.2 GB instead of 6.4), one fetch a band.

    **Band input** (``band_input=True``, the default when the source has
    ``read_region(y, x, h, w)``): each band's pixels are uploaded once,
    through pinned memory on a side stream, and the windows are cut out on
    the device with one gather a batch.  The next band's read and upload
    run while the current band computes.  A source whose bands are tensors
    on the runner's device (``DeviceSlideSource``) makes them on the side
    stream and uploads nothing.  A batch shorter than
    ``batch_size`` is padded with windows at (0, 0), whose probabilities are
    dropped before stitching.

    **Write-behind**: a band's fetched rows are copied into the host maps
    by a writer thread while the next band computes (the first touch of
    the maps' pages is most of that copy's time).  At most one write is in
    flight: before handing over a band's write the caller waits for the
    previous one, so at most two bands' host copies are alive.  ``run``
    returns once the last band's write is done; an exception on the writer
    reaches the caller at the next wait, and both runner threads are shut
    down on every exit.

    Binary models only: a multi-class model raises (use
    :class:`SlidingWindowInference`).  After ``run``, ``last_run`` holds
    the band count, the band uploads' bytes, host read seconds and
    device copy seconds, and ``stitch_launches``, the stitch kernel's
    launches (one a batch, two with ``uncertainty``; 0 on the CPU).  For
    bands made on the card (a tensor source), ``band_upload_bytes`` is 0
    and ``band_upload_s`` is the device time of making them on the side
    stream, not a copy's.  ``band_writes_behind``
    counts the band writes that ran while a later band computed (every
    band's but the last), and ``band_write_wait_s`` is the caller's time
    spent waiting for the writer, the last band's write included.

    Under a running ``torch.profiler``, ``run`` opens fixed-name spans
    (``utils/profiling.py::span``), all on the calling thread:
    ``wsi.plan`` (band assignment, output maps, first band request) once;
    per band ``wsi.band.wait`` (for the prefetch thread),
    ``wsi.band.fetch`` (finalize, casts, the copy to the host) and
    ``wsi.band.write`` (the wait for the previous band's write, the
    hand-off to the writer and the canvas roll; for the last band, the
    wait for its own write);
    per batch ``wsi.batch.cut`` (the windows cut or read and uploaded),
    ``wsi.batch.infer`` (the step's launches) and ``wsi.batch.stitch``.
    None is open across another, and none per window.  The writer thread
    opens none."""

    def __init__(self, model, tile: int = 512, batch_size: int = 32,
                 band_h: Optional[int] = None, tta: bool = False,
                 blend: str = "hann", num_workers: int = 8,
                 stain: str = "none", infer_step=None,
                 band_input: Optional[bool] = None,
                 uncertainty: bool = False, device=None) -> None:
        from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
            make_infer_step,
        )

        if model is not None and getattr(model, "num_classes", 1) > 1:
            raise ValueError(
                "BandedSlidingWindow stitches a single 2-D band canvas; "
                "multi-class slides need SlidingWindowInference (per-class "
                "canvases)")
        self.device = _runner_device(model, device)
        self.tile = tile
        self.batch_size = batch_size
        self.band_h = band_h or max(tile, 4096)
        assert self.band_h >= tile
        self.blend = blend
        self.band_input = band_input
        self.uncertainty = uncertainty
        self._infer = _make_tta_infer(
            infer_step or make_infer_step(model, tile, stain=stain), tta,
            with_variance=uncertainty,
        )
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self.last_run: dict = {}

    def _extract(self, band: torch.Tensor, local: np.ndarray) -> torch.Tensor:
        """The ``(B, tile, tile, 3)`` windows at band-local ``(y, x)`` rows of
        ``local``, gathered from the device-resident band in one launch."""
        yx = host_to_device(torch.from_numpy(local), self.device)
        offsets = torch.arange(self.tile, device=self.device)
        rows = (yx[:, 0, None] + offsets)[:, :, None]
        cols = (yx[:, 1, None] + offsets)[:, None, :]
        return band[rows, cols]

    def _upload_prob_batches(self, source, idxs, y0):
        """Window-upload inner loop: read each batch's windows on the pool,
        upload them and run inference; ``(probs, band-local (y, x))``."""
        for start in range(0, len(idxs), self.batch_size):
            with span("wsi.batch.cut"):
                chunk = idxs[start:start + self.batch_size]
                pairs = list(self._pool.map(source.get, chunk))
                images = host_to_device(
                    torch.from_numpy(np.stack([p[0] for p in pairs])),
                    self.device)
                local = (np.asarray([p[1] for p in pairs], dtype=np.int64)
                         - np.asarray([y0, 0], np.int64))
            with span("wsi.batch.infer"):
                out = self._infer(images)
            yield out, local

    def _band_prob_batches(self, coords_all, per_band_idxs, y0, band):
        """Band-input inner loop: cut each window batch out of the
        device-resident band and run inference — no per-window upload.
        Spans close before each ``yield``, so the caller's stitch nests in
        neither."""
        bs = self.batch_size
        for start in range(0, len(per_band_idxs), bs):
            with span("wsi.batch.cut"):
                chunk = per_band_idxs[start:start + bs]
                k = len(chunk)
                local = np.zeros((bs, 2), np.int64)
                local[:k] = [(coords_all[i][0] - y0, coords_all[i][1])
                             for i in chunk]
                windows = self._extract(band, local)
            with span("wsi.batch.infer"):
                out = self._infer(windows)
            if isinstance(out, tuple):  # uncertainty: (mean, variance)
                yield (out[0][:k], out[1][:k]), local[:k]
            else:
                yield out[:k], local[:k]

    def _band_tensor(self, region) -> tuple:
        """``(band on the runner's device, bytes uploaded)``: a tensor
        already there is taken as it is, a numpy band goes up through
        pinned memory, a tensor on another device raises."""
        if torch.is_tensor(region):
            if region.device != self.device:
                raise ValueError(
                    f"read_region gave a band on {region.device}; the runner "
                    f"runs on {self.device}")
            return region, 0
        return (host_to_device(torch.from_numpy(region), self.device),
                region.nbytes)

    def _fetch_band(self, source, y0: int, rows: int, w: int):
        """Read a band and start its upload (or, for a source that makes
        its bands on the device, make it) on the side stream; ``(band, host
        seconds, the copy's (start, end) events or None, bytes uploaded)``.
        Runs on the prefetch thread."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            region = source.read_region(y0, 0, rows, w)
            band, nbytes = self._band_tensor(region)
            return band, time.perf_counter() - t0, None, nbytes
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy_stream):
            start.record()
            region = source.read_region(y0, 0, rows, w)
            read_s = time.perf_counter() - t0
            if not torch.is_tensor(region):
                start.record()  # the host's read is not the copy's time
            band, nbytes = self._band_tensor(region)
            end.record()
        return band, read_s, (start, end), nbytes

    @staticmethod
    def _write_band(outs, y0: int, host) -> None:
        """Copy a band's fetched rows into the host maps from row ``y0``;
        runs on the writer thread."""
        for out, rows in zip(outs, host, strict=True):
            out[y0:y0 + len(rows)] = rows

    @torch.inference_mode()
    def run(self, source, prob_dtype=np.float16) -> Tuple[np.ndarray, ...]:
        """Returns (prob, mask) — plus a TTA-disagreement map when
        constructed with ``uncertainty=True``."""
        with span("wsi.plan"):
            h, w = source.canvas_hw
            tile, band_h, dev = self.tile, self.band_h, self.device
            n = len(source)
            # band assignment by tile top edge (host-side, O(tiles))
            coords_all = getattr(source, "coords", None)
            if coords_all is None:
                coords_all = [source.get(i)[1] for i in range(n)]
            n_bands = -(-h // band_h)
            per_band: list[list[int]] = [[] for _ in range(n_bands)]
            for i, (y, x) in enumerate(coords_all):
                per_band[min(y // band_h, n_bands - 1)].append(i)

            use_band = (self.band_input if self.band_input is not None
                        else hasattr(source, "read_region"))
            if use_band and not hasattr(source, "read_region"):
                raise ValueError(
                    "band_input=True requires a source with read_region(y, "
                    "x, h, w); pass band_input=False for window-upload mode")

            band_rows = band_h + tile
            nonempty = [b for b in range(n_bands) if per_band[b]]
            fetcher = ThreadPoolExecutor(max_workers=1) if use_band else None
            writer = ThreadPoolExecutor(max_workers=1)
            if use_band and dev.type == "cuda":
                self._copy_stream = torch.cuda.Stream(dev)
            futures: dict = {}
            timings = []
            stats = {"bands": len(nonempty) if use_band else 0,
                     "band_upload_bytes": 0, "band_read_s": 0.0,
                     "band_upload_s": 0.0, "band_writes_behind": 0,
                     "band_write_wait_s": 0.0}
            launches = stitch_tiles_into.launches

            def submit(b):
                futures[b] = fetcher.submit(self._fetch_band, source,
                                            b * band_h, band_rows, w)

            if use_band and nonempty:
                submit(nonempty[0])

            def roll(a):
                # the last `tile` rows become the next band's first rows
                a[:tile].copy_(a[band_h:])
                a[tile:].zero_()

            torch_prob_dtype = torch.from_numpy(np.zeros(0, prob_dtype)).dtype
            prob_out = np.zeros((h, w), dtype=prob_dtype)
            mask_out = np.zeros((h, w), dtype=np.uint8)

            def zeros():
                return torch.zeros((band_rows, w), dtype=torch.float32,
                                   device=dev)

            accum, weight = zeros(), zeros()
            unc_out = var_accum = var_weight = None
            if self.uncertainty:
                unc_out = np.zeros((h, w), dtype=prob_dtype)
                var_accum, var_weight = zeros(), zeros()
            outs = [m for m in (prob_out, mask_out, unc_out) if m is not None]
            compute = torch.cuda.current_stream(dev) if dev.type == "cuda" \
                else None
            written = None  # the band write in flight

            def wait_written():
                t0 = time.perf_counter()
                written.result()
                stats["band_write_wait_s"] += time.perf_counter() - t0

        try:
            for b in range(n_bands):
                y0 = b * band_h
                if use_band and per_band[b]:
                    with span("wsi.band.wait"):
                        band, read_s, events, nbytes = futures.pop(b).result()
                    stats["band_read_s"] += read_s
                    stats["band_upload_bytes"] += nbytes
                    if events is not None:
                        # the compute stream waits for the copy, and the
                        # allocator keeps the band until compute is done
                        compute.wait_event(events[1])
                        band.record_stream(compute)
                        timings.append(events)
                    pos = nonempty.index(b)
                    if pos + 1 < len(nonempty):
                        submit(nonempty[pos + 1])
                    batches = self._band_prob_batches(
                        coords_all, per_band[b], y0, band)
                elif per_band[b]:
                    batches = self._upload_prob_batches(
                        source, per_band[b], y0)
                else:
                    batches = ()
                for out, local in batches:
                    with span("wsi.batch.stitch"):
                        probs, vars_ = (out if self.uncertainty
                                        else (out, None))
                        stitch_tiles_into(accum, weight, probs, local,
                                          blend=self.blend)
                        if vars_ is not None:
                            # its own weight canvas, as in the JAX runner
                            stitch_tiles_into(var_accum, var_weight, vars_,
                                              local, blend=self.blend)
                with span("wsi.band.fetch"):
                    rows = min(band_h, h - y0)
                    prob, mask = finalize_canvas(accum[:band_h],
                                                 weight[:band_h])
                    maps = [prob[:rows].to(torch_prob_dtype), mask[:rows]]
                    if self.uncertainty:
                        maps.append(_divided(var_accum[:band_h],
                                             var_weight[:band_h])[:rows]
                                    .to(torch_prob_dtype))
                    host = device_to_host(maps)
                with span("wsi.band.write"):
                    if written is not None:
                        # the previous band's write, which had this band's
                        # compute to finish in
                        wait_written()
                        stats["band_writes_behind"] += 1
                    written = writer.submit(self._write_band, outs, y0, host)
                    del host
                    if b + 1 < n_bands:
                        for canvas in (accum, weight, var_accum, var_weight):
                            if canvas is not None:
                                roll(canvas)
                    else:
                        wait_written()
        finally:
            if fetcher is not None:
                fetcher.shutdown(wait=True, cancel_futures=True)
            writer.shutdown(wait=True, cancel_futures=True)
        stats["band_upload_s"] = sum(s.elapsed_time(e)
                                     for s, e in timings) / 1000.0
        stats["stitch_launches"] = stitch_tiles_into.launches - launches
        self.last_run = stats
        oh, ow = getattr(source, "orig_hw", (h, w))
        if not self.uncertainty:
            return prob_out[:oh, :ow], mask_out[:oh, :ow]
        return (prob_out[:oh, :ow], mask_out[:oh, :ow],
                unc_out[:oh, :ow])


def overlay_figure(
    slide_thumb: np.ndarray,  # h,w,3 uint8 low-res rendering
    mask: np.ndarray,  # H,W binary (or argmax class labels) at grid res
    out_path: str,
    alpha: float = 0.4,
    num_classes: int = 1,
) -> str:
    """Reference README's overlay visualization (``README.md:26-35``): the
    prediction over a low-resolution slide rendering, written as a PNG at
    the thumbnail's size.  The mask is resized to the thumbnail by nearest
    index, as in the JAX package; binary masks are red with ``alpha``
    "over" the thumbnail, and class k ≥ 1 of an argmax class map takes
    tab10's colour (k − 1) mod 10.  Composed with numpy and PIL (the JAX
    package's matplotlib framing is not reproduced)."""
    th, tw = slide_thumb.shape[:2]
    ys = (np.arange(th) * (mask.shape[0] / th)).astype(np.int64).clip(0, mask.shape[0] - 1)
    xs = (np.arange(tw) * (mask.shape[1] / tw)).astype(np.int64).clip(0, mask.shape[1] - 1)
    small = mask[np.ix_(ys, xs)]

    color = np.zeros((th, tw, 3), np.float32)
    a = np.zeros((th, tw), np.float32)
    if num_classes > 1:
        for k in range(1, num_classes):
            sel = small == k
            color[sel] = TAB10[(k - 1) % 10]
            a[sel] = alpha
    else:
        color[..., 0] = 1.0  # red tumor highlight
        a = small.astype(np.float32) * np.float32(alpha)
    base = slide_thumb[..., :3].astype(np.float32) / 255.0
    out = base * (1.0 - a[..., None]) + color * a[..., None]
    Image.fromarray(
        np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
    ).save(out_path)
    return out_path

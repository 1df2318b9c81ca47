"""Sharded sliding-window whole-slide inference over a list of devices (the
JAX package's ``infer/wsi_sharded.py``).

The slide canvas is cut into D horizontal bands, one per entry of
``devices``; every band predicts and stitches its own tiles on its own
device and CUDA stream, and the tile rows that spill past a band's bottom
are added into the next band's top once, at the end, by one device-to-device
copy per boundary (the JAX runner's finalize-time ``ppermute``).  The JAX
runner is one program over a mesh; this one is one process over a device
list: D distinct cards on a node that has them, or one device named D times
(``[cuda:0] * 4`` on a one-card machine, ``[cpu] * 8`` in the CPU tests),
which runs the same plan band by band.

Layout (the JAX runner's):

* band b owns canvas rows ``[b·band_h, (b+1)·band_h)``, ``band_h =
  max(⌈h/D⌉, tile)``; a tile belongs to the band holding its top edge, so
  it spills at most ``tile`` rows into the next band;
* a band's canvases hold ``band_h + tile`` rows: its own, then the halo it
  hands to the next band;
* every band runs the same number of batches of ``batch_per_device``
  windows, the short ones padded with windows at (0, 0) whose predictions
  are dropped.

Band input (the default when the source has ``read_region(y, x, h, w)``)
uploads each band's pixels once and cuts the windows out on the device;
window mode uploads each window.  Rolled mode (``roll_h``) streams each
band's rows through an O(``roll_h``)-row canvas, flushing finished rows to
the host after every roll and holding each band's top ``tile`` rows on the
device until the previous band's halo arrives.  TTA (``tta``) and the TTA
variance map (``uncertainty``) stitch with the same blend weights.  Binary
models only, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch import (
    device_to_host,
    host_to_device,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
    _divided,
    _make_tta_infer,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.stitch import (
    blend_window,
)
from pdac_pathological_image_segmentation_tpu_torch.parallel.mesh import (
    indexed_device,
    replicate,
)


class _Band:
    """One band's device, stream and canvases."""

    def __init__(self, device: torch.device, rows: int, width: int,
                 uncertainty: bool) -> None:
        self.device = device
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            # after what the default stream holds (replicas, the window)
            self.stream.wait_stream(torch.cuda.current_stream(device))
        with self.context():
            def zeros():
                return torch.zeros((rows, width), dtype=torch.float32,
                                   device=device)
            self.accum, self.weight = zeros(), zeros()
            self.var = zeros() if uncertainty else None
        self.pixels = None

    def context(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def canvases(self) -> list:
        return [c for c in (self.accum, self.weight, self.var)
                if c is not None]

    def synchronize(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


def _accumulate(band: _Band, out, local: np.ndarray, win: torch.Tensor
                ) -> None:
    """Add a batch's valid tiles at band-local ``(y, x)`` into the band's
    canvases in tile order (the JAX ``_band_accumulate``; the variance
    with the same blend weights).  A window that would cross the canvas
    edge is shifted inside it, as ``lax.dynamic_slice`` clamps."""
    probs, vars_ = out if isinstance(out, tuple) else (out, None)
    tile = probs.shape[1]
    h, w = band.weight.shape
    weighted = probs.float() * win
    wvars = None if vars_ is None else vars_.float() * win
    for i, (y, x) in enumerate(local.tolist()):
        y = min(max(y, 0), h - tile)
        x = min(max(x, 0), w - tile)
        band.accum[y:y + tile, x:x + tile] += weighted[i]
        band.weight[y:y + tile, x:x + tile] += win
        if wvars is not None:
            band.var[y:y + tile, x:x + tile] += wvars[i]


class ShardedSlidingWindow:
    """Band-sharded sliding-window inference with on-device stitching and a
    halo exchange between bands (see the module docstring).

    ``model`` is an eval-ready binary module; each distinct device of
    ``devices`` runs its own replica (the model itself where it already
    lies).  ``infer_step`` replaces the default tile→mask step: a callable
    ``step(images_u8) → probs`` when every band is on one device, or a
    ``{device: step}`` mapping (e.g. the int8 path built once per card).
    ``band_input`` None decides by the source (``read_region``); ``roll_h``
    turns on rolled mode (``roll_h ≥ tile``)."""

    def __init__(self, model, devices, tile: int = 512,
                 batch_per_device: int = 8, blend: str = "hann",
                 tta: bool = False, stain: str = "none", infer_step=None,
                 band_input: Optional[bool] = None,
                 uncertainty: bool = False,
                 roll_h: Optional[int] = None) -> None:
        from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
            make_infer_step,
        )

        if model is not None and getattr(model, "num_classes", 1) > 1:
            raise ValueError(
                "ShardedSlidingWindow stitches 2-D per-device band "
                "canvases; multi-class slides need SlidingWindowInference "
                "(per-class canvases)")
        self.devices = [indexed_device(d) for d in devices]
        if not self.devices:
            raise ValueError("devices is empty")
        self.n_devices = len(self.devices)
        self.tile = tile
        self.batch_per_device = batch_per_device
        self.blend = blend
        self.band_input = band_input
        self.uncertainty = uncertainty
        if roll_h is not None and roll_h < tile:
            raise ValueError(f"roll_h ({roll_h}) must be >= tile ({tile}) "
                             "so a tile spills into at most one roll")
        self.roll_h = roll_h
        distinct = list(dict.fromkeys(self.devices))
        if infer_step is None:
            if model is None:
                raise ValueError("pass a model or an infer_step")
            steps = {dev: make_infer_step(replica, tile, stain=stain)
                     for dev, replica in replicate(model, distinct).items()}
        elif callable(infer_step):
            if len(distinct) > 1:
                raise ValueError(
                    f"one infer_step for {len(distinct)} devices: pass a "
                    "{device: step} mapping")
            steps = {distinct[0]: infer_step}
        else:
            steps = {indexed_device(k): v for k, v in infer_step.items()}
            missing = [d for d in distinct if d not in steps]
            if missing:
                raise ValueError(f"infer_step has no step for {missing}")
        self._infer = {dev: _make_tta_infer(steps[dev], tta,
                                            with_variance=uncertainty)
                       for dev in distinct}

    # ------------------------------------------------------------------

    def _plan(self, coords: np.ndarray, canvas_hw: Tuple[int, int]):
        """Tiles to bands by top edge; every band padded to the same
        multiple of ``batch_per_device`` (invalid slots masked)."""
        h, _ = canvas_hw
        d = self.n_devices
        # a band covers at least a tile, so a tile spills into at most one
        # neighbour; short slides leave trailing bands empty (cropped)
        band_h = max(-(-h // d), self.tile)
        owners = np.minimum(coords[:, 0] // band_h, d - 1)
        per_band: List[List[int]] = [[] for _ in range(d)]
        for i, o in enumerate(owners):
            per_band[int(o)].append(i)
        bpd = self.batch_per_device
        max_n = -(-max(len(b) for b in per_band) // bpd) * bpd
        return band_h, per_band, max_n

    def _read_band(self, band: _Band, source, y0: int, rows: int,
                   width: int) -> None:
        """The band's pixels on its device, read and uploaded once (a source
        that makes its bands on a device makes them on the band's
        stream)."""
        with band.context():
            region = source.read_region(y0, 0, rows, width)
            band.pixels = (region.to(band.device) if torch.is_tensor(region)
                           else host_to_device(torch.from_numpy(region),
                                               band.device))

    def _windows(self, band: _Band, source, coords: np.ndarray, idxs,
                 y0: int, use_band: bool):
        """A batch of ``batch_per_device`` windows on the band's device for
        tiles ``idxs`` (padded at (0, 0)); returns ``(images, band-local
        (y, x) of the valid ones)``."""
        bpd, tile = self.batch_per_device, self.tile
        local = np.zeros((bpd, 2), np.int64)
        if use_band:
            local[:len(idxs)] = coords[idxs] - np.asarray([y0, 0])
            yx = host_to_device(torch.from_numpy(local), band.device)
            span = torch.arange(tile, device=band.device)
            rows = (yx[:, 0, None] + span)[:, :, None]
            cols = (yx[:, 1, None] + span)[:, None, :]
            return band.pixels[rows, cols], local[:len(idxs)]
        images = np.zeros((bpd, tile, tile, 3), np.uint8)
        for j, i in enumerate(idxs):
            img, (y, x) = source.get(int(i))
            images[j] = img
            local[j] = (y - y0, x)
        return (host_to_device(torch.from_numpy(images), band.device),
                local[:len(idxs)])

    def _run_chunk(self, band: _Band, source, coords, idxs, y0: int,
                   use_band: bool, win: torch.Tensor) -> None:
        if not len(idxs):
            return
        with band.context():
            images, local = self._windows(band, source, coords, idxs, y0,
                                          use_band)
            out = self._infer[band.device](images)
            k = len(idxs)
            out = (out[0][:k], out[1][:k]) if isinstance(out, tuple) \
                else out[:k]
            _accumulate(band, out, local, win)

    def _use_band(self, source) -> bool:
        use = (self.band_input if self.band_input is not None
               else hasattr(source, "read_region"))
        if use and not hasattr(source, "read_region"):
            raise ValueError(
                "band_input=True requires a source with read_region(y, x, "
                "h, w); pass band_input=False for window-upload mode")
        return bool(use)

    def _exchange_halo(self, bands: List[_Band], rows: int,
                       held: Optional[list] = None) -> None:
        """Add band b's last ``tile`` rows (from canvas row ``rows``) into
        band b+1's top ones (or into its held rows), one device-to-device
        copy per boundary and canvas; the host waits for every band
        first."""
        for band in bands:
            band.synchronize()
        tile = self.tile
        for b in range(len(bands) - 1, 0, -1):
            src, dst = bands[b - 1], bands[b]
            targets = held[b] if held is not None else [
                c[:tile] for c in dst.canvases()]
            with dst.context():
                for t, c in zip(targets, src.canvases()):
                    t += c[rows:rows + tile].to(dst.device)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def run(self, source) -> Tuple[np.ndarray, ...]:
        """Predict and stitch a tile source (``len``, ``get(i) → (tile_u8,
        (y, x))``, ``canvas_hw``, optionally ``coords`` and
        ``read_region``).  Returns host ``(prob_map float32, mask uint8)``
        and, with ``uncertainty``, the TTA variance map; rolled mode
        returns the maps in float16, the JAX runner's O(band) output (the
        mask thresholded on the float32 rows before the cast)."""
        h, w = source.canvas_hw
        coords = getattr(source, "coords", None)
        if coords is None:
            coords = [source.get(i)[1] for i in range(len(source))]
        coords = np.asarray(coords, np.int64).reshape(-1, 2)
        use_band = self._use_band(source)
        if self.roll_h is not None:
            return self._run_rolled(source, coords, h, w, use_band)
        band_h, per_band, max_n = self._plan(coords, (h, w))
        tile, bpd = self.tile, self.batch_per_device
        wins = {dev: blend_window(tile, self.blend, dev)
                for dev in self._infer}
        bands = [_Band(dev, band_h + tile, w, self.uncertainty)
                 for dev in self.devices]
        if use_band:
            for b, band in enumerate(bands):
                if per_band[b]:
                    self._read_band(band, source, b * band_h, band_h + tile,
                                    w)
        for start in range(0, max_n, bpd):
            for b, band in enumerate(bands):
                self._run_chunk(band, source, coords,
                                per_band[b][start:start + bpd], b * band_h,
                                use_band, wins[band.device])
        self._exchange_halo(bands, band_h)
        maps = [[], [], []]
        for band in bands:
            with band.context():
                prob = _divided(band.accum[:band_h], band.weight[:band_h])
                got = [prob, (prob >= 0.5).to(torch.uint8)]
                if self.uncertainty:
                    got.append(_divided(band.var[:band_h],
                                        band.weight[:band_h]))
                for m, host in zip(maps, device_to_host(got)):
                    m.append(host)
        oh, ow = getattr(source, "orig_hw", (h, w))
        out = [np.concatenate(m)[:h][:oh, :ow] for m in maps if m]
        return tuple(out)

    # ----------------------------------------------------- rolled mode

    def _run_rolled(self, source, coords: np.ndarray, h: int, w: int,
                    use_band: bool) -> Tuple[np.ndarray, ...]:
        """Each band owns ``h_own`` rows (a whole number of rolls) and
        streams them through a ``roll_h + tile``-row canvas; finished rows
        go to the host after each roll, the region's top ``tile`` rows stay
        on the device until the previous band's halo is added at the end."""
        d, tile, bpd = self.n_devices, self.tile, self.batch_per_device
        roll_h = max(self.roll_h, tile)
        h_own = -(-h // (d * roll_h)) * roll_h
        n_rolls = h_own // roll_h
        owners = np.minimum(coords[:, 0] // h_own, d - 1)
        roll_of = (coords[:, 0] - owners * h_own) // roll_h
        per = [[[] for _ in range(n_rolls)] for _ in range(d)]
        for i, (b, k) in enumerate(zip(owners, roll_of)):
            per[int(b)][int(k)].append(i)
        wins = {dev: blend_window(tile, self.blend, dev)
                for dev in self._infer}
        bands = [_Band(dev, roll_h + tile, w, self.uncertainty)
                 for dev in self.devices]
        prob_out = np.zeros((h, w), np.float16)
        mask_out = np.zeros((h, w), np.uint8)
        unc_out = np.zeros((h, w), np.float16) if self.uncertainty else None

        def emit(b: int, y_local: int, accum, weight, var, skip: int = 0):
            """Normalize rows on the device and write them at band b's
            offset, cropped at the slide's bottom (the mask thresholded on
            the float32 rows)."""
            y0 = b * h_own + y_local + skip
            keep = min(accum.shape[0] - skip, h - y0)
            if keep <= 0:
                return
            prob = _divided(accum[skip:skip + keep], weight[skip:skip + keep])
            got = [prob.half(), (prob >= 0.5).to(torch.uint8)]
            if var is not None:
                got.append(_divided(var[skip:skip + keep],
                                    weight[skip:skip + keep]).half())
            host = device_to_host(got)
            prob_out[y0:y0 + keep], mask_out[y0:y0 + keep] = host[0], host[1]
            if var is not None:
                unc_out[y0:y0 + keep] = host[2]

        held = None
        for k in range(n_rolls):
            max_n = max(len(per[b][k]) for b in range(d))
            max_n = -(-max_n // bpd) * bpd
            for b, band in enumerate(bands):
                if use_band and per[b][k]:
                    y0 = min(b * h_own + k * roll_h, max(0, h - 1))
                    self._read_band(band, source, y0, roll_h + tile, w)
            for start in range(0, max_n, bpd):
                for b, band in enumerate(bands):
                    self._run_chunk(band, source, coords,
                                    per[b][k][start:start + bpd],
                                    b * h_own + k * roll_h, use_band,
                                    wins[band.device])
            if k == 0:
                held = []
                for band in bands:
                    with band.context():
                        held.append([c[:tile].clone()
                                     for c in band.canvases()])
            if k < n_rolls - 1:
                for b, band in enumerate(bands):
                    with band.context():
                        emit(b, k * roll_h, band.accum[:roll_h],
                             band.weight[:roll_h],
                             None if band.var is None else band.var[:roll_h],
                             skip=tile if k == 0 else 0)
                        for c in band.canvases():
                            spill = c[roll_h:].clone()
                            c.zero_()
                            c[:tile] = spill
        self._exchange_halo(bands, roll_h, held)
        for b, band in enumerate(bands):
            with band.context():
                emit(b, (n_rolls - 1) * roll_h, band.accum[:roll_h],
                     band.weight[:roll_h],
                     None if band.var is None else band.var[:roll_h],
                     skip=tile if n_rolls == 1 else 0)
                hv = held[b]
                emit(b, 0, hv[0], hv[1], hv[2] if self.uncertainty else None)
        oh, ow = getattr(source, "orig_hw", (h, w))
        out = [prob_out[:oh, :ow], mask_out[:oh, :ow]]
        if self.uncertainty:
            out.append(unc_out[:oh, :ow])
        return tuple(out)

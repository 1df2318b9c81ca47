"""Procedural slide sources (the JAX package's ``data/synthetic.py``):
:class:`SyntheticSlideSource`, made on the host with numpy, and
:class:`DeviceSlideSource`, made on the device with torch.

The sources the timed whole-slide run and the band-input tests read: a
40k×40k slide streams through the sliding-window runners without the slide
(4.8 GB) ever existing in host RAM.
"""

from __future__ import annotations

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch import resolve_device


class _SlideGrid:
    """The window grid both sources share: ``coords`` (stride ``stride``,
    the last window flush with the edge), ``canvas_hw``, ``len()`` and
    ``get(i) → (tile_u8 numpy, (y, x))`` over the subclass's
    ``read_region``."""

    def __init__(self, size: int, tile: int, stride: int | None) -> None:
        self.size = size
        self.tile = tile
        self.stride = stride or tile
        ys = list(range(0, max(size - tile, 0) + 1, self.stride))
        if ys and ys[-1] != size - tile and size > tile:
            ys.append(size - tile)
        self.coords = [(y, x) for y in ys for x in ys]
        self.canvas_hw = (size, size)

    def __len__(self) -> int:
        return len(self.coords)

    def get(self, i: int):
        y, x = self.coords[i]
        tile = self.read_region(y, x, self.tile, self.tile)
        if isinstance(tile, torch.Tensor):
            tile = tile.cpu().numpy()
        return tile, (y, x)


class SyntheticSlideSource(_SlideGrid):
    """Procedural gigapixel-slide tile source — O(1) memory.

    The virtual slide is a grid of ``tile``-sized cells, each generated
    deterministically from its cell indices, so every pixel of the slide has
    one well-defined value: overlapping windows from ``get`` and arbitrary
    band reads from ``read_region`` agree exactly (the property the
    band-input runner's equality tests rely on).  Implements the tile-source
    protocol of ``infer.wsi.GridTiler`` (``len()``, ``get(i) → (tile_u8,
    (y, x))``, ``canvas_hw``) **plus** ``read_region(y, x, h, w)``.

    Roughly ``background_fraction`` of cells are blank glass (bright,
    unsaturated), the rest H&E-ish tissue with a purple blob — so
    ``tissue_threshold`` has something real to skip.
    """

    def __init__(self, size: int, tile: int = 512, stride: int | None = None,
                 seed: int = 0, background_fraction: float = 0.3) -> None:
        super().__init__(size, tile, stride)
        self.seed = seed
        self.background_fraction = background_fraction
        # overlapping windows / bands touch each cell up to ~9×; a small
        # FIFO cache keeps regeneration off the repeat touches without
        # holding more than a couple of band-rows of cells
        self._cell_cache: dict = {}
        self._cell_cache_cap = max(4 * (size // tile + 2), 64)

    def _cell(self, iy: int, ix: int) -> np.ndarray:
        """The (tile×tile×3) uint8 cell at cell-grid indices (iy, ix)."""
        cached = self._cell_cache.get((iy, ix))
        if cached is not None:
            return cached
        cell = self._make_cell(iy, ix)
        if len(self._cell_cache) >= self._cell_cache_cap:
            self._cell_cache.pop(next(iter(self._cell_cache)), None)
        self._cell_cache[(iy, ix)] = cell
        return cell

    def _make_cell(self, iy: int, ix: int) -> np.ndarray:
        t = self.tile
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + iy) * 1_000_003 + ix
        )
        if rng.random() < self.background_fraction:
            return np.full((t, t, 3), 244, np.uint8)
        # low-frequency field upsampled by kron: cheap, smooth "tissue"
        coarse = rng.normal(0, 1, (t // 32, t // 32, 3)).astype(np.float32)
        field = np.kron(coarse, np.ones((32, 32, 1), np.float32))
        img = np.array([225, 170, 195], np.float32) + 18.0 * field
        cy, cx = rng.integers(t // 4, 3 * t // 4, size=2)
        r = int(rng.integers(t // 8, t // 3))
        yy, xx = np.ogrid[:t, :t]
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[blob] = img[blob] * 0.5 + np.array([120, 60, 160]) * 0.5
        return np.clip(img, 0, 255).astype(np.uint8)

    def read_region(self, y: int, x: int, h: int, w: int) -> np.ndarray:
        """(h, w, 3) uint8 region at pixel (y, x); zero-filled outside the
        slide — the band-input read used by ``BandedSlidingWindow``."""
        t = self.tile
        out = np.zeros((h, w, 3), np.uint8)
        if y >= self.size or x >= self.size or y + h <= 0 or x + w <= 0:
            return out
        for iy in range(max(0, y // t), min(-(-(y + h) // t),
                                            -(-self.size // t))):
            for ix in range(max(0, x // t), min(-(-(x + w) // t),
                                                -(-self.size // t))):
                cell = self._cell(iy, ix)
                y0, y1 = max(y, iy * t), min(y + h, (iy + 1) * t, self.size)
                x0, x1 = max(x, ix * t), min(x + w, (ix + 1) * t, self.size)
                if y1 <= y0 or x1 <= x0:
                    continue
                out[y0 - y:y1 - y, x0 - x:x1 - x] = \
                    cell[y0 - iy * t:y1 - iy * t, x0 - ix * t:x1 - ix * t]
        return out


class DeviceSlideSource(_SlideGrid):
    """Procedural slide whose bands are made on the device: no host read
    and no upload.  The JAX ``DeviceSlideSource``'s field, an elementwise
    float32 function of the global pixel coordinates (a smooth H&E-like
    field and a ripple), so overlapping reads agree exactly;
    ``read_region(y, x, h, w)`` returns the uint8 ``(h, w, 3)`` tensor on
    ``device`` (default ``"cuda"``, which raises without a card), which the
    banded runner takes without a copy.  ``sin``/``cos`` may differ from
    XLA's by an ulp and the cast truncates, so its pixels equal the JAX
    source's within one level."""

    def __init__(self, size: int, tile: int = 512,
                 stride: int | None = None, seed: int = 0,
                 device="cuda") -> None:
        super().__init__(size, tile, stride)
        self.seed = seed
        self.device = resolve_device(device)

    def read_region(self, y: int, x: int, h: int, w: int) -> torch.Tensor:
        """(h, w, 3) uint8 tensor on the device at pixel (y, x), made on
        the current stream."""
        dev, f32 = self.device, torch.float32
        yy = (torch.arange(h, dtype=f32, device=dev)
              + float(y)).view(h, 1, 1)
        xx = (torch.arange(w, dtype=f32, device=dev)
              + float(x)).view(1, w, 1)
        phase = torch.tensor([0.0, 2.1, 4.2], dtype=f32,
                             device=dev) + float(self.seed)
        base = torch.tensor([225.0, 170.0, 195.0], dtype=f32, device=dev)
        # the JAX expression, operation for operation
        v = (base
             + 18.0 * torch.sin(yy / 97.0 + phase) * torch.cos(xx / 89.0)
             - 60.0 * torch.clamp_min(
                 torch.sin(yy / 253.0 + phase) * torch.sin(xx / 241.0)
                 - 0.6, 0.0) * 2.5)
        return torch.clamp(v, 0, 255).to(torch.uint8)

"""Plain reference of a whole-slide overlay at sampled blocks.

The slide is the procedural field of the program's ``DeviceSlideSource``,
written here again from its formula (an elementwise float32 function of
the global pixel coordinates, truncated to uint8).  The overlay of a
``block``² square at block-aligned ``(y, x)`` is worked out from the
windows that cover it alone: each window is cut from the field, run
through the plain model in float32 (``reference/models.py``), its
sigmoid weighted by the blend window, summed, and divided by the summed
blend weights, as overlap-blend stitching defines it.  The windows lie on
the slide's grid: stride ``stride``, the last flush with the edge.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models import normalize_u8


def field(y: int, x: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """(h, w, 3) uint8 pixels of the slide at (y, x)."""
    f32 = torch.float32
    yy = (torch.arange(h, dtype=f32, device=device) + float(y)).view(h, 1, 1)
    xx = (torch.arange(w, dtype=f32, device=device) + float(x)).view(1, w, 1)
    phase = torch.tensor([0.0, 2.1, 4.2], dtype=f32,
                         device=device) + float(seed)
    base = torch.tensor([225.0, 170.0, 195.0], dtype=f32, device=device)
    v = (base
         + 18.0 * torch.sin(yy / 97.0 + phase) * torch.cos(xx / 89.0)
         - 60.0 * torch.clamp_min(
             torch.sin(yy / 253.0 + phase) * torch.sin(xx / 241.0)
             - 0.6, 0.0) * 2.5)
    return torch.clamp(v, 0, 255).to(torch.uint8)


def blend_window(tile: int, mode: str) -> np.ndarray:
    """The (tile, tile) float32 blend weights: ``hann`` is the separable
    raised cosine at half-pixel centres, floored at 1e-3; ``uniform`` 1."""
    if mode == "uniform":
        return np.ones((tile, tile), np.float32)
    if mode != "hann":
        raise ValueError(f"unknown blend {mode!r}")
    w1 = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
    w1 = np.maximum(w1, 1e-3).astype(np.float32)
    return np.outer(w1, w1)


def grid(size: int, tile: int, stride: int) -> list:
    """Window origins along one axis."""
    ys = list(range(0, max(size - tile, 0) + 1, stride))
    if ys[-1] != size - tile and size > tile:
        ys.append(size - tile)
    return ys


def covering(origins: list, lo: int, hi: int, tile: int) -> list:
    return [o for o in origins if o < hi and o + tile > lo]


def block_windows(blocks, size: int, tile: int, stride: int) -> list:
    """The distinct window origins ``(y, x)`` that cover the blocks
    ``(y, x, side)``, in a fixed order."""
    origins = grid(size, tile, stride)
    seen = {}
    for by, bx, side in blocks:
        for wy in covering(origins, by, by + side, tile):
            for wx in covering(origins, bx, bx + side, tile):
                seen.setdefault((wy, wx), None)
    return list(seen)


def first_windows(n: int, size: int, tile: int, stride: int, seed: int,
                  device) -> torch.Tensor:
    """(n, tile, tile, 3) uint8: the slide's first ``n`` windows in
    row-major order of the grid, where int8 serving calibrates."""
    origins = grid(size, tile, stride)
    at = [(y, x) for y in origins for x in origins][:n]
    return torch.stack([field(y, x, tile, tile, seed, device)
                        for y, x in at])


@torch.no_grad()
def window_probs(model, windows, seed: int, tile: int, device,
                 batch: int) -> dict:
    """``{(y, x): float32 (tile, tile) sigmoid probabilities on device}``
    of the windows, computed by ``model`` in batches of ``batch``."""
    out = {}
    model.eval()
    for i in range(0, len(windows), batch):
        chunk = windows[i:i + batch]
        imgs = torch.stack([field(y, x, tile, tile, seed, device)
                            for y, x in chunk])
        probs = torch.sigmoid(model(normalize_u8(imgs))[:, 0].float())
        for (y, x), p in zip(chunk, probs):
            out[(y, x)] = p
    return out


def block_overlay(probs: dict, block, size: int, tile: int, stride: int,
                  blend: str, device) -> torch.Tensor:
    """The stitched float32 probabilities of block ``(y, x, side)``."""
    by, bx, side = block
    win = torch.from_numpy(blend_window(tile, blend)).to(device)
    origins = grid(size, tile, stride)
    acc = torch.zeros((side, side), dtype=torch.float32, device=device)
    wsum = torch.zeros_like(acc)
    for wy in covering(origins, by, by + side, tile):
        for wx in covering(origins, bx, bx + side, tile):
            y0, x0 = max(by, wy), max(bx, wx)
            y1, x1 = min(by + side, wy + tile), min(bx + side, wx + tile)
            sl = (slice(y0 - wy, y1 - wy), slice(x0 - wx, x1 - wx))
            dst = (slice(y0 - by, y1 - by), slice(x0 - bx, x1 - bx))
            acc[dst] += probs[(wy, wx)][sl] * win[sl]
            wsum[dst] += win[sl]
    return torch.where(wsum > 0, acc / wsum.clamp_min(1e-12), 0.0)

"""Overlap-blend stitching for sliding-window WSI inference (the JAX
package's ``ops/stitch.py``), on device tensors.

Predicted probability tiles are weighted by a blend window and added into
a canvas, with a matching weight canvas; the final map is
``accum / weight``, seamless across tile boundaries when tiles overlap (the
reference's 0-overlap paste is ``blend="uniform"`` with stride == tile).

Tiles are added one after another, in tile order, by in-place slice adds
(the JAX package's ``lax.scan``): overlapping sums never depend on how
atomics interleave, so a stitched map repeats bit for bit run to run.  The
canvases are updated in place (the JAX package donates them).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _blend_window_np(tile: int, mode: str) -> np.ndarray:
    if mode == "uniform":
        return np.ones((tile, tile), dtype=np.float32)
    if mode == "hann":
        # separable raised-cosine, >0 everywhere so division is safe even
        # for non-overlapping tiles
        w1 = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
        w1 = np.maximum(w1, 1e-3).astype(np.float32)
        return np.outer(w1, w1)
    if mode == "pyramid":
        r = np.arange(tile, dtype=np.float32)
        w1 = np.minimum(r + 1.0, tile - r)
        w1 /= w1.max()
        return np.outer(w1, w1)
    raise ValueError(f"unknown blend mode {mode!r}")


def blend_window(tile: int, mode: str = "hann", device="cpu") -> torch.Tensor:
    """The ``(tile, tile)`` float32 blend window on ``device``."""
    return torch.from_numpy(_blend_window_np(tile, mode)).to(device)


def stitch_tiles(probs: torch.Tensor, coords, canvas_hw: tuple,
                 blend: str = "hann") -> tuple:
    """Add ``probs`` (``(T, t, t)`` binary or ``(T, t, t, C)`` channelled,
    float32) at ``coords`` (``(T, 2)`` top-left ``(y, x)``, host ints) into
    fresh canvases on ``probs``' device; returns ``(accum, weight)``.

    Channelled tiles get an ``(h, w, C)`` accumulation canvas; the weight
    canvas is always 2-D (every class shares the blend window)."""
    h, w = canvas_hw
    shape = (h, w) if probs.ndim == 3 else (h, w, probs.shape[-1])
    accum = torch.zeros(shape, dtype=torch.float32, device=probs.device)
    weight = torch.zeros((h, w), dtype=torch.float32, device=probs.device)
    return stitch_tiles_into(accum, weight, probs, coords, blend=blend)


def stitch_tiles_into(accum: torch.Tensor, weight: torch.Tensor,
                      probs: torch.Tensor, coords,
                      blend: str = "hann") -> tuple:
    """Add a chunk of tiles into existing canvases, in place and in tile
    order; returns ``(accum, weight)``.  A window that would cross the
    canvas edge is shifted inside it, as ``lax.dynamic_slice`` clamps."""
    tile = probs.shape[1]
    win = blend_window(tile, blend, accum.device)
    weighted = probs.float() * (win[..., None] if probs.ndim == 4 else win)
    h, w = weight.shape
    yx = np.asarray(coords.cpu() if torch.is_tensor(coords) else coords,
                    np.int64).reshape(-1, 2)
    for i, (y, x) in enumerate(yx.tolist()):
        y = min(max(y, 0), h - tile)
        x = min(max(x, 0), w - tile)
        accum[y:y + tile, x:x + tile] += weighted[i]
        weight[y:y + tile, x:x + tile] += win
    return accum, weight


def finalize_canvas(accum: torch.Tensor, weight: torch.Tensor,
                    threshold: float = 0.5) -> tuple:
    """Blend-normalize and decide: ``(probability map, hard mask)``.
    Binary canvases threshold at ``threshold`` (the reference's 0.5,
    ``test.py:143``); channelled canvases take the argmax over classes.
    Pixels never covered by a tile get probability 0 (class 0)."""
    if accum.ndim == 3:  # (h, w, C) multi-class canvas, 2-D weight
        w = weight.clamp_min(1e-12)[..., None]
        prob = torch.where(weight[..., None] > 0, accum / w, 0.0)
        return prob, prob.argmax(dim=-1).to(torch.uint8)
    prob = torch.where(weight > 0, accum / weight.clamp_min(1e-12), 0.0)
    return prob, (prob >= threshold).to(torch.uint8)

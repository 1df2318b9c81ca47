"""Tissue/background thresholding for WSI tiling (the JAX package's
``ops/tissue.py``).

H&E background is bright and unsaturated; tissue is stained.  A pixel is
tissue when its HSV saturation exceeds a threshold and it is neither
blown-out white nor pen/black:

    tissue(p) = sat(p) > sat_thresh  ∧  value(p) < white_thresh
                ∧ value(p) > black_thresh

A numpy host version (the tilers' keep/skip decision) and a tensor version
that runs on the tensor's device.  Both take float32 steps in the JAX
order, so the masks equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

SAT_THRESH = 0.07
WHITE_THRESH = 0.95
BLACK_THRESH = 0.05


def _sat_val(rgb01):
    mx = rgb01.max(axis=-1)
    mn = rgb01.min(axis=-1)
    sat = (mx - mn) / (mx + 1e-8)
    return sat, mx


def tissue_mask_np(
    img: np.ndarray,  # H,W,3 uint8 (or [0,1] float)
    sat_thresh: float = SAT_THRESH,
    white_thresh: float = WHITE_THRESH,
    black_thresh: float = BLACK_THRESH,
) -> np.ndarray:
    rgb = img.astype(np.float32)
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    sat, val = _sat_val(rgb)
    return (sat > sat_thresh) & (val < white_thresh) & (val > black_thresh)


def tissue_fraction_np(img: np.ndarray, **kw) -> float:
    return float(tissue_mask_np(img, **kw).mean())


def tissue_mask(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel tissue mask of a uint8/float ``(..., H, W, 3)`` tensor, on
    its device."""
    rgb = img.to(torch.float32)
    rgb = torch.where(rgb.max() > 1.5, rgb / 255.0, rgb)
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    sat = (mx - mn) / (mx + 1e-8)
    return (sat > SAT_THRESH) & (mx < WHITE_THRESH) & (mx > BLACK_THRESH)


def tissue_fraction(tiles: torch.Tensor) -> torch.Tensor:
    """Per-tile tissue fraction of a batch ``(N, H, W, 3)`` → ``(N,)``."""
    return tissue_mask(tiles).to(torch.float32).mean(dim=(1, 2))

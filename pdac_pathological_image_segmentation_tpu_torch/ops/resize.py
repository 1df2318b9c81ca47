"""Bilinear / nearest resize with the JAX package's conventions
(``ops/resize.py`` there), on NCHW tensors.

Bilinear has no antialias: ``align_corners=False`` is half-pixel centres
(torch ``interpolate`` / cv2 ``INTER_LINEAR``), ``align_corners=True`` is
corner-aligned (smp's ``UpsamplingBilinear2d``).  Nearest takes source
index ``floor(dst * in / out)`` (cv2 ``INTER_NEAREST``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of a floating NCHW tensor, computed in its dtype."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=align_corners, antialias=False)


def _nearest_index(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    idx = torch.floor(torch.arange(out_size, dtype=torch.float64)
                      * (in_size / out_size)).long()
    return idx.clamp_(0, in_size - 1).to(device)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize over the last two axes (any dtype)."""
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    x = x.index_select(-2, _nearest_index(in_h, out_h, x.device))
    return x.index_select(-1, _nearest_index(in_w, out_w, x.device))

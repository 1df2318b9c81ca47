"""U-Net++ (nested U-Net) on any encoder of ``models/encoders.py`` (the JAX
package's ``models/unetplusplus.py``, in NCHW).  A framework extension:
the reference offers no such model and no reference checkpoint exists, so
its names mirror the flax tree: ``encoder.*`` (torchvision's or
efficientnet-pytorch's),
``x_{i}_{j}.{conv0,bn0,conv1,bn1}`` and ``head``.

Node ``X(i, j)``, j ≥ 1, takes the dense skips ``X(i, 0..j-1)`` and, last,
the nearest 2× upsample of ``X(i+1, j-1)``, concatenated; each node is two
3×3 conv + BN + ReLU with ``decoder_channels[max(3 - i, 0)]`` channels.
``X(i, 0)`` are the encoder features at strides (2, 4, 8, 16, 32).  The
last column ends at stride 2; a 3×3 head with a bias and a half-pixel
(``align_corners=False``) bilinear 2× in float32 give logits, NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pdac_pathological_image_segmentation_tpu_torch.models.encoders import (
    build_encoder,
    encoder_feature_channels,
)
from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    BN_EPS,
    Conv2d,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
)

DEPTH = 4  # decoder rows: encoder levels 0..4


class DoubleConv(nn.Module):
    def __init__(self, cin: int, channels: int) -> None:
        super().__init__()
        self.conv0 = Conv2d(cin, channels, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(channels, eps=BN_EPS)
        self.conv1 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


def _nodes():
    """``(i, j)`` in the order the decoder computes them."""
    return [(i, j) for j in range(1, DEPTH + 1) for i in range(DEPTH + 1 - j)]


class UNetPlusPlus(nn.Module):
    def __init__(self, num_classes: int = 1, output_size: int = 512,
                 backbone: str = "resnet18",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32),
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.output_size = output_size
        self.compute_dtype = compute_dtype
        self.encoder = build_encoder(backbone)
        feats = encoder_feature_channels(backbone)
        last = len(decoder_channels) - 1
        width = {(i, 0): c for i, c in enumerate(feats)}
        for i, j in _nodes():
            width[i, j] = decoder_channels[max(last - i, 0)]
            cin = sum(width[i, k] for k in range(j)) + width[i + 1, j - 1]
            setattr(self, f"x_{i}_{j}", DoubleConv(cin, width[i, j]))
        self.head = Conv2d(width[0, DEPTH], num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: NCHW normalized images; returns float32 NCHW logits at
        ``output_size``.  ``generator`` is the train step's (U-Net++ has no
        dropout to feed)."""
        grid = dict(((i, 0), f) for i, f in
                    enumerate(self.encoder(x.to(self.compute_dtype))))
        for i, j in _nodes():
            up = F.interpolate(grid[i + 1, j - 1], scale_factor=2,
                               mode="nearest")
            skips = [grid[i, k] for k in range(j)]
            grid[i, j] = getattr(self, f"x_{i}_{j}")(torch.cat(skips + [up],
                                                              dim=1))
        y = self.head(grid[0, DEPTH])
        return resize_bilinear(y.float(), self.output_size, self.output_size)

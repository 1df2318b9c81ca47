"""PSPNet with smp's ``state_dict`` names (the JAX package's
``models/pspnet.py``, in NCHW), so a reference ``.pth`` of
``smp.PSPNet(encoder_name=backbone, psp_use_batchnorm=True)`` loads with
``strict=True``.

Encoder depth 3 (smp's default for PSPNet): the deepest feature is c3, at
stride 8.  Pyramid pooling over bins (1, 2, 3, 6)
(``decoder.psp.blocks.{0..3}``): adaptive average pool → 1×1 conv to
``C/4`` channels + BN + ReLU (the 1×1 bin has no BN and its conv a bias,
as smp builds it) → corner-aligned bilinear up to c3's size in float32,
cast back.  Concatenated as ``[branches..., c3]`` (identity last) → 1×1
conv to 512 + BN + ReLU (``decoder.conv``) → ``Dropout2d(0.2)`` → 3×3
head (``segmentation_head.0``) → 8× corner-aligned bilinear up in float32.
The output is logits, NCHW.

The encoder builds its stages past c3 (ResNet's ``layer3``/``layer4``,
MobileNetV2's ``features.7``-``18``, EfficientNet's later ``_blocks``),
because smp's ``state_dict`` and the reference's ``test.py`` carry them,
but does not run them: they get no gradient, no Adam state and no BN
update.  (The JAX encoder runs every stage, so its train step updates
those stages' BN statistics, which reach no output.)
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
    Dropout2d,
)
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

POOL_SIZES = (1, 2, 3, 6)


class PSPBlock(nn.Module):
    """smp's ``PSPBlock``: ``pool = Sequential(AdaptiveAvgPool2d(s),
    Sequential(conv, BN or Identity, ReLU))``."""

    def __init__(self, cin: int, cout: int, pool_size: int) -> None:
        super().__init__()
        use_bn = pool_size > 1
        self.pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(pool_size),
            nn.Sequential(
                Conv2d(cin, cout, 1, bias=not use_bn),
                nn.BatchNorm2d(cout, eps=BN_EPS) if use_bn else nn.Identity(),
                nn.ReLU()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pool(x)
        return resize_bilinear(y.float(), x.shape[2], x.shape[3],
                               align_corners=True).to(x.dtype)


class PSPModule(nn.Module):
    def __init__(self, cin: int, pool_sizes: Sequence[int]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            PSPBlock(cin, cin // len(pool_sizes), s) for s in pool_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([block(x) for block in self.blocks] + [x], dim=1)


class PSPDecoder(nn.Module):
    def __init__(self, cin: int, out_channels: int = 512,
                 pool_sizes: Sequence[int] = POOL_SIZES,
                 dropout: float = 0.2) -> None:
        super().__init__()
        self.psp = PSPModule(cin, pool_sizes)
        self.conv = nn.Sequential(
            Conv2d(cin * 2, out_channels, 1, bias=False),
            nn.BatchNorm2d(out_channels, eps=BN_EPS), nn.ReLU())
        self.dropout = Dropout2d(dropout)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.dropout(self.conv(self.psp(x)), generator)


class PSPNet(nn.Module):
    def __init__(self, num_classes: int = 1, output_size: int = 512,
                 backbone: str = "resnet18",
                 compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.2) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.output_size = output_size
        self.compute_dtype = compute_dtype
        self.encoder = build_encoder(backbone, depth=3)
        self.decoder = PSPDecoder(encoder_feature_channels(backbone)[2],
                                  dropout=dropout)
        self.segmentation_head = nn.Sequential(
            Conv2d(512, num_classes, 3, padding=1))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: NCHW normalized images; returns float32 NCHW logits at
        ``output_size``.  ``generator`` feeds Dropout2d in train mode."""
        _, _, c3 = self.encoder(x.to(self.compute_dtype))
        y = self.segmentation_head(self.decoder(c3, generator))
        return resize_bilinear(y.float(), self.output_size, self.output_size,
                               align_corners=True)

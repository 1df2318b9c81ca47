"""DeepLabV3+ with smp's ``state_dict`` names (the JAX package's
``models/deeplabv3plus.py``, in NCHW), so a reference ``.pth`` of
``smp.DeepLabV3Plus(encoder_name=backbone, decoder_atrous_rates=dilations)``
loads with ``strict=True``.

Encoder at output stride 16 (the last stage's stride becomes dilation 2)
→
ASPP over c5: a 1×1 branch, three depthwise-separable atrous branches at
the config's rates (``decoder.aspp.0.convs.{0..3}``), and an image-pooling
branch (mean → 1×1 conv + BN + ReLU → broadcast, ``convs.4``) →
concatenation → 1×1 project + BN + ReLU + elementwise ``Dropout(0.5)``
(``decoder.aspp.0.project``) → separable 3×3 + BN + ReLU
(``decoder.aspp.{1,2}``) → 4× corner-aligned bilinear up → concatenation
with the 48-channel projected stride-4 skip (``decoder.block1``) →
separable 3×3 + BN + ReLU (``decoder.block2``) → 1×1 head
(``segmentation_head.0``) → 4× corner-aligned bilinear up in float32.
Both resizes are taken in float32, as the JAX model takes them; the first
is cast back to the compute dtype.  The output is logits, NCHW.

A separable conv is a depthwise 3×3 (``groups`` = its input channels,
dilated at the branch's rate) then a pointwise 1×1, neither with a bias.
The dropout mask is drawn on the activation's device
(``models/dropout.py::Dropout``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
    Dropout,
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


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS)


def _separable(cin: int, cout: int, dilation: int = 1) -> nn.Sequential:
    """smp's ``SeparableConv2d``: depthwise (``.0``) then pointwise
    (``.1``)."""
    return nn.Sequential(
        Conv2d(cin, cin, 3, padding=dilation, dilation=dilation, groups=cin,
               bias=False),
        Conv2d(cin, cout, 1, bias=False))


class ASPP(nn.Module):
    """smp's ``ASPP``: ``convs.{0..4}`` and ``project`` (whose index 3 is
    the dropout)."""

    def __init__(self, cin: int, channels: int, rates: Sequence[int],
                 dropout: float) -> None:
        super().__init__()
        convs = [nn.Sequential(Conv2d(cin, channels, 1, bias=False),
                               _bn(channels), nn.ReLU())]
        for rate in rates:
            convs.append(nn.Sequential(_separable(cin, channels, rate),
                                       _bn(channels), nn.ReLU()))
        # smp's ASPPPooling: AdaptiveAvgPool2d(1), conv, BN, ReLU
        convs.append(nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                   Conv2d(cin, channels, 1, bias=False),
                                   _bn(channels), nn.ReLU()))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            Conv2d(len(convs) * channels, channels, 1, bias=False),
            _bn(channels), nn.ReLU(), Dropout(dropout))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        branches = [conv(x) for conv in self.convs[:-1]]
        pool = self.convs[-1]
        pooled = x.mean(dim=(2, 3), keepdim=True)
        for layer in pool[1:]:
            pooled = layer(pooled)
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        y = self.project[:3](torch.cat(branches, dim=1))
        return self.project[3](y, generator)


class DeepLabV3PlusDecoder(nn.Module):
    def __init__(self, encoder_channels, rates: Sequence[int],
                 channels: int = 256, dropout: float = 0.5) -> None:
        super().__init__()
        c2, c5 = encoder_channels[1], encoder_channels[4]
        self.aspp = nn.Sequential(ASPP(c5, channels, rates, dropout),
                                  _separable(channels, channels),
                                  _bn(channels), nn.ReLU())
        self.block1 = nn.Sequential(Conv2d(c2, 48, 1, bias=False), _bn(48),
                                    nn.ReLU())
        self.block2 = nn.Sequential(_separable(channels + 48, channels),
                                    _bn(channels), nn.ReLU())

    def forward(self, c2: torch.Tensor, c5: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = self.aspp[1:](self.aspp[0](c5, generator))
        # stride 16 → stride 4: smp's UpsamplingBilinear2d (corner-aligned)
        y = resize_bilinear(y.float(), c2.shape[2], c2.shape[3],
                            align_corners=True).to(c2.dtype)
        return self.block2(torch.cat([y, self.block1(c2)], dim=1))


class DeepLabV3Plus(nn.Module):
    def __init__(self, num_classes: int = 1, output_size: int = 512,
                 backbone: str = "resnet18",
                 atrous_rates: Sequence[int] = (3, 6, 9),
                 compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.5) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.output_size = output_size
        self.compute_dtype = compute_dtype
        self.atrous_rates = tuple(int(r) for r in atrous_rates)
        self.encoder = build_encoder(backbone, output_stride=16)
        self.decoder = DeepLabV3PlusDecoder(
            encoder_feature_channels(backbone), self.atrous_rates,
            dropout=dropout)
        # smp's DeepLabV3Plus passes kernel_size=1 to its SegmentationHead
        self.segmentation_head = nn.Sequential(Conv2d(256, num_classes, 1))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: NCHW normalized images; returns float32 NCHW logits at
        ``output_size``.  ``generator`` seeds the ASPP dropout in train
        mode."""
        _, c2, _, _, c5 = self.encoder(x.to(self.compute_dtype))
        y = self.segmentation_head(self.decoder(c2, c5, generator))
        return resize_bilinear(y.float(), self.output_size, self.output_size,
                               align_corners=True)


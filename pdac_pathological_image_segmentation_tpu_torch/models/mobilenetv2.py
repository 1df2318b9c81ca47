"""MobileNetV2 encoder with torchvision's topology and ``state_dict`` names
(the JAX package's ``models/mobilenetv2.py``, in NCHW).

The modules nest as torchvision's ``mobilenet_v2().features``, so smp's
``encoder.features.*`` keys and torchvision's ImageNet files load
strictly:

* ``features.0.{0,1}``: the 3×3/2 stem conv and its BN (then ReLU6);
* ``features.1.conv.{0.0,0.1,1,2}``: the expand-ratio-1 block (depthwise
  conv + BN, then the 1×1 projection and its BN);
* ``features.i.conv.{0.0,0.1,1.0,1.1,2,3}``: the expand-ratio-6 blocks
  (1×1 expand, 3×3 depthwise, 1×1 projection, each with its BN);
* ``features.18.{0,1}``: the 1×1 conv to 1280 channels.

ReLU6 follows every conv but the projection; a block adds its input when
its stride is 1 and its channels do not change.  BatchNorm takes eps 1e-5
and torch momentum 0.1.  Padding is symmetric, ``(k − 1) // 2 · d``.
smp's stage splits over ``features`` are ``(2, 4, 7, 14, 19)``: the
forward returns ``[c1..c5]`` at strides ``[2, 4, 8, 16, 32]`` with
channels ``[16, 24, 32, 96, 1280]``.

``output_stride=16`` (DeepLabV3+) turns the first stride-2 block past the
output stride into stride 1 and doubles the dilation from there on, on the
depthwise convs (the 1×1 convs are unchanged by a dilation).  ``depth``
stops the forward after ``c{depth}``, as ``ResNetEncoder`` does.
torchvision's classifier (``classifier.*``) is not built
(:attr:`MobileNetV2Encoder.unbuilt_keys`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    Conv2d,
    check_encoder_args,
)

BN_EPS = 1e-5
# torchvision's inverted_residual_setting: (expand t, channels, blocks, stride)
IR_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
# smp's stage boundaries over features[0..18]
STAGE_SPLITS = (2, 4, 7, 14, 19)
FEATURE_CHANNELS = [16, 24, 32, 96, 1280]


class ConvBNReLU6(nn.Sequential):
    """torchvision's ``Conv2dNormActivation``: conv (``.0``), BN (``.1``),
    ReLU6."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1) -> None:
        super().__init__(
            Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2 * dilation,
                   dilation, groups, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS), nn.ReLU6())


class InvertedResidual(nn.Module):
    """torchvision's ``InvertedResidual``: [1×1 expand] → 3×3 depthwise →
    1×1 linear projection, in ``conv``."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 dilation: int) -> None:
        super().__init__()
        hidden = cin * expand
        layers = [] if expand == 1 else [ConvBNReLU6(cin, hidden, 1)]
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, dilation, hidden),
                   Conv2d(hidden, cout, 1, bias=False),
                   nn.BatchNorm2d(cout, eps=BN_EPS)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + x if self.residual else y


class MobileNetV2Encoder(nn.Module):
    """MobileNetV2 feature extractor without the classifier."""

    unbuilt_keys = ("classifier.",)

    def __init__(self, output_stride: int = 32, depth: int = 5) -> None:
        super().__init__()
        check_encoder_args(output_stride, depth)
        self.depth = depth
        features: List[nn.Module] = [ConvBNReLU6(3, 32, 3, 2)]
        cin, current_stride, dilation = 32, 2, 1
        for t, c, n, s in IR_SETTING:
            for b in range(n):
                stride = s if b == 0 else 1
                if stride == 2 and current_stride >= output_stride:
                    stride, dilation = 1, dilation * 2
                elif stride == 2:
                    current_stride *= 2
                features.append(InvertedResidual(cin, c, stride, t, dilation))
                cin = c
        features.append(ConvBNReLU6(cin, 1280, 1))
        self.features = nn.Sequential(*features)

    @staticmethod
    def feature_channels() -> List[int]:
        return list(FEATURE_CHANNELS)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``[c1, …, c{depth}]``."""
        feats, start = [], 0
        for end in STAGE_SPLITS[:self.depth]:
            for block in self.features[start:end]:
                x = block(x)
            feats.append(x)
            start = end
        return feats

"""Encoder factory — the smp ``encoder_name=`` dispatch point (the JAX
package's ``models/encoders.py``): the ResNet family, ``mobilenet_v2`` and
``efficientnet-b0``…``b7``.  Every encoder returns ``[c1..c5]`` at strides
``[2, 4, 8, 16, 32]``, the strides past ``output_stride`` turned into
dilations, and stops after ``c{depth}``.  Each names, in
``unbuilt_keys``, the classifier of its torchvision/efficientnet-pytorch
layout, which it does not build."""

from __future__ import annotations

from typing import List

import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.models import efficientnet
from pdac_pathological_image_segmentation_tpu_torch.models.efficientnet import (
    EfficientNetEncoder,
)
from pdac_pathological_image_segmentation_tpu_torch.models.mobilenetv2 import (
    MobileNetV2Encoder,
)
from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    RESNET_CFGS,
    ResNetEncoder,
)

VALID_BACKBONES = (tuple(RESNET_CFGS) + ("mobilenet_v2",)
                   + tuple(efficientnet.VARIANTS))


def build_encoder(backbone: str, output_stride: int = 32,
                  depth: int = 5) -> nn.Module:
    if backbone == "mobilenet_v2":
        return MobileNetV2Encoder(output_stride, depth)
    if backbone in efficientnet.VARIANTS:
        return EfficientNetEncoder(backbone, output_stride, depth)
    if backbone in RESNET_CFGS:
        return ResNetEncoder(backbone, output_stride, depth)
    raise ValueError(
        f"unknown backbone {backbone!r}; supported: {VALID_BACKBONES}")


def encoder_feature_channels(backbone: str) -> List[int]:
    if backbone == "mobilenet_v2":
        return MobileNetV2Encoder.feature_channels()
    if backbone in efficientnet.VARIANTS:
        return efficientnet.feature_channels(backbone)
    if backbone in RESNET_CFGS:
        return ResNetEncoder.feature_channels(backbone)
    raise ValueError(
        f"unknown backbone {backbone!r}; supported: {VALID_BACKBONES}")

"""Encoder factory — the smp ``encoder_name=`` dispatch point (the JAX
package's ``models/encoders.py``).  The port has the ResNet family so far;
every encoder returns ``[c1..c5]`` at strides ``[2, 4, 8, 16, 32]``, the
strides past ``output_stride`` turned into dilations, and stops after
``c{depth}``."""

from __future__ import annotations

from typing import List

import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    RESNET_CFGS,
    ResNetEncoder,
)

VALID_BACKBONES = tuple(RESNET_CFGS)
_NOT_PORTED = ("mobilenet_v2 and efficientnet-b0..b7 are not ported yet "
               "(ROADMAP.md Queue 1, item 4: the encoder families)")


def build_encoder(backbone: str, output_stride: int = 32,
                  depth: int = 5) -> nn.Module:
    if backbone in RESNET_CFGS:
        return ResNetEncoder(backbone, output_stride, depth)
    if backbone == "mobilenet_v2" or backbone.startswith("efficientnet"):
        raise NotImplementedError(f"backbone {backbone!r}: {_NOT_PORTED}")
    raise ValueError(
        f"unknown backbone {backbone!r}; supported: {VALID_BACKBONES}")


def encoder_feature_channels(backbone: str) -> List[int]:
    if backbone in RESNET_CFGS:
        return ResNetEncoder.feature_channels(backbone)
    if backbone == "mobilenet_v2" or backbone.startswith("efficientnet"):
        raise NotImplementedError(f"backbone {backbone!r}: {_NOT_PORTED}")
    raise ValueError(
        f"unknown backbone {backbone!r}; supported: {VALID_BACKBONES}")

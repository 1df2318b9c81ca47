"""ResUNet, the reference's own model, with its ``state_dict`` names (the
JAX package's ``models/resunet.py``, in NCHW).

* The encoder is torchvision's resnet18 (``encoder.*``).  The skips come
  from layer3, layer2 and layer1; the stem feature is computed but never
  concatenated (the reference's quirk: the max-pooled stem only feeds
  layer1).
* The decoder is three rounds of ``ConvTranspose2d(k=2, s=2)`` → concat
  with the skip → 3×3 conv with bias → ReLU, over 512 → 256 → 128 → 64
  channels, with no normalization (``upconv1-3``, ``conv1-3``).
* ``conv4`` is a 1×1 head at ¼ resolution, then one half-pixel
  (``align_corners=False``) bilinear resize to ``output_size`` in
  ``head_dtype`` (float32 by default; bfloat16 is a serving option).  The
  output is logits, NCHW, in ``head_dtype``.

The JAX package's ``ConcatConv``, ``UpConv``, ``PointwiseHead`` and
``stage0_residual_barrier`` are TPU lowerings of the same math; here the
concat is ``torch.cat`` and the head a plain 1×1 conv.

A reference checkpoint also carries ``encoder.fc.*`` (torchvision keeps its
classifier), which the encoder does not build (its ``unbuilt_keys``);
loaders drop it (``utils/torch_weights.py::drop_unbuilt_keys``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    Conv2d,
    ConvTranspose2d,
    ResNetEncoder,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
)


class ResUNet(nn.Module):
    def __init__(self, num_classes: int = 1, output_size: int = 512,
                 compute_dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.output_size = output_size
        self.compute_dtype = compute_dtype
        self.head_dtype = head_dtype
        self.encoder = ResNetEncoder("resnet18")
        self.upconv1 = ConvTranspose2d(512, 256, 2, stride=2)
        self.conv1 = Conv2d(512, 256, 3, padding=1)
        self.upconv2 = ConvTranspose2d(256, 128, 2, stride=2)
        self.conv2 = Conv2d(256, 128, 3, padding=1)
        self.upconv3 = ConvTranspose2d(128, 64, 2, stride=2)
        self.conv3 = Conv2d(128, 64, 3, padding=1)
        self.conv4 = Conv2d(64, num_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: NCHW normalized images; returns NCHW logits at
        ``output_size`` in ``head_dtype``.  ``generator`` is the train
        step's (ResUNet has no dropout to feed)."""
        _, x2, x3, x4, x5 = self.encoder(x.to(self.compute_dtype))
        y = F.relu(self.conv1(torch.cat([self.upconv1(x5), x4], dim=1)))
        y = F.relu(self.conv2(torch.cat([self.upconv2(y), x3], dim=1)))
        y = F.relu(self.conv3(torch.cat([self.upconv3(y), x2], dim=1)))
        y = self.conv4(y).to(self.head_dtype)
        return resize_bilinear(y, self.output_size, self.output_size)

"""FPN segmentation model with smp's ``state_dict`` names (the JAX
package's ``models/fpn.py``, in NCHW).

Encoder (``models/encoders.py``) → top-down pyramid (256-channel 1×1 laterals, nearest 2×
upsampling) → per-level segmentation blocks (3×3 conv + GroupNorm(32) +
ReLU, nearest 2× upsampling to stride 4) → sum → Dropout2d (a no-op in
eval) → 1×1 head → corner-aligned bilinear upsample to ``output_size`` in
float32.  The output is logits, NCHW.

Every GroupNorm+ReLU goes through ``ops.group_norm.group_norm_relu_trainable``:
the hand-written forward kernel on a CUDA device, the plain version on the
CPU, and, when a gradient is wanted, ``GroupNormReLUFunction``, whose
backward is the hand-written backward kernel (plain on the CPU), so that
autograd follows both.  (The JAX package makes its Pallas kernel opt-in
through ``fpn_pallas_gn`` because of TPU layout copies around the custom
call; the card has no such cost, so the port has no such switch.)

In train mode BatchNorm takes batch statistics (torch's momentum 0.1 is
flax's 0.9) and Dropout2d (``models/dropout.py``) draws its per-(n, c)
mask from the generator passed to :meth:`FPN.forward`, never from the
global RNG.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
    Dropout2d,
)
from pdac_pathological_image_segmentation_tpu_torch.models.encoders import (
    build_encoder,
    encoder_feature_channels,
)
from pdac_pathological_image_segmentation_tpu_torch.models.resnet import Conv2d
from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
    group_norm_relu_trainable,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
)

GN_EPS = 1e-5  # torch nn.GroupNorm's default, what smp's Conv3x3GNReLU uses


def _upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class GroupNormReLU(nn.Module):
    """GroupNorm(32, eps=1e-5) + ReLU with ``nn.GroupNorm``'s parameters
    (float32 ``weight``/``bias``)."""

    def __init__(self, channels: int, num_groups: int = 32) -> None:
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_relu_trainable(x, self.weight, self.bias,
                                         num_groups=self.num_groups,
                                         eps=GN_EPS)


class Conv3x3GNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, upsample: bool) -> None:
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1, bias=False), GroupNormReLU(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block(x)
        return _upsample_nearest_2x(x) if self.upsample else x


class SegmentationBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_upsamples: int) -> None:
        super().__init__()
        blocks = [Conv3x3GNReLU(cin, cout, upsample=n_upsamples > 0)]
        for _ in range(1, n_upsamples):
            blocks.append(Conv3x3GNReLU(cout, cout, upsample=True))
        self.block = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class FPNBlock(nn.Module):
    def __init__(self, pyramid_channels: int, skip_channels: int) -> None:
        super().__init__()
        self.skip_conv = Conv2d(skip_channels, pyramid_channels, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.skip_conv(skip) + _upsample_nearest_2x(x)


class FPNDecoder(nn.Module):
    def __init__(self, encoder_channels, pyramid_channels: int = 256,
                 segmentation_channels: int = 128,
                 dropout: float = 0.2) -> None:
        super().__init__()
        _, c2, c3, c4, c5 = encoder_channels
        self.p5 = Conv2d(c5, pyramid_channels, 1)
        self.p4 = FPNBlock(pyramid_channels, c4)
        self.p3 = FPNBlock(pyramid_channels, c3)
        self.p2 = FPNBlock(pyramid_channels, c2)
        self.seg_blocks = nn.ModuleList(
            SegmentationBlock(pyramid_channels, segmentation_channels, n)
            for n in (3, 2, 1, 0))
        self.dropout = Dropout2d(dropout)

    def forward(self, c2, c3, c4, c5,
                generator: torch.Generator | None = None) -> torch.Tensor:
        p5 = self.p5(c5)
        p4 = self.p4(p5, c4)
        p3 = self.p3(p4, c3)
        p2 = self.p2(p3, c2)
        y = sum(b(p) for b, p in zip(self.seg_blocks, (p5, p4, p3, p2)))
        return self.dropout(y, generator)


class FPN(nn.Module):
    def __init__(self, num_classes: int = 1, output_size: int = 512,
                 backbone: str = "resnet18",
                 compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.2) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.output_size = output_size
        self.compute_dtype = compute_dtype
        self.encoder = build_encoder(backbone)
        self.decoder = FPNDecoder(encoder_feature_channels(backbone),
                                  dropout=dropout)
        # smp's FPN passes kernel_size=1 to its SegmentationHead
        self.segmentation_head = nn.Sequential(Conv2d(128, num_classes, 1))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: NCHW normalized images; returns float32 NCHW logits at
        ``output_size``.  ``generator`` feeds Dropout2d in train mode."""
        _, c2, c3, c4, c5 = self.encoder(x.to(self.compute_dtype))
        y = self.segmentation_head(self.decoder(c2, c3, c4, c5, generator))
        # smp's head upsamples with nn.UpsamplingBilinear2d: corner-aligned
        return resize_bilinear(y.float(), self.output_size, self.output_size,
                               align_corners=True)

"""ResNet encoder family with torchvision's topology and ``state_dict``
names (the JAX package's ``models/resnet.py``, in NCHW).

7×7/2 stem, BN, ReLU, 3×3/2 maxpool with padding 1, then BasicBlock
(resnet18/34) or Bottleneck (resnet50) stages.  The forward returns
``[c1, c2, c3, c4, c5]`` at strides ``[2, 4, 8, 16, 32]``.

``output_stride`` (8, 16 or 32) turns the strides past it into dilations
with smp's ``replace_strides_with_dilation`` semantics, as the JAX encoder
does: every conv of a dilated stage, block 0 and the downsample included,
takes stride 1 and the stage's rate, with padding ``(k // 2) · rate``.
``depth`` stops the forward after ``c{depth}`` (smp's ``encoder_depth``):
the later stages are still built, so their weights load and save, but
they do not run.  torchvision's classifier (``fc.*``) is not built
(:attr:`ResNetEncoder.unbuilt_keys`).

Dtype policy (flax's): parameters and BN statistics stay float32; every
convolution runs in its input's dtype (the model's compute dtype), with
the weights cast on the fly.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

RESNET_CFGS = {
    "resnet18": {"block": "basic", "layers": (2, 2, 2, 2)},
    "resnet34": {"block": "basic", "layers": (3, 4, 6, 3)},
    "resnet50": {"block": "bottleneck", "layers": (3, 4, 6, 3)},
}

BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weight (and bias) are cast to the input's
    dtype for the convolution."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose float32 weight (and bias) are cast to the
    input's dtype (``nn.ConvTranspose2d`` itself refuses a bf16 input with
    f32 weights)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS)


def check_encoder_args(output_stride: int, depth: int) -> None:
    if output_stride not in (8, 16, 32):
        raise ValueError(f"output_stride must be 8, 16 or 32, got "
                         f"{output_stride}")
    if not 1 <= depth <= 5:
        raise ValueError(f"depth must be in 1..5, got {depth}")


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 dilation: int = 1) -> None:
        super().__init__()
        self.conv1 = Conv2d(cin, channels, 3, stride, dilation, dilation,
                            bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = Conv2d(channels, channels, 3, 1, dilation, dilation,
                            bias=False)
        self.bn2 = _bn(channels)
        self.downsample = None
        if stride != 1 or cin != channels:
            self.downsample = nn.Sequential(
                Conv2d(cin, channels, 1, stride, dilation=dilation,
                       bias=False), _bn(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (1×1 → 3×3 with the stride → 1×1·4)."""

    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 dilation: int = 1) -> None:
        super().__init__()
        out = channels * 4
        self.conv1 = Conv2d(cin, channels, 1, dilation=dilation, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = Conv2d(channels, channels, 3, stride, dilation, dilation,
                            bias=False)
        self.bn2 = _bn(channels)
        self.conv3 = Conv2d(channels, out, 1, dilation=dilation, bias=False)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                Conv2d(cin, out, 1, stride, dilation=dilation, bias=False),
                _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """ResNet feature extractor without the avgpool/fc head."""

    unbuilt_keys = ("fc.",)

    def __init__(self, backbone: str = "resnet18", output_stride: int = 32,
                 depth: int = 5) -> None:
        super().__init__()
        if backbone not in RESNET_CFGS:
            raise ValueError(f"unknown resnet {backbone!r}; supported: "
                             f"{tuple(RESNET_CFGS)}")
        check_encoder_args(output_stride, depth)
        self.depth = depth
        cfg = RESNET_CFGS[backbone]
        block = BasicBlock if cfg["block"] == "basic" else Bottleneck
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        current_stride, dilation = 4, 1
        for i, (ch, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                               cfg["layers"])):
            stride = 1 if i == 0 else 2
            if stride == 2 and current_stride >= output_stride:
                stride, dilation = 1, dilation * 2
            elif stride == 2:
                current_stride *= 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(cin, ch, stride if b == 0 else 1,
                                    dilation))
                cin = ch * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    @staticmethod
    def feature_channels(backbone: str) -> List[int]:
        if RESNET_CFGS[backbone]["block"] == "basic":
            return [64, 64, 128, 256, 512]
        return [64, 256, 512, 1024, 2048]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``[c1, …, c{depth}]``."""
        c1 = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(c1, 3, 2, 1)
        feats = [c1]
        layers = (self.layer1, self.layer2, self.layer3, self.layer4)
        for layer in layers[:self.depth - 1]:
            y = layer(y)
            feats.append(y)
        return feats

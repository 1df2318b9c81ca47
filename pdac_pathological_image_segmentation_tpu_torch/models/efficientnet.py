"""EfficientNet-b0…b7 encoders with efficientnet-pytorch's topology and
``state_dict`` names (the JAX package's ``models/efficientnet.py``, in
NCHW), the encoders of smp's ``efficientnet-b*`` entries.

Names: ``_conv_stem``, ``_bn0``, then ``_blocks.N.{_expand_conv, _bn0,
_depthwise_conv, _bn1, _se_reduce, _se_expand, _project_conv, _bn2}``
(no ``_expand_conv``/``_bn0`` where the expand ratio is 1).  The
classifier top (``_conv_head``, ``_bn1``, ``_fc``) is not built
(:attr:`EfficientNetEncoder.unbuilt_keys`); smp's encoder keeps the first
two in its ``state_dict`` and never runs them.

An MBConv block: 1×1 expand → BN → SiLU (not where the ratio is 1) → k×k
depthwise with TF "SAME" padding → BN → SiLU → squeeze-excite (the spatial
mean taken in float32 and cast back, 1×1 reduce to ``max(1,
int(in_ch·0.25))`` of the block's *input* channels with a bias, SiLU, 1×1
expand with a bias, sigmoid gate) → 1×1 projection → BN, plus the input
when the stride is 1 and the channels do not change.  SiLU is
``x·sigmoid(x)``.  BatchNorm takes eps 1e-3 and torch momentum 0.01
(efficientnet-pytorch's ``batch_norm_momentum=0.99``).  Drop-connect is
left out, as the JAX package leaves it out.

The block list, its per-variant scaling (``round_filters``,
``round_repeats``) and smp's stage splits are the JAX package's, copied
here: ``[c1..c5]`` at strides ``[2, 4, 8, 16, 32]``, ``c1`` the stem.
``output_stride=16`` turns the first stride-2 block past the output stride
into stride 1 and doubles the dilation from there on, on every conv with a
kernel larger than 1.  ``depth`` stops the forward after ``c{depth}``; the
later blocks are still built, so their weights load and save.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    Conv2d,
    check_encoder_args,
)

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch's; flax's 0.99

# base (b0) stages: (expand t, out channels, repeats, stride, kernel)
_BASE_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_mult, depth_mult) per variant
VARIANTS: Dict[str, Tuple[float, float]] = {
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6),
    "efficientnet-b7": (2.0, 3.1),
}

_SE_RATIO = 0.25
_DIVISOR = 8


def round_filters(filters: int, width_mult: float) -> int:
    """efficientnet-pytorch's ``round_filters`` (divisor 8)."""
    filters *= width_mult
    new_filters = max(_DIVISOR,
                      int(filters + _DIVISOR / 2) // _DIVISOR * _DIVISOR)
    if new_filters < 0.9 * filters:  # never round down by more than 10%
        new_filters += _DIVISOR
    return int(new_filters)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def block_specs(variant: str) -> List[Dict[str, int]]:
    """The scaled, flattened block list of ``variant``: dicts of in/out
    channels, expand ratio, kernel and stride."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown efficientnet variant {variant!r}; "
                         f"supported: {tuple(VARIANTS)}")
    w, d = VARIANTS[variant]
    specs: List[Dict[str, int]] = []
    in_ch = round_filters(32, w)  # the stem's output
    for t, c, r, s, k in _BASE_STAGES:
        out_ch = round_filters(c, w)
        for b in range(round_repeats(r, d)):
            specs.append(dict(in_ch=in_ch, out_ch=out_ch, expand=t,
                              kernel=k, stride=s if b == 0 else 1))
            in_ch = out_ch
    return specs


def stage_splits(variant: str) -> Tuple[int, int, int, int]:
    """The block-list ends of the stride-4/8/16/32 features: a group ends
    just before the next stride-2 block."""
    specs = block_specs(variant)
    bounds = [i for i, sp in enumerate(specs) if sp["stride"] == 2]
    if len(bounds) != 4:
        raise AssertionError(f"expected 4 stride-2 blocks, got {bounds}")
    return (bounds[1], bounds[2], bounds[3], len(specs))


def feature_channels(variant: str) -> List[int]:
    """Channels of ``[c1..c5]`` (smp's ``out_channels[1:]``)."""
    w, _ = VARIANTS[variant]
    specs = block_specs(variant)
    i0, i1, i2, n = stage_splits(variant)
    return [round_filters(32, w), specs[i0 - 1]["out_ch"],
            specs[i1 - 1]["out_ch"], specs[i2 - 1]["out_ch"],
            specs[n - 1]["out_ch"]]


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class SameConv2d(Conv2d):
    """A conv with TF "SAME" padding (flax's ``padding="SAME"``): the
    output has ``ceil(size / stride)`` pixels and the padding is split
    with the extra pixel after, e.g. (0, 1) for k=3 and (1, 2) for k=5 at
    stride 2 on an even input.  The dilation counts in the effective
    kernel.  A symmetric padding is the conv's own; an asymmetric one is
    ``F.pad`` before the conv (a padded copy of the input).  The names stay
    the conv's."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1) -> None:
        super().__init__(cin, cout, kernel, stride, 0, dilation, groups,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s, d in zip(x.shape[:-3:-1], self.kernel_size[::-1],
                                 self.stride[::-1], self.dilation[::-1]):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            pads += [total // 2, total - total // 2]
        if pads[0] == pads[1] and pads[2] == pads[3]:
            return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                            (pads[2], pads[0]), self.dilation, self.groups)
        return super().forward(F.pad(x, pads))


class MBConvBlock(nn.Module):
    """efficientnet-pytorch's ``MBConvBlock`` without drop-connect."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int, dilation: int = 1) -> None:
        super().__init__()
        hidden = in_ch * expand
        if expand != 1:
            self._expand_conv = Conv2d(in_ch, hidden, 1, bias=False)
            self._bn0 = _bn(hidden)
        self._depthwise_conv = SameConv2d(hidden, hidden, kernel, stride,
                                          dilation, groups=hidden)
        self._bn1 = _bn(hidden)
        squeezed = max(1, int(in_ch * _SE_RATIO))
        self._se_reduce = Conv2d(hidden, squeezed, 1)
        self._se_expand = Conv2d(squeezed, hidden, 1)
        self._project_conv = Conv2d(hidden, out_ch, 1, bias=False)
        self._bn2 = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if hasattr(self, "_expand_conv"):
            y = silu(self._bn0(self._expand_conv(y)))
        y = silu(self._bn1(self._depthwise_conv(y)))
        s = y.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(y.dtype)
        s = self._se_expand(silu(self._se_reduce(s)))
        y = self._bn2(self._project_conv(y * torch.sigmoid(s)))
        return y + x if self.residual else y


class EfficientNetEncoder(nn.Module):
    """EfficientNet feature extractor without the classifier top."""

    unbuilt_keys = ("_conv_head.", "_bn1.", "_fc.")

    def __init__(self, variant: str = "efficientnet-b0",
                 output_stride: int = 32, depth: int = 5) -> None:
        super().__init__()
        check_encoder_args(output_stride, depth)
        specs = block_specs(variant)
        self.depth = depth
        self.splits = stage_splits(variant)
        stem = round_filters(32, VARIANTS[variant][0])
        self._conv_stem = SameConv2d(3, stem, 3, 2)
        self._bn0 = _bn(stem)
        current_stride, dilation = 2, 1
        blocks = []
        for sp in specs:
            stride = sp["stride"]
            if stride == 2 and current_stride >= output_stride:
                stride, dilation = 1, dilation * 2
            elif stride == 2:
                current_stride *= 2
            blocks.append(MBConvBlock(
                sp["in_ch"], sp["out_ch"], sp["expand"], sp["kernel"], stride,
                dilation if sp["kernel"] > 1 else 1))
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``[c1, …, c{depth}]``."""
        y = silu(self._bn0(self._conv_stem(x)))
        feats, start = [y], 0
        for end in self.splits[:self.depth - 1]:
            for block in self._blocks[start:end]:
                y = block(y)
            feats.append(y)
            start = end
        return feats

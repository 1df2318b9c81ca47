"""Plain PyTorch models of the benchmark's configurations: FPN over
resnet18 (segmentation_models_pytorch's ``FPN(encoder_name="resnet18")``)
and the reference repository's ResNet18-U-Net, with the parameter names of
their published ``state_dict``s.

A configuration file reaches its model through :func:`build`: by its
``"reference"`` key, the path from the checkout's root of a module whose
``MODEL`` is the class, or else by ``"model"`` in :data:`ARCHITECTURES`.
Every model class takes the configuration's dict, and gives ``stored``,
the module types whose outputs a step computed wholly in a lower
precision stores (:func:`set_quantizer`), and ``draw_dropout(n,
generator, device)``, what ``forward(x, dropout)`` takes in a train
step, drawn from the step's generator, or None.  A new module imports
``QConv``, the norms and :func:`normalize_u8` from here.

Independent of the program under test: torch ops only, float32 unless a
quantizer is set.  ``QConv`` is where a lower precision enters: a model's
``set_quantizer(q)`` makes every convolution compute on ``q(input,
"act", name)`` and ``q(weight, "weight", name)`` and pass its output
through ``q(output, "grad", name)``, where a quantizer may round the
gradient that flows back (the controls, and the calibration of the int8
reference); ``None`` is float32.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
GN_EPS = 1e-5


class QConv(nn.Conv2d):
    quantizer = None
    site = ""

    def forward(self, x):
        q = self.quantizer
        if q is None:
            return self._conv_forward(x, self.weight, self.bias)
        y = self._conv_forward(q(x, "act", self.site),
                               q(self.weight, "weight", self.site),
                               self.bias)
        return q(y, "grad", self.site)


def _bn(c):
    return nn.BatchNorm2d(c, eps=BN_EPS)


class BasicBlock(nn.Module):
    def __init__(self, cin, c, stride):
        super().__init__()
        self.conv1 = QConv(cin, c, 3, stride, 1, bias=False)
        self.bn1 = _bn(c)
        self.conv2 = QConv(c, c, 3, 1, 1, bias=False)
        self.bn2 = _bn(c)
        self.downsample = None
        if stride != 1 or cin != c:
            self.downsample = nn.Sequential(
                QConv(cin, c, 1, stride, bias=False), _bn(c))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class ResNet18Encoder(nn.Module):
    """torchvision's resnet18 without avgpool and fc; returns the stem
    and the four stages' outputs (strides 2, 4, 8, 16, 32)."""

    def __init__(self, widths=(64, 128, 256, 512), blocks=(2, 2, 2, 2)):
        super().__init__()
        self.conv1 = QConv(3, widths[0], 7, 2, 3, bias=False)
        self.bn1 = _bn(widths[0])
        cin = widths[0]
        for i, (c, n) in enumerate(zip(widths, blocks)):
            stride = 1 if i == 0 else 2
            layer = []
            for b in range(n):
                layer.append(BasicBlock(cin, c, stride if b == 0 else 1))
                cin = c
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x):
        c1 = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(c1, 3, 2, 1)
        feats = [c1]
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            y = layer(y)
            feats.append(y)
        return feats


class ConvGNReLU(nn.Module):
    def __init__(self, cin, cout, groups, upsample):
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(QConv(cin, cout, 3, 1, 1, bias=False),
                                   nn.GroupNorm(groups, cout, eps=GN_EPS))

    def forward(self, x):
        y = F.relu(self.block(x))
        return F.interpolate(y, scale_factor=2, mode="nearest") \
            if self.upsample else y


class SegBlock(nn.Module):
    def __init__(self, cin, cout, groups, n_up):
        super().__init__()
        layers = [ConvGNReLU(cin, cout, groups, n_up > 0)]
        layers += [ConvGNReLU(cout, cout, groups, True)
                   for _ in range(1, n_up)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


class Lateral(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.skip_conv = QConv(cin, c, 1)

    def forward(self, x, skip):
        return self.skip_conv(skip) + F.interpolate(x, scale_factor=2,
                                                   mode="nearest")


class FPNDecoder(nn.Module):
    def __init__(self, enc, pyramid, seg, groups, dropout):
        super().__init__()
        self.p5 = QConv(enc[3], pyramid, 1)
        self.p4 = Lateral(enc[2], pyramid)
        self.p3 = Lateral(enc[1], pyramid)
        self.p2 = Lateral(enc[0], pyramid)
        self.seg_blocks = nn.ModuleList(
            SegBlock(pyramid, seg, groups, n) for n in (3, 2, 1, 0))
        self.seg_channels = seg
        self.dropout = dropout


class FPN(nn.Module):
    """smp FPN: 1×1 laterals into a top-down pyramid (nearest 2×), a
    segmentation block per level (3×3 conv, GroupNorm, ReLU, nearest 2×
    up to stride 4), their sum, Dropout2d, a 1×1 head and a corner-aligned
    bilinear ×4 to the tile."""

    stored = (nn.BatchNorm2d, nn.GroupNorm, BasicBlock, Lateral, ConvGNReLU,
              SegBlock)

    def __init__(self, cfg):
        super().__init__()
        widths = tuple(cfg["encoder_widths"])
        self.encoder = ResNet18Encoder(widths, tuple(cfg["encoder_blocks"]))
        self.decoder = FPNDecoder(widths, cfg["pyramid_channels"],
                                  cfg["segmentation_channels"],
                                  cfg["gn_groups"], cfg["dropout"])
        self.segmentation_head = nn.Sequential(
            QConv(cfg["segmentation_channels"], cfg["num_classes"], 1))

    def draw_dropout(self, n: int, g: torch.Generator, device):
        """The Dropout2d mask of the decoder's output, (N, C) planes kept
        where U[0, 1) ≥ p, drawn as (N, C, 1, 1) from ``g`` after the
        augmentation's draws; None without dropout."""
        d = self.decoder
        if d.dropout <= 0.0:
            return None
        return (torch.rand((n, d.seg_channels, 1, 1), generator=g)
                >= d.dropout)[:, :, 0, 0].to(device)

    def forward(self, x, dropout_keep=None):
        """``dropout_keep`` (N, C) bool: the train step's Dropout2d mask,
        or None (eval)."""
        _, c2, c3, c4, c5 = self.encoder(x)
        d = self.decoder
        p5 = d.p5(c5)
        p4 = d.p4(p5, c4)
        p3 = d.p3(p4, c3)
        p2 = d.p2(p3, c2)
        y = sum(b(p) for b, p in zip(d.seg_blocks, (p5, p4, p3, p2)))
        if dropout_keep is not None:
            y = torch.where(dropout_keep[:, :, None, None],
                            y / (1.0 - d.dropout), torch.zeros_like(y))
        y = self.segmentation_head(y)
        return F.interpolate(y, size=x.shape[-2:], mode="bilinear",
                             align_corners=True)


class ResUNet(nn.Module):
    """The reference repository's ResUNet: resnet18 encoder; three rounds
    of a 2×2/2 transposed conv, concatenation with the skip, 3×3 conv with
    bias and ReLU; a 1×1 head at stride 4 and a half-pixel bilinear ×4."""

    stored = (nn.BatchNorm2d, BasicBlock)

    def __init__(self, cfg):
        super().__init__()
        widths = tuple(cfg["encoder_widths"])
        self.encoder = ResNet18Encoder(widths, tuple(cfg["encoder_blocks"]))
        d = tuple(cfg["decoder_channels"])  # 256, 128, 64
        ins = (widths[3],) + d[:2]
        skips = (widths[2], widths[1], widths[0])
        for i, (cin, c, s) in enumerate(zip(ins, d, skips), start=1):
            setattr(self, f"upconv{i}",
                    nn.ConvTranspose2d(cin, c, 2, stride=2))
            setattr(self, f"conv{i}", QConv(c + s, c, 3, 1, 1))
        self.conv4 = QConv(d[2], cfg["num_classes"], 1)

    def draw_dropout(self, n: int, g: torch.Generator, device):
        return None

    def forward(self, x, dropout_keep=None):
        _, x2, x3, x4, x5 = self.encoder(x)
        y = F.relu(self.conv1(torch.cat([self.upconv1(x5), x4], 1)))
        y = F.relu(self.conv2(torch.cat([self.upconv2(y), x3], 1)))
        y = F.relu(self.conv3(torch.cat([self.upconv3(y), x2], 1)))
        y = self.conv4(y)
        return F.interpolate(y, size=x.shape[-2:], mode="bilinear",
                             align_corners=False)


ARCHITECTURES = {"fpn": FPN, "unet": ResUNet}  # files with no "reference"


@functools.lru_cache(maxsize=None)
def _reference_class(path: str) -> type:
    from benchmark import harness

    full = Path(path)
    if not full.is_absolute():
        full = harness.ROOT / full
    return harness.load_module(full, "bench_reference_" + full.stem).MODEL


def build(cfg) -> nn.Module:
    """The plain model of a configuration file's dict, float32, with each
    convolution named by its ``state_dict`` prefix (``QConv.site``)."""
    arch = (_reference_class(cfg["reference"]) if "reference" in cfg
            else ARCHITECTURES[cfg["model"]])
    model = arch(cfg)
    for name, m in model.named_modules():
        if isinstance(m, QConv):
            m.site = name
    return model


def set_quantizer(model: nn.Module, quantizer, outputs: bool = False) -> None:
    """Put ``quantizer`` in front of every convolution (None: float32);
    with ``outputs`` also round what the modules of the model's ``stored``
    types store, ``quantizer(output, "out", name)``, as a step computed
    wholly in that precision would."""
    for handle in getattr(model, "_stored_hooks", []):
        handle.remove()
    model._stored_hooks = []
    stored = model.stored if outputs and quantizer is not None else ()
    for name, m in model.named_modules():
        if isinstance(m, QConv):
            m.quantizer = quantizer
        if isinstance(m, stored):
            model._stored_hooks.append(m.register_forward_hook(
                lambda mod, inp, out, n=name: quantizer(out, "out", n)))


NORMALIZE_MEAN = (0.485, 0.456, 0.406)
NORMALIZE_STD = (0.229, 0.224, 0.225)


def normalize_u8(images_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N, 3, H, W) float32, ImageNet-normalized
    (albumentations' ``Normalize``: ``(x/255 − mean)/std``)."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(NORMALIZE_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(NORMALIZE_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std

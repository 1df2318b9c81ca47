"""Plain PyTorch DeepLabV3+ over resnet50 (segmentation_models_pytorch's
``DeepLabV3Plus(encoder_name="resnet50", encoder_output_stride=16,
decoder_atrous_rates=rates)``), with the parameter names of its published
``state_dict``; a configuration file names it by ``"reference"``.

Encoder: torchvision's resnet50 without avgpool and fc, a 7×7/2 stem, a
3×3/2 max-pool and stages of bottleneck blocks (1×1 → 3×3 with the
stride → 1×1 to four times the width, a 1×1 downsample where the shape
changes).  At output stride 16 the last stage takes smp's
``replace_strides_with_dilation``: every convolution of it, block 0 and
its downsample included, stride 1 and dilation 2, padding ``(k // 2)·2``.
ASPP over the stride-16 features: a 1×1 branch, a depthwise-separable
3×3 branch (depthwise dilated at the rate, then pointwise, no bias) per
atrous rate, and image pooling (mean, 1×1, BN, ReLU, bilinear back to the
map's size); each branch BN and ReLU; their concatenation, a 1×1
projection, BN, ReLU and elementwise ``Dropout(0.5)``; then a separable
3×3, BN, ReLU.  Decoder: a corner-aligned bilinear ×4 to stride 4,
concatenation with a 1×1 projection of the stride-4 features to 48
channels (BN, ReLU), a separable 3×3, BN, ReLU; the 1×1 head with a bias
and a corner-aligned bilinear ×4 to the tile.  Float32 throughout.

Departures from smp, none in the mathematics:

* the dropout mask is an argument of :meth:`DeepLabV3Plus.forward`, drawn
  by :meth:`DeepLabV3Plus.draw_dropout` as the program under test draws
  it, where smp's ``nn.Dropout`` draws from the global generator;
* the depthwise convolutions' weight gradient is summed as nine shifted
  products (``_DepthwiseConv``), so that the FLOP count of the backward
  counts it as the work it is;
* in a train step (training mode with gradients on), the stem, each
  bottleneck block, the ASPP and the stride-4 decoder run under
  ``torch.utils.checkpoint`` (non-reentrant), so that the float32
  backward of 128 tiles of 512² fits one card; the recompute leaves the
  BatchNorm running statistics as the first pass left them.  Eval mode
  checkpoints nothing, so a FLOP count there counts no recompute.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.models import QConv, _bn


class Bottleneck(nn.Module):
    def __init__(self, cin, c, stride, dilation, expansion):
        super().__init__()
        out = c * expansion
        self.conv1 = QConv(cin, c, 1, bias=False)
        self.bn1 = _bn(c)
        self.conv2 = QConv(c, c, 3, stride, dilation, dilation, bias=False)
        self.bn2 = _bn(c)
        self.conv3 = QConv(c, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                QConv(cin, out, 1, stride, bias=False), _bn(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class ResNet50Encoder(nn.Module):
    """The stem and four bottleneck stages; the stages past
    ``output_stride`` dilated instead of strided."""

    def __init__(self, widths, blocks, expansion, output_stride):
        super().__init__()
        self.conv1 = QConv(3, widths[0], 7, 2, 3, bias=False)
        self.bn1 = _bn(widths[0])
        cin, stride_now, dilation = widths[0], 4, 1
        for i, (c, n) in enumerate(zip(widths, blocks)):
            stride = 1 if i == 0 else 2
            if stride == 2 and stride_now >= output_stride:
                stride, dilation = 1, dilation * 2
            elif stride == 2:
                stride_now *= 2
            layer = []
            for b in range(n):
                layer.append(Bottleneck(cin, c, stride if b == 0 else 1,
                                        dilation, expansion))
                cin = c * expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def stem(self, x):
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)


class _DepthwiseConv(torch.autograd.Function):
    """A depthwise convolution (stride 1, no bias) whose weight gradient is
    nine shifted products summed over the batch and the map: the same sums
    as the convolution's, in another order, and counted by
    ``FlopCounterMode`` as what they are (its formula for a grouped
    convolution's weight gradient counts a dense one, ``C`` times too
    many)."""

    @staticmethod
    def forward(ctx, x, w, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.dilation = padding, dilation
        return F.conv2d(x, w, None, 1, padding, dilation, x.shape[1])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        p, d = ctx.padding, ctx.dilation
        gx = torch.nn.grad.conv2d_input(x.shape, w, gy, 1, p, d, x.shape[1])
        xp = F.pad(x, (p[1], p[1], p[0], p[0]))
        h, wd = gy.shape[-2:]
        gw = torch.stack([
            torch.einsum("nchw,nchw->c",
                         xp[:, :, i * d[0]:i * d[0] + h,
                            j * d[1]:j * d[1] + wd], gy)
            for i in range(w.shape[2]) for j in range(w.shape[3])], 1)
        return gx, gw.view(w.shape), None, None


class DepthwiseConv(QConv):
    def _conv_forward(self, x, weight, bias):
        return _DepthwiseConv.apply(x, weight, self.padding, self.dilation)


def separable(cin, cout, dilation=1):
    """smp's ``SeparableConv2d``: depthwise 3×3 (``.0``), pointwise 1×1
    (``.1``), neither with a bias."""
    return nn.Sequential(
        DepthwiseConv(cin, cin, 3, 1, dilation, dilation, groups=cin,
                      bias=False),
        QConv(cin, cout, 1, bias=False))


class ConvBNReLU(nn.Sequential):
    """A convolution (or a separable one), BN and ReLU: ASPP's branches,
    the decoder's skip projection and its last block."""

    def __init__(self, conv, c):
        super().__init__(conv, _bn(c), nn.ReLU())


class Pooling(nn.Sequential):
    """smp's ``ASPPPooling``: the map's mean, 1×1, BN, ReLU, resized back
    (bilinear, half-pixel) to the map's size."""

    def __init__(self, cin, c):
        super().__init__(nn.AdaptiveAvgPool2d(1), QConv(cin, c, 1, bias=False),
                         _bn(c), nn.ReLU())

    def forward(self, x):
        y = super().forward(x)
        return F.interpolate(y, size=x.shape[-2:], mode="bilinear",
                             align_corners=False)


class ASPP(nn.Module):
    """``convs.{0..4}`` and ``project`` (1×1, BN, ReLU; smp's index 3 is
    the dropout, which holds no parameter)."""

    def __init__(self, cin, c, rates, dropout):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNReLU(QConv(cin, c, 1, bias=False), c)]
            + [ConvBNReLU(separable(cin, c, r), c) for r in rates]
            + [Pooling(cin, c)])
        self.project = nn.Sequential(
            QConv(len(self.convs) * c, c, 1, bias=False), _bn(c), nn.ReLU())
        self.dropout = dropout

    def forward(self, x, keep=None):
        y = self.project(torch.cat([conv(x) for conv in self.convs], 1))
        if keep is None:
            return y
        return torch.where(keep, y / (1.0 - self.dropout),
                           torch.zeros_like(y))


class Decoder(nn.Module):
    def __init__(self, c2, c5, c, skip, rates, dropout):
        super().__init__()
        self.aspp = nn.Sequential(ASPP(c5, c, rates, dropout),
                                  separable(c, c), _bn(c), nn.ReLU())
        self.block1 = ConvBNReLU(QConv(c2, skip, 1, bias=False), skip)
        self.block2 = ConvBNReLU(separable(c + skip, c), c)

    def context(self, c5, keep=None):
        return self.aspp[1:](self.aspp[0](c5, keep))

    def forward(self, c2, context):
        y = F.interpolate(context, size=c2.shape[-2:], mode="bilinear",
                          align_corners=True)
        return self.block2(torch.cat([y, self.block1(c2)], 1))


@contextlib.contextmanager
def _statistics_kept(module):
    """BatchNorm's running statistics (and batch count) of ``module`` left
    as they are over the block: a recompute's second pass over a batch."""
    norms = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    kept = [(m.momentum, m.num_batches_tracked.clone()) for m in norms]
    for m in norms:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, (momentum, count) in zip(norms, kept):
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)


class DeepLabV3Plus(nn.Module):
    """smp DeepLabV3+ at output stride 16 (module docstring)."""

    stored = (nn.BatchNorm2d, Bottleneck, ConvBNReLU, ASPP)

    def __init__(self, cfg):
        super().__init__()
        widths, expansion = cfg["encoder_widths"], cfg["encoder_expansion"]
        self.encoder = ResNet50Encoder(widths, cfg["encoder_blocks"],
                                       expansion, cfg["output_stride"])
        c = cfg["decoder_channels"]
        self.decoder = Decoder(widths[0] * expansion, widths[3] * expansion,
                               c, cfg["skip_channels"], cfg["dilations"],
                               cfg["aspp_dropout"])
        self.segmentation_head = nn.Sequential(
            QConv(c, cfg["num_classes"], 1))
        self.map_side = cfg["img_size"] // cfg["output_stride"]
        self.checkpointed = True

    def draw_dropout(self, n: int, g: torch.Generator, device):
        """The ASPP's elementwise mask, drawn as the program draws it: one
        64-bit seed from ``g`` (after the augmentation's draws), then
        U[0, 1) of shape (n, C, S/16, S/16) from a generator on
        ``device`` seeded with it, kept where ≥ p; None without dropout."""
        p = self.decoder.aspp[0].dropout
        if p <= 0.0:
            return None
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=g))
        local = torch.Generator(device=device).manual_seed(seed)
        c, side = self.decoder.aspp[0].project[0].out_channels, self.map_side
        return torch.rand((n, c, side, side), generator=local,
                          device=device) >= p

    def _run(self, norms, fn, *args):
        """``fn(*args)``, under a checkpoint in a train step, whose
        recompute keeps the running statistics of ``norms``' BatchNorms."""
        if not (self.checkpointed and self.training
                and torch.is_grad_enabled()):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _statistics_kept(norms)))

    def forward(self, x, dropout_keep=None):
        """``dropout_keep`` (N, C, S/16, S/16) bool: the train step's ASPP
        mask, or None (eval)."""
        enc, d = self.encoder, self.decoder
        y = self._run(enc.bn1, enc.stem, x)
        feats = []
        for layer in (enc.layer1, enc.layer2, enc.layer3, enc.layer4):
            for block in layer:
                y = self._run(block, block, y)
            feats.append(y)
        context = self._run(d.aspp, d.context, feats[3], dropout_keep)
        return self._run(d, self._head, feats[0], context, x.shape[-1])

    def _head(self, c2, context, side):
        y = self.segmentation_head(self.decoder(c2, context))
        return F.interpolate(y, size=(side, side), mode="bilinear",
                             align_corners=True)


MODEL = DeepLabV3Plus

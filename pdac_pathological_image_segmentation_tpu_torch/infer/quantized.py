"""Post-training int8 quantized inference for the four reference
architectures (unet / fpn / deeplabv3+ / pspnet) on a resnet18 encoder: the
JAX package's ``infer/quantized.py``, written over the port's
``state_dict`` (its names, on the serving device) in NHWC.

* weights: symmetric per-output-channel int8 (``ops/int8_conv.py::
  quantize_weights``);
* activations: symmetric per-tensor int8, scales from a calibration pass of
  the float mirror over representative batches (amax / 127, the largest
  over batches);
* every quantized site is one launch of the int8 convolution kernel
  (``ops/int8_conv.py``, ``csrc/int8_conv.cu``): int32 sums, then in its
  epilogue the dequantize, the BatchNorm affine or bias, the residual, the
  ReLU, and the store — int8 requantized with the consumer's scale where
  the consumer is a quantized conv and ``act_storage`` is ``"int8"`` (one
  byte an element between sites), else bf16;
* quantized sites, named as in the JAX package (``stem``,
  ``layer1_0.conv1``, ``lateral5``, ``seg0_0.conv``, ``dec1.a``,
  ``aspp.r0.pointwise``, ``bottleneck``, …): the stem and every encoder
  conv, ResUNet's split ``ConcatConv`` halves, FPN's laterals and seg
  convs, DeepLabV3+'s ASPP 1×1s, pointwises, projection, skip and fuse,
  PSPNet's bottleneck.  Upconvs, depthwise convs, GroupNorm (the GN kernel
  in float32, ``ops/group_norm.py``), heads, pools and resizes stay float.

Tensors are NHWC as in the JAX mirror: an NHWC tensor's ``permute(0, 3,
1, 2)`` is a channels_last NCHW tensor, which PyTorch's float ops (the
float convolutions, pools and resizes) take as it is.  The float mode
(``_Ctx("float")``) is the f32 mirror of the model, checked against it; it
records each site's input amax for :func:`calibrate`.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pdac_pathological_image_segmentation_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    BN_EPS,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
    group_norm_relu,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
    int8_conv,
    quantize_activation,
    quantize_weights,
    space_to_depth_pad,
    space_to_depth_weights,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.stain import (
    apply_stain_batch,
    check_method,
)

GN_EPS = 1e-5  # FPN's GroupNorm (models/fpn.py)
ACT_STORAGES = ("int8", "bf16")


class _QT(NamedTuple):
    """A producer-quantized int8 activation (NHWC, contiguous) and its
    per-tensor scale: the ``act_storage="int8"`` form between sites."""

    q: torch.Tensor
    scale: float


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _deq(x):
    """A ``_QT`` as float32; a plain tensor as it is."""
    if isinstance(x, _QT):
        s = torch.full((1,), x.scale, dtype=torch.float32, device=x.q.device)
        return x.q.float() * s
    return x


def _float_conv(x, weight, stride=1, pad=0, dilation=1, groups=1):
    """f32 NHWC convolution with an OIHW weight."""
    y = F.conv2d(_nchw(x.float()), weight.float(), stride=stride,
                 padding=pad, dilation=dilation, groups=groups)
    return _nhwc(y)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsampling of NHWC (the JAX ``_upsample_nearest_2x``)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def _maxpool(y):
    """The stem's 3×3/2 maxpool (padding 1).  Max commutes with the
    monotonic quantize, so a ``_QT`` pools in its integers: through an
    exact bf16 copy (PyTorch's CUDA max_pool2d takes no int8), whose
    implicit padding never wins since every window holds a pixel."""
    if isinstance(y, _QT):
        p = F.max_pool2d(_nchw(y.q).to(torch.bfloat16), 3, 2, 1)
        return _QT(_nhwc(p.to(torch.int8)).contiguous(), y.scale)
    return _nhwc(F.max_pool2d(_nchw(y), 3, 2, 1))


@contextlib.contextmanager
def _exact_f32():
    """cuDNN in full float32 (not TF32) for the float mirror, so that its
    calibration scales do not depend on the device."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Ctx:
    """Conv dispatcher: float mode runs the f32 mirror and records each
    site's input amax (calibration); int8 mode runs the int8 kernel with
    the calibrated scales."""

    def __init__(self, mode: str, act_scales=None, qweights=None,
                 act_storage: str = "bf16", affines=None, s2d=None):
        assert mode in ("float", "int8")
        assert act_storage in ACT_STORAGES
        self.mode = mode
        # int8 mode keeps float tensors between sites in bf16; float mode
        # in f32, for the mirror's parity with the model
        self.act_dtype = torch.float32 if mode == "float" else torch.bfloat16
        self.act_storage = act_storage if mode == "int8" else "bf16"
        self.act_scales = act_scales or {}
        self.qweights = qweights or {}
        self.affines = {} if affines is None else affines
        # site -> (space-to-depth weights, low block padding): the stem
        # runs on a space-to-depth input (ops/int8_conv.py)
        self.s2d = s2d or {}
        self.stats: Dict[str, torch.Tensor] = {}

    def bn(self, sd, prefix: str):
        """``(a, b)`` float32 of the BatchNorm at ``prefix``, ``y·a + b``,
        on ``sd``'s device.  Computed once, on the CPU (the card's
        ``rsqrt`` rounds otherwise), and kept in ``affines``, which a step
        shares across its calls."""
        if prefix not in self.affines:
            w, var, bias, mean = (sd[f"{prefix}.{k}"].detach().float().cpu()
                                  for k in ("weight", "running_var", "bias",
                                            "running_mean"))
            a = w * torch.rsqrt(var + BN_EPS)
            dev = sd[f"{prefix}.weight"].device
            self.affines[prefix] = (a.to(dev), (bias - mean * a).to(dev))
        return self.affines[prefix]

    def conv(self, name, x, sd, key, stride=1, pad=1, dilation=1, *,
             cin: Optional[Tuple[int, int]] = None, scale=None, shift=None,
             residual=None, bias_last=False, relu=False, site=None,
             out="act", nchw=False):
        """Site ``name``: its conv of ``x`` (the OIHW weight ``sd[key]``,
        input channels ``cin`` of it, read in float mode only) and what
        follows: ``· scale``, ``+ shift`` (after the residual with
        ``bias_last``), ``+ residual``, ReLU.  ``out="act"`` stores the
        inter-site form (a ``_QT`` with ``site``'s scale where
        ``act_storage`` is int8 and ``site`` names the consuming quantized
        conv, else the act dtype); ``out="f32"`` float32, NCHW in memory
        with ``nchw`` (still indexed NHWC)."""
        if self.mode == "float":
            self.stats[name] = x.abs().amax().float()
            w = sd[key] if cin is None else sd[key][:, cin[0]:cin[1]]
            y = _float_conv(x, w, stride, pad, dilation)
            if scale is not None:
                y = y * scale
            if shift is not None and not bias_last:
                y = y + shift
            if residual is not None:
                y = y + _deq(residual).float()
            if shift is not None and bias_last:
                y = y + shift
            if relu:
                y = torch.clamp_min(y, 0.0)
            if out == "f32":
                return _nhwc(_nchw(y).contiguous()) if nchw else y
            return self.act(y, site)
        kq, ks = self.qweights[name]
        if isinstance(x, _QT):
            xq, sx = x.q, x.scale
        elif name in self.s2d:
            # the stem: 16-byte blocks of 2x2 pixels x 4 channels, a 4x4/1
            # convolution with the same int32 sums
            sx = self.act_scales[name]
            kq2, lo = self.s2d[name]
            xq = quantize_activation(x, sx, channels=kq2.shape[3] // 4,
                                     space_to_depth=True)
            pad = space_to_depth_pad(x.shape[1], kq.shape[1], pad, lo,
                                     kq2.shape[1])
            kq, stride = kq2, 1
        else:
            sx = self.act_scales[name]
            xq = quantize_activation(x, sx)
        res = rscale = None
        if isinstance(residual, _QT):
            res, rscale = residual.q, residual.scale
        elif residual is not None:
            res = residual.contiguous()
        out_scale = None
        if out == "f32":
            dtype = torch.float32
        elif self.act_storage == "int8" and site is not None:
            dtype, out_scale = torch.int8, self.act_scales[site]
        else:
            dtype = self.act_dtype
        y = int8_conv(xq, sx, kq, ks, stride, pad, dilation, scale=scale,
                      shift=shift, residual=res, residual_scale=rscale,
                      bias_last=bias_last, relu=relu, out_dtype=dtype,
                      out_scale=out_scale, nchw=nchw)
        if nchw:
            y = _nhwc(y)
        return _QT(y, out_scale) if dtype == torch.int8 else y

    def act(self, y, site: Optional[str] = None):
        """A float activation in the inter-site form (``conv``'s ``out``)."""
        if self.act_storage == "int8" and site is not None:
            s = self.act_scales[site]
            return _QT(quantize_activation(y, s), s)
        return y.to(self.act_dtype)


def _normalize(image: torch.Tensor) -> torch.Tensor:
    dev = image.device
    mean = torch.as_tensor((255.0 * np.asarray(IMAGENET_MEAN))
                           .astype(np.float32), device=dev)
    std = torch.as_tensor((255.0 * np.asarray(IMAGENET_STD))
                          .astype(np.float32), device=dev)
    return (image.float() - mean) / std


def _basic_block(ctx, sd, pre, x, name, stride=1, dilation=1,
                 out_site=None):
    """torchvision's BasicBlock at ``pre`` (``encoder.layer1.0.``);
    ``out_site`` names the quantized conv consuming the output."""
    a1, b1 = ctx.bn(sd, f"{pre}bn1")
    a2, b2 = ctx.bn(sd, f"{pre}bn2")
    y = ctx.conv(f"{name}.conv1", x, sd, f"{pre}conv1.weight", stride,
                 dilation, dilation, scale=a1, shift=b1, relu=True,
                 site=f"{name}.conv2")
    # the downsample's BN (an int8 artifact holds no float conv weight)
    if f"{pre}downsample.1.weight" in sd:
        ad, bd = ctx.bn(sd, f"{pre}downsample.1")
        r = ctx.conv(f"{name}.ds", x, sd, f"{pre}downsample.0.weight",
                     stride, 0, scale=ad, shift=bd, out="f32")
    else:
        r = x  # an int8 residual dequantizes in the epilogue
    return ctx.conv(f"{name}.conv2", y, sd, f"{pre}conv2.weight", 1,
                    dilation, dilation, scale=a2, shift=b2, residual=r,
                    relu=True, site=out_site)


def _encoder_forward(ctx, sd, x, output_stride: int = 32, depth: int = 5,
                     feat_sites=None):
    """The resnet18 encoder mirror → stage outputs ``[x2, …]``.  Strides
    past ``output_stride`` become dilations (smp's rule); ``depth`` 3 stops
    after layer2 (PSPNet).  ``feat_sites`` names the quantized conv
    consuming each stage output (ResUNet's skips), else those stay bf16."""
    a0, b0 = ctx.bn(sd, "encoder.bn1")
    # the stem's consumer, through the maxpool, is layer1_0.conv1
    y = ctx.conv("stem", x, sd, "encoder.conv1.weight", 2, 3, scale=a0,
                 shift=b0, relu=True, site="layer1_0.conv1")
    y = _maxpool(y)
    feats = []
    current_stride, dilation = 4, 1
    for li in range(depth - 1):
        s = 1 if li == 0 else 2
        if s == 2:
            if current_stride >= output_stride:
                dilation *= 2
                s = 1
            else:
                current_stride *= 2
        for bi in (0, 1):
            if bi == 0:
                out_site = f"layer{li + 1}_1.conv1"
            else:
                out_site = feat_sites[li] if feat_sites else None
            y = _basic_block(ctx, sd, f"encoder.layer{li + 1}.{bi}.", y,
                             f"layer{li + 1}_{bi}",
                             stride=s if bi == 0 else 1, dilation=dilation,
                             out_site=out_site)
        feats.append(y)
    return feats


def _upconv(sd, name, x):
    """ConvTranspose2d(k=2, s=2) as the JAX mirror's einsum + pixel shuffle,
    in ``x``'s dtype."""
    n, h, w, _ = x.shape
    k = sd[f"{name}.weight"].to(x.dtype)  # (C, F, 2, 2)
    f = k.shape[1]
    z = torch.einsum("nhwc,cfij->nhiwjf", x, k).reshape(n, 2 * h, 2 * w, f)
    return z + sd[f"{name}.bias"].to(x.dtype)


def _concat_conv(ctx, sd, conv, dec, a, b):
    """``conv(cat([a, b]))`` + bias, ReLU, as two quantized halves:
    ``dec.a`` to f32, then ``dec.b`` with it as the residual and the bias
    after it (``ya + yb + bias``)."""
    ca = a.shape[-1]
    cb = sd[f"{conv}.weight"].shape[1]
    ya = ctx.conv(f"{dec}.a", a, sd, f"{conv}.weight", 1, 1, cin=(0, ca),
                  out="f32")
    return ctx.conv(f"{dec}.b", b, sd, f"{conv}.weight", 1, 1,
                    cin=(ca, cb), residual=ya, shift=sd[f"{conv}.bias"],
                    bias_last=True, relu=True)


def resunet_forward(ctx, sd, image, output_size: int):
    """uint8 NHWC → sigmoid probabilities, ResUNet (reference
    ``models/resunet.py``): stage outputs x2..x4 are also the decoder's
    skips, quantized convs, so under int8 storage they stay int8."""
    x = _normalize(image)
    x2, x3, x4, x5 = _encoder_forward(
        ctx, sd, x, feat_sites=("layer2_0.conv1", "layer3_0.conv1",
                                "layer4_0.conv1", None))
    y = _concat_conv(ctx, sd, "conv1", "dec1", _upconv(sd, "upconv1", x5), x4)
    y = _concat_conv(ctx, sd, "conv2", "dec2", _upconv(sd, "upconv2", y), x3)
    y = _concat_conv(ctx, sd, "conv3", "dec3", _upconv(sd, "upconv3", y), x2)
    k4 = sd["conv4.weight"][0, :, 0, 0].to(y.dtype)
    logits = torch.matmul(y, k4).float() + sd["conv4.bias"][0].float()
    logits = resize_bilinear(logits[:, None], output_size, output_size)
    return torch.sigmoid(logits[:, 0])


def _head_1x1(sd, y, output_size: int):
    """The 1×1 segmentation head in f32 and the corner-aligned resize →
    sigmoid of class 0."""
    k = sd["segmentation_head.0.weight"][:, :, 0, 0].float()
    logits = y.float() @ k.T + sd["segmentation_head.0.bias"].float()
    logits = resize_bilinear(_nchw(logits), output_size, output_size,
                             align_corners=True)
    return torch.sigmoid(logits[:, 0])


def fpn_forward(ctx, sd, image, output_size: int):
    """uint8 NHWC → sigmoid probabilities, FPN (``models/fpn.py``, the
    reference's default model).  Each seg conv writes f32 NCHW for the
    GroupNorm kernel."""
    x = _normalize(image)
    c2, c3, c4, c5 = _encoder_forward(ctx, sd, x)

    def lateral(name, prefix, feat):
        return ctx.conv(name, feat, sd, f"{prefix}.weight", 1, 0,
                        shift=sd[f"{prefix}.bias"])

    p5 = lateral("lateral5", "decoder.p5", c5)
    p4 = ctx.act(lateral("lateral4", "decoder.p4.skip_conv", c4) + _up2(p5))
    p3 = ctx.act(lateral("lateral3", "decoder.p3.skip_conv", c3) + _up2(p4))
    p2 = ctx.act(lateral("lateral2", "decoder.p2.skip_conv", c2) + _up2(p3))

    def seg_conv(i, j, y):
        pre = f"decoder.seg_blocks.{i}.block.{j}.block"
        y = ctx.conv(f"seg{i}_{j}.conv", y, sd, f"{pre}.0.weight", 1, 1,
                     out="f32", nchw=True)
        y = group_norm_relu(_nchw(y), sd[f"{pre}.1.weight"],
                            sd[f"{pre}.1.bias"], num_groups=32, eps=GN_EPS)
        return ctx.act(_nhwc(y))

    outs = []
    for i, (p, n_up) in enumerate(((p5, 3), (p4, 2), (p3, 1), (p2, 0))):
        y = seg_conv(i, 0, p)
        if n_up > 0:
            y = _up2(y)
        for j in range(1, n_up):
            y = _up2(seg_conv(i, j, y))
        outs.append(y)
    y = outs[0]
    for o in outs[1:]:
        y = y + o
    return _head_1x1(sd, y, output_size)


def _conv_bn_relu(ctx, sd, conv, bn, name, x):
    """A quantized 1×1 conv (no bias) + BN + ReLU."""
    a, b = ctx.bn(sd, bn)
    return ctx.conv(name, x, sd, f"{conv}.weight", 1, 0, scale=a, shift=b,
                    relu=True)


def _sep_conv_bn_relu(ctx, sd, sep, bn, name, x, dilation=1):
    """smp's separable conv + BN + ReLU: the depthwise 3×3 in f32, the
    pointwise quantized."""
    dw = _float_conv(x, sd[f"{sep}.0.weight"], 1, dilation, dilation,
                     groups=x.shape[-1])
    return _conv_bn_relu(ctx, sd, f"{sep}.1", bn, f"{name}.pointwise", dw)


def deeplab_forward(ctx, sd, image, output_size: int,
                    atrous_rates=(3, 6, 9)):
    """uint8 NHWC → sigmoid probabilities, DeepLabV3+
    (``models/deeplabv3plus.py``) at output stride 16 with the config's
    rates."""
    x = _normalize(image)
    feats = _encoder_forward(ctx, sd, x, output_stride=16)
    c2, c5 = feats[0], feats[3]
    aspp = "decoder.aspp.0"
    branches = [_conv_bn_relu(ctx, sd, f"{aspp}.convs.0.0", f"{aspp}.convs.0.1",
                              "aspp.1x1", c5)]
    for i, rate in enumerate(atrous_rates):
        branches.append(_sep_conv_bn_relu(
            ctx, sd, f"{aspp}.convs.{i + 1}.0", f"{aspp}.convs.{i + 1}.1",
            f"aspp.r{i}", c5, dilation=rate))
    n, h, w, _ = c5.shape
    pooled = c5.float().mean(dim=(1, 2), keepdim=True)
    a, b = ctx.bn(sd, f"{aspp}.convs.4.2")
    pooled = torch.clamp_min(
        _float_conv(pooled, sd[f"{aspp}.convs.4.1.weight"]) * a + b, 0.0)
    branches.append(ctx.act(pooled.expand(n, h, w, pooled.shape[-1])))
    y = torch.cat(branches, dim=-1)
    y = _conv_bn_relu(ctx, sd, f"{aspp}.project.0", f"{aspp}.project.1",
                      "aspp.project", y)
    # dropout is the identity at inference
    y = _sep_conv_bn_relu(ctx, sd, "decoder.aspp.1", "decoder.aspp.2",
                          "aspp_sep", y)
    y = _nhwc(resize_bilinear(_nchw(y.float()), c2.shape[1], c2.shape[2],
                              align_corners=True))
    skip = _conv_bn_relu(ctx, sd, "decoder.block1.0", "decoder.block1.1",
                         "skip", c2)
    y = torch.cat([ctx.act(y), skip], dim=-1)
    y = _sep_conv_bn_relu(ctx, sd, "decoder.block2.0", "decoder.block2.1",
                          "fuse", y)
    return _head_1x1(sd, y, output_size)


def pspnet_forward(ctx, sd, image, output_size: int,
                   pool_sizes=(1, 2, 3, 6)):
    """uint8 NHWC → sigmoid probabilities, PSPNet (``models/pspnet.py``,
    encoder depth 3): the pyramid's branches in f32, the bottleneck
    quantized, the 3×3 head in f32."""
    x = _normalize(image)
    c3 = _encoder_forward(ctx, sd, x, depth=3)[-1]
    h, w = c3.shape[1], c3.shape[2]
    branches = []
    for i, size in enumerate(pool_sizes):
        pre = f"decoder.psp.blocks.{i}.pool.1"
        y = F.adaptive_avg_pool2d(_nchw(c3.float()), size)
        y = F.conv2d(y, sd[f"{pre}.0.weight"].float())
        if size > 1:
            a, b = ctx.bn(sd, f"{pre}.1")
            y = y * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
        else:  # smp's 1x1 bin has no BN; its conv carries the bias
            y = y + sd[f"{pre}.0.bias"].float().view(1, -1, 1, 1)
        y = torch.clamp_min(y, 0.0)
        branches.append(ctx.act(_nhwc(resize_bilinear(y, h, w,
                                                      align_corners=True))))
    y = torch.cat(branches + [c3], dim=-1)
    a, b = ctx.bn(sd, "decoder.conv.1")
    y = ctx.conv("bottleneck", y, sd, "decoder.conv.0.weight", 1, 0,
                 scale=a, shift=b, relu=True)
    # channel dropout is the identity at inference
    logits = F.conv2d(_nchw(y.float()),
                      sd["segmentation_head.0.weight"].float(),
                      sd["segmentation_head.0.bias"].float(), padding=1)
    logits = resize_bilinear(logits, output_size, output_size,
                             align_corners=True)
    return torch.sigmoid(logits[:, 0])


FORWARDS = {"unet": resunet_forward, "fpn": fpn_forward,
            "deeplabv3+": deeplab_forward, "pspnet": pspnet_forward}


# -- the sites ---------------------------------------------------------------

def _encoder_sites(layers: int = 4) -> Dict[str, tuple]:
    sites = {"stem": ("encoder.conv1.weight", None)}
    for li in range(1, layers + 1):
        for bi in range(2):
            pre = f"encoder.layer{li}.{bi}"
            sites[f"layer{li}_{bi}.conv1"] = (f"{pre}.conv1.weight", None)
            sites[f"layer{li}_{bi}.conv2"] = (f"{pre}.conv2.weight", None)
            if li > 1 and bi == 0:  # resnet18: a downsample opens 2..4
                sites[f"layer{li}_{bi}.ds"] = (
                    f"{pre}.downsample.0.weight", None)
    return sites


def _resunet_sites(sd) -> Dict[str, tuple]:
    sites = _encoder_sites()
    for d in (1, 2, 3):
        cin = sd[f"conv{d}.weight"].shape[1]
        sites[f"dec{d}.a"] = (f"conv{d}.weight", (0, cin // 2))
        sites[f"dec{d}.b"] = (f"conv{d}.weight", (cin // 2, cin))
    return sites


def _fpn_sites(sd) -> Dict[str, tuple]:
    sites = _encoder_sites()
    sites["lateral5"] = ("decoder.p5.weight", None)
    for lvl in (4, 3, 2):
        sites[f"lateral{lvl}"] = (f"decoder.p{lvl}.skip_conv.weight", None)
    for i, n_blocks in enumerate((3, 2, 1, 1)):
        for j in range(n_blocks):
            sites[f"seg{i}_{j}.conv"] = (
                f"decoder.seg_blocks.{i}.block.{j}.block.0.weight", None)
    return sites


def _deeplab_sites(sd) -> Dict[str, tuple]:
    sites = _encoder_sites()
    aspp = "decoder.aspp.0"
    sites["aspp.1x1"] = (f"{aspp}.convs.0.0.weight", None)
    i = 0
    while f"{aspp}.convs.{i + 1}.0.1.weight" in sd:
        sites[f"aspp.r{i}.pointwise"] = (f"{aspp}.convs.{i + 1}.0.1.weight",
                                         None)
        i += 1
    sites["aspp.project"] = (f"{aspp}.project.0.weight", None)
    sites["aspp_sep.pointwise"] = ("decoder.aspp.1.1.weight", None)
    sites["skip"] = ("decoder.block1.0.weight", None)
    sites["fuse.pointwise"] = ("decoder.block2.0.1.weight", None)
    return sites


def _pspnet_sites(sd) -> Dict[str, tuple]:
    sites = _encoder_sites(layers=2)
    sites["bottleneck"] = ("decoder.conv.0.weight", None)
    return sites


SITES = {"unet": _resunet_sites, "fpn": _fpn_sites,
         "deeplabv3+": _deeplab_sites, "pspnet": _pspnet_sites}


def site_weights(model_name: str, sd) -> Dict[str, torch.Tensor]:
    """Each quantized site's float OIHW weight (ResUNet's halves sliced)."""
    out = {}
    for site, (key, cin) in SITES[model_name](sd).items():
        w = sd[key]
        out[site] = w if cin is None else w[:, cin[0]:cin[1]]
    return out


def _quantize(model_name, sd, act_scales) -> dict:
    return {"qweights": {site: quantize_weights(w) for site, w
                         in site_weights(model_name, sd).items()},
            "act_scales": dict(act_scales)}


def quantize_resunet(sd, act_scales) -> dict:
    """The bundle of :func:`make_quantized_infer_step` for ResUNet: every
    site's int8 weights and scales, and the activation scales."""
    return _quantize("unet", sd, act_scales)


def quantize_fpn(sd, act_scales) -> dict:
    """The bundle for FPN (encoder, laterals, seg convs)."""
    return _quantize("fpn", sd, act_scales)


def quantize_deeplab(sd, act_scales) -> dict:
    """The bundle for DeepLabV3+ (encoder, ASPP, skip, fuse)."""
    return _quantize("deeplabv3+", sd, act_scales)


def quantize_pspnet(sd, act_scales) -> dict:
    """The bundle for PSPNet (the depth-3 encoder and the bottleneck)."""
    return _quantize("pspnet", sd, act_scales)


QUANTIZERS = {"unet": quantize_resunet, "fpn": quantize_fpn,
              "deeplabv3+": quantize_deeplab, "pspnet": quantize_pspnet}


# -- calibration and the steps -----------------------------------------------

def _device_of(sd) -> torch.device:
    return next(iter(sd.values())).device


def _images(images, device) -> torch.Tensor:
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
    return images.to(device)


def calibrate(sd, batches, output_size: int, forward=resunet_forward
              ) -> Dict[str, float]:
    """Run the float mirror over ``batches`` of uint8 NHWC images (numpy or
    tensors) on ``sd``'s device; per-site activation scales (amax / 127,
    the largest over batches; 1 where a site saw only zeros)."""
    dev = _device_of(sd)
    amax: Dict[str, float] = {}
    affines: dict = {}
    for image in batches:
        ctx = _Ctx("float", affines=affines)
        with torch.inference_mode(), _exact_f32():
            forward(ctx, sd, _images(image, dev), output_size)
        names = list(ctx.stats)
        values = torch.stack([ctx.stats[k] for k in names]).cpu().tolist()
        for k, v in zip(names, values):
            amax[k] = max(amax.get(k, 0.0), v)
    return {k: (v / 127.0 if v > 0 else 1.0) for k, v in amax.items()}


def make_quantized_infer_step(sd, bundle, output_size: int,
                              forward=resunet_forward,
                              act_storage: str = "int8"):
    """``step(images_u8) → probs`` on the int8 path: uint8 NHWC images on
    ``sd``'s device (numpy is uploaded) → float32 ``(N, S, S)`` sigmoid
    probabilities.  ``act_storage="int8"`` (default) keeps activations
    whose consumer is a quantized conv int8 between sites; ``"bf16"``
    keeps every activation bf16.  The step is also the WSI runners'
    ``infer_step`` (the JAX ``make_quantized_infer_fn``'s place)."""
    if act_storage not in ACT_STORAGES:
        raise ValueError(f"act_storage must be one of {ACT_STORAGES}, got "
                         f"{act_storage!r}")
    act = {k: float(np.float32(v)) for k, v in bundle["act_scales"].items()}
    qweights = bundle["qweights"]
    # the stem (7x7/2, pad 3) on its space-to-depth input
    s2d = {"stem": space_to_depth_weights(qweights["stem"][0], 3)}
    dev = _device_of(sd)
    affines: dict = {}

    @torch.inference_mode()
    def step(images) -> torch.Tensor:
        ctx = _Ctx("int8", act_scales=act, qweights=qweights,
                   act_storage=act_storage, affines=affines, s2d=s2d)
        return forward(ctx, sd, _images(images, dev), output_size)

    return step



def make_float_infer_step(sd, output_size: int, forward=resunet_forward):
    """The float mirror as ``step(images_u8) → probs`` (f32, cuDNN without
    TF32), for parity checks against the model."""
    dev = _device_of(sd)
    affines: dict = {}

    @torch.inference_mode()
    def step(images) -> torch.Tensor:
        with _exact_f32():
            return forward(_Ctx("float", affines=affines), sd,
                           _images(images, dev), output_size)

    return step


def _with_stain(forward, stain: str):
    """``forward`` on stain-normalized pixels, exactly as the float path's
    ``eval_images`` makes them, so calibration and serving agree."""
    check_method(stain)
    if stain == "none":
        return forward

    def staining_forward(ctx, sd, image, output_size):
        c255 = torch.full((1,), 255.0, dtype=torch.float32,
                          device=image.device)
        image = apply_stain_batch(image.float() / c255, stain) * c255
        return forward(ctx, sd, image, output_size)

    return staining_forward


def make_forward(model_name: str, backbone: str = "resnet18",
                 stain: str = "none", **model_kw):
    """The int8 mirror forward of ``model_name`` with its topology
    arguments (``atrous_rates`` for deeplabv3+) and the stain hook.  The
    encoder mirror is resnet18 only; anything else is refused up front."""
    if model_name not in FORWARDS:
        raise ValueError(
            f"no int8 path for model {model_name!r} "
            f"(supported: {sorted(FORWARDS)})")
    if backbone != "resnet18":
        raise ValueError(
            f"int8 serving mirrors a resnet18 encoder; backbone "
            f"{backbone!r} is not supported (use the bf16 path)")
    forward = FORWARDS[model_name]
    if model_kw:
        forward = functools.partial(forward, **model_kw)
    return _with_stain(forward, stain)


def quantize_model(model_name: str, sd, calib_batches, output_size: int,
                   backbone: str = "resnet18", stain: str = "none",
                   **model_kw):
    """Calibrate on ``calib_batches`` (uint8 NHWC) and quantize: ``(bundle,
    forward)`` for :func:`make_quantized_infer_step`.  ``sd`` is the model's
    ``state_dict`` on the device to calibrate and serve on."""
    forward = make_forward(model_name, backbone, stain, **model_kw)
    scales = calibrate(sd, calib_batches, output_size, forward=forward)
    return QUANTIZERS[model_name](sd, scales), forward


def model_kwargs(cfg) -> dict:
    """The topology arguments a config gives the int8 forward."""
    if cfg.model == "deeplabv3+":
        return {"atrous_rates": tuple(int(r) for r in cfg.dilations)}
    return {}


def quantize_from_config(cfg, sd, calib_batches):
    """:func:`quantize_model` with the model, backbone, output size,
    DeepLabV3+'s rates and the stain hook taken from ``cfg``."""
    return quantize_model(cfg.model, sd, calib_batches, cfg.img_size,
                          backbone=cfg.backbone, stain=cfg.stain,
                          **model_kwargs(cfg))

"""Weights carried across: reference checkpoints and ImageNet encoder files
in, JAX model trees out.

The port's modules keep torchvision/efficientnet-pytorch/smp/reference
``state_dict`` names, so a reference ``.pth`` loads with
``load_state_dict(strict=True)`` once :func:`drop_unbuilt_keys` has removed
what the port does not build, and :func:`load_pretrained_encoder` puts an
ImageNet encoder file into a model's encoder (the JAX package's
``load_pretrained_encoder``).  The ``*_state_dict_from_jax`` functions turn
the JAX package's parameter trees (as numpy arrays) into the port's
``state_dict``: the inverses of its ``convert_smp_fpn_state_dict``,
``convert_resunet_state_dict``, ``convert_smp_deeplabv3plus_state_dict``,
``convert_smp_pspnet_state_dict`` and of the three encoder converters they
dispatch to, and, for U-Net++ (which has no reference checkpoint, so no
converter there), the map from the flax tree to the port's mirror of it.
:func:`quantized_bundle_from_jax` carries a JAX int8 bundle across.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# the first keys of a bare encoder or model state_dict, as against a
# reference checkpoint's {"model": state_dict, ...}
_STATE_DICT_KEYS = ("conv1", "layer", "features", "_conv_stem", "_blocks",
                    "encoder", "decoder")


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (``{"model": state_dict, ...}``, as the
    reference's ``train_worker.py`` writes it) or a bare ``state_dict``,
    with the DDP ``module.`` prefix stripped; tensors on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "model" in obj and not any(
            k.startswith(_STATE_DICT_KEYS) for k in obj):
        obj = obj["model"]
    return {k.replace("module.", ""): v for k, v in obj.items()
            if torch.is_tensor(v)}


def seeded_state_dict(model: torch.nn.Module,
                      seed: int) -> Dict[str, torch.Tensor]:
    """Random weights for ``model``'s ``state_dict`` from a numpy seed:
    convolutions N(0, 1/fan_in), norm scales U(0.5, 1.5), biases and BN
    running means N(0, 0.1²), BN running variances U(0.5, 1.5).  For
    smoke runs and tests, which have no trained checkpoint."""
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            v = np.zeros(shape, np.int64)
        elif t.dim() == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf in ("running_var", "weight"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        out[name] = torch.from_numpy(np.asarray(v).astype(
            np.int64 if leaf == "num_batches_tracked" else np.float32))
    return out


def _conv(sd: dict, name: str, node: Mapping[str, Any],
          bias: bool = False) -> None:
    # flax HWIO -> torch OIHW
    sd[f"{name}.weight"] = torch.from_numpy(
        np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)).copy())
    if bias:
        sd[f"{name}.bias"] = torch.from_numpy(np.array(node["bias"]))


def _norm_affine(sd: dict, name: str, node: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(np.array(node["scale"]))
    sd[f"{name}.bias"] = torch.from_numpy(np.array(node["bias"]))


def _bn(sd: dict, name: str, p: Mapping[str, Any],
        s: Mapping[str, Any]) -> None:
    _norm_affine(sd, name, p)
    sd[f"{name}.running_mean"] = torch.from_numpy(np.array(s["mean"]))
    sd[f"{name}.running_var"] = torch.from_numpy(np.array(s["var"]))
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def resnet_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any],
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX ``ResNetEncoder`` trees → torchvision names."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}conv1", params["conv1"])
    _bn(sd, f"{prefix}bn1", params["bn1"], batch_stats["bn1"])
    blocks = sorted((k for k in params if k.startswith("layer")),
                    key=lambda k: tuple(int(v) for v in k[5:].split("_")))
    for name in blocks:
        stage, b = name[5:].split("_")
        tname = f"{prefix}layer{stage}.{b}"
        p, s = params[name], batch_stats[name]
        for i in (1, 2, 3):
            if f"conv{i}" in p:
                _conv(sd, f"{tname}.conv{i}", p[f"conv{i}"])
                _bn(sd, f"{tname}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
        if "downsample_conv" in p:
            _conv(sd, f"{tname}.downsample.0", p["downsample_conv"])
            _bn(sd, f"{tname}.downsample.1", p["downsample_bn"],
                s["downsample_bn"])
    return sd


def mobilenetv2_state_dict_from_jax(params: Mapping[str, Any],
                                    batch_stats: Mapping[str, Any],
                                    prefix: str = ""
                                    ) -> Dict[str, torch.Tensor]:
    """The JAX ``MobileNetV2Encoder`` trees → torchvision names, the inverse
    of the JAX ``convert_mobilenetv2_state_dict``: ``features_i`` →
    ``features.i``; an expand-ratio-1 block's depthwise conv at
    ``conv.0``, its projection at ``conv.1``/``conv.2``, an expand-ratio-6
    block's expand at ``conv.0``, depthwise at ``conv.1``, projection at
    ``conv.2``/``conv.3``.  Depthwise kernels go (k, k, 1, C) → (C, 1, k,
    k)."""
    sd: Dict[str, torch.Tensor] = {}
    n = len([k for k in params if k.startswith("features_")])
    for i in range(n):
        p, s = params[f"features_{i}"], batch_stats[f"features_{i}"]
        pre = f"{prefix}features.{i}"
        if "conv" in p:  # the stem and the last 1x1 conv
            _conv_bn(sd, f"{pre}.0", f"{pre}.1", p, s)
            continue
        convs = (["expand"] if "expand" in p else []) + ["depthwise"]
        for j, name in enumerate(convs):
            _conv_bn(sd, f"{pre}.conv.{j}.0", f"{pre}.conv.{j}.1", p[name],
                     s[name])
        j = len(convs)
        _conv_bn(sd, f"{pre}.conv.{j}", f"{pre}.conv.{j + 1}", p["project"],
                 s["project"])
    return sd


def efficientnet_state_dict_from_jax(params: Mapping[str, Any],
                                     batch_stats: Mapping[str, Any],
                                     prefix: str = ""
                                     ) -> Dict[str, torch.Tensor]:
    """The JAX ``EfficientNetEncoder`` trees → efficientnet-pytorch names,
    the inverse of the JAX ``convert_efficientnet_state_dict``:
    ``stem_conv``/``stem_bn`` → ``_conv_stem``/``_bn0``, ``blocks_N`` →
    ``_blocks.N`` (``expand_*`` → ``_expand_conv``/``_bn0``,
    ``depthwise_*`` → ``_depthwise_conv``/``_bn1``, ``se_*`` with their
    biases, ``project_*`` → ``_project_conv``/``_bn2``)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}_conv_stem", params["stem_conv"])
    _bn(sd, f"{prefix}_bn0", params["stem_bn"]["bn"],
        batch_stats["stem_bn"]["bn"])
    n = len([k for k in params if k.startswith("blocks_")])
    for i in range(n):
        p, s = params[f"blocks_{i}"], batch_stats[f"blocks_{i}"]
        pre = f"{prefix}_blocks.{i}"
        for conv, bn, name in (("_expand_conv", "_bn0", "expand"),
                               ("_depthwise_conv", "_bn1", "depthwise"),
                               ("_project_conv", "_bn2", "project")):
            if f"{name}_conv" in p:
                _conv(sd, f"{pre}.{conv}", p[f"{name}_conv"])
                _bn(sd, f"{pre}.{bn}", p[f"{name}_bn"]["bn"],
                    s[f"{name}_bn"]["bn"])
        for name in ("_se_reduce", "_se_expand"):
            _conv(sd, f"{pre}.{name}", p[name[1:]], bias=True)
    return sd


def encoder_state_dict_from_jax(params: Mapping[str, Any],
                                batch_stats: Mapping[str, Any],
                                prefix: str = "encoder."
                                ) -> Dict[str, torch.Tensor]:
    """A JAX encoder's trees → the port's names, by the tree's own layout:
    ResNet (``conv1``), MobileNetV2 (``features_0``) or EfficientNet
    (``stem_conv``) — the inverse of the JAX
    ``convert_encoder_state_dict``."""
    if "features_0" in params:
        return mobilenetv2_state_dict_from_jax(params, batch_stats, prefix)
    if "stem_conv" in params:
        return efficientnet_state_dict_from_jax(params, batch_stats, prefix)
    return resnet_state_dict_from_jax(params, batch_stats, prefix)


def fpn_state_dict_from_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX FPN's ``params``/``batch_stats`` (numpy leaves) → the port
    FPN's ``state_dict`` (smp names).  Conv kernels go HWIO → OIHW; BN
    ``scale/bias/mean/var`` become ``weight/bias/running_mean/running_var``
    with ``num_batches_tracked`` 0."""
    sd = encoder_state_dict_from_jax(params["encoder"], batch_stats["encoder"])
    _conv(sd, "decoder.p5", params["lateral5"], bias=True)
    for lvl in (4, 3, 2):
        _conv(sd, f"decoder.p{lvl}.skip_conv", params[f"lateral{lvl}"],
              bias=True)
    for i, n_blocks in enumerate((3, 2, 1, 1)):
        for j in range(n_blocks):
            pre = f"decoder.seg_blocks.{i}.block.{j}.block"
            node = params[f"seg{i}_{j}"]
            _conv(sd, f"{pre}.0", node["Conv_0"])
            _norm_affine(sd, f"{pre}.1", node["GroupNorm_0"])
    _conv(sd, "segmentation_head.0", params["head"], bias=True)
    return sd


def resunet_state_dict_from_jax(params: Mapping[str, Any],
                                batch_stats: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """The JAX ResUNet's ``params``/``batch_stats`` (numpy leaves) → the
    port ResUNet's ``state_dict`` (the reference's names), the inverse of
    the JAX ``convert_resunet_state_dict``.  flax keeps a transposed conv's
    taps spatially flipped in (kH, kW, in, out); torch wants them unflipped
    in (in, out, kH, kW)."""
    sd = resnet_state_dict_from_jax(params["encoder"],
                                    batch_stats["encoder"], "encoder.")
    for name in ("upconv1", "upconv2", "upconv3"):
        k = np.asarray(params[name]["kernel"])
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            k[::-1, ::-1].transpose(2, 3, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(params[name]["bias"]))
    for name in ("conv1", "conv2", "conv3", "conv4"):
        _conv(sd, name, params[name], bias=True)
    return sd


def _separable(sd: dict, torch_sep: str, torch_bn: str,
               p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
    # smp's SeparableConv2d: depthwise at .0, pointwise at .1, then the BN
    _conv(sd, f"{torch_sep}.0", p["depthwise"])
    _conv(sd, f"{torch_sep}.1", p["pointwise"])
    _bn(sd, torch_bn, p["bn"], s["bn"])


def _conv_bn(sd: dict, torch_conv: str, torch_bn: str,
             p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
    _conv(sd, torch_conv, p["conv"])
    _bn(sd, torch_bn, p["bn"], s["bn"])


def deeplabv3plus_state_dict_from_jax(params: Mapping[str, Any],
                                      batch_stats: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX DeepLabV3Plus's ``params``/``batch_stats`` → the port's
    ``state_dict`` (smp names), the inverse of the JAX
    ``convert_smp_deeplabv3plus_state_dict``."""
    sd = encoder_state_dict_from_jax(params["encoder"], batch_stats["encoder"])
    pa, sa = params["aspp"], batch_stats["aspp"]
    aspp = "decoder.aspp.0"
    _conv_bn(sd, f"{aspp}.convs.0.0", f"{aspp}.convs.0.1",
             pa["branch_1x1"], sa["branch_1x1"])
    for i in (1, 2, 3):
        _separable(sd, f"{aspp}.convs.{i}.0", f"{aspp}.convs.{i}.1",
                   pa[f"branch_r{i - 1}"], sa[f"branch_r{i - 1}"])
    _conv_bn(sd, f"{aspp}.convs.4.1", f"{aspp}.convs.4.2",
             pa["branch_pool"], sa["branch_pool"])
    _conv_bn(sd, f"{aspp}.project.0", f"{aspp}.project.1", pa["project"],
             sa["project"])
    _separable(sd, "decoder.aspp.1", "decoder.aspp.2", params["aspp_sep"],
               batch_stats["aspp_sep"])
    _conv_bn(sd, "decoder.block1.0", "decoder.block1.1",
             params["skip_project"], batch_stats["skip_project"])
    _separable(sd, "decoder.block2.0", "decoder.block2.1", params["fuse"],
               batch_stats["fuse"])
    _conv(sd, "segmentation_head.0", params["head"], bias=True)
    return sd


def pspnet_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX PSPNet's ``params``/``batch_stats`` → the port's
    ``state_dict`` (smp names), the inverse of the JAX
    ``convert_smp_pspnet_state_dict``: bins (1, 2, 3, 6) are blocks 0..3,
    the 1×1 bin a conv with a bias and no BN."""
    sd = encoder_state_dict_from_jax(params["encoder"], batch_stats["encoder"])
    for i, size in enumerate((1, 2, 3, 6)):
        pre = f"decoder.psp.blocks.{i}.pool.1"
        node = params[f"psp_{size}"]
        if size == 1:
            _conv(sd, f"{pre}.0", node["conv"], bias=True)
        else:
            _conv_bn(sd, f"{pre}.0", f"{pre}.1", node,
                     batch_stats[f"psp_{size}"])
    _conv(sd, "decoder.conv.0", params["bottleneck_conv"])
    _bn(sd, "decoder.conv.1", params["bottleneck_bn"],
        batch_stats["bottleneck_bn"])
    _conv(sd, "segmentation_head.0", params["head"], bias=True)
    return sd


def unetplusplus_state_dict_from_jax(params: Mapping[str, Any],
                                     batch_stats: Mapping[str, Any]
                                     ) -> Dict[str, torch.Tensor]:
    """The JAX UNetPlusPlus's ``params``/``batch_stats`` → the port's
    ``state_dict``: ``x_{i}_{j}/{conv0,bn0,conv1,bn1}`` keep their names,
    ``head`` too, the encoder takes torchvision's or efficientnet-pytorch's."""
    sd = encoder_state_dict_from_jax(params["encoder"], batch_stats["encoder"])
    nodes = sorted((k for k in params if k.startswith("x_")),
                   key=lambda k: tuple(int(v) for v in k[2:].split("_"))[::-1])
    for name in nodes:
        p, s = params[name], batch_stats[name]
        for i in (0, 1):
            _conv(sd, f"{name}.conv{i}", p[f"conv{i}"])
            _bn(sd, f"{name}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
    _conv(sd, "head", params["head"], bias=True)
    return sd


def quantized_bundle_from_jax(bundle: Mapping[str, Any]) -> dict:
    """A JAX int8 bundle (``infer/quantized.py``: per site an HWIO int8
    kernel and its per-output-channel scales, per site an activation scale)
    → the port's: ``(F, KH, KW, C)`` int8 kernels and float32 scales on
    the CPU, the activation scales as floats, under the same site names."""
    qweights = {}
    for site, (kq, ks) in bundle["qweights"].items():
        k = np.asarray(kq)
        if k.dtype != np.int8:
            raise TypeError(f"{site}: expected an int8 kernel, got {k.dtype}")
        qweights[site] = (
            torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2))),
            torch.from_numpy(np.asarray(ks, np.float32).copy()))
    return {"qweights": qweights,
            "act_scales": {k: float(v)
                           for k, v in bundle["act_scales"].items()}}


def drop_unbuilt_keys(model: torch.nn.Module,
                      sd: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """``sd`` without the keys of reference parameters that ``model`` does
    not build: its encoder's classifier (the encoder's ``unbuilt_keys``
    under ``encoder.``: a reference ResUNet's ``encoder.fc.*``, smp
    EfficientNet's ``encoder._conv_head.*``/``encoder._bn1.*``, which are
    not the blocks' own ``encoder._blocks.N._bn1.*``), so that the rest
    loads with ``strict=True``."""
    unbuilt = tuple(f"encoder.{k}" for k in model.encoder.unbuilt_keys)
    return {k: v for k, v in sd.items() if not k.startswith(unbuilt)}


def load_pretrained_encoder(model: torch.nn.Module, path: str) -> None:
    """Load an ImageNet encoder file into ``model.encoder`` (the JAX
    package's ``load_pretrained_encoder``): an ``.npz`` with torch key
    names (what ``scripts/convert_torchvision_resnet18.py`` writes), a bare
    ``.pth`` state_dict (torchvision's resnet or mobilenet_v2,
    efficientnet-pytorch's), or a reference checkpoint, whose
    ``encoder.*`` keys are taken.  ``module.`` prefixes are stripped and
    the classifier top (the encoder's ``unbuilt_keys``: ``fc.``,
    ``classifier.``, ``_conv_head.``, ``_bn1.``, ``_fc.``) is dropped.
    Every encoder weight and BN statistic must be in the file and nothing
    else may be (``num_batches_tracked`` may be absent): otherwise a
    ``KeyError`` names what is wrong, as the JAX graft's strict coverage
    check does."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k.replace("module.", ""): torch.from_numpy(z[k])
                  for k in z.files}
    else:
        sd = load_reference_state_dict(path)
    if any(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    encoder = model.encoder
    sd = {k: v for k, v in sd.items()
          if not k.startswith(encoder.unbuilt_keys)}
    own = encoder.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(
            f"{path} does not fit the {type(encoder).__name__}: "
            f"{len(missing)} encoder tensors missing {missing[:4]}, "
            f"{len(unexpected)} unknown {unexpected[:4]}")
    encoder.load_state_dict(sd, strict=False)

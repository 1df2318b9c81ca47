"""Weights carried across: reference checkpoints in, JAX model trees out.

The port's modules keep torchvision/smp/reference ``state_dict`` names, so
a reference ``.pth`` loads with ``load_state_dict(strict=True)`` once
:func:`drop_unbuilt_keys` has removed what the port does not build.
The ``*_state_dict_from_jax`` functions turn the JAX package's parameter
trees (as numpy arrays) into the port's ``state_dict``: the inverses of its
``convert_smp_fpn_state_dict``, ``convert_resunet_state_dict``,
``convert_smp_deeplabv3plus_state_dict`` and
``convert_smp_pspnet_state_dict``, and, for U-Net++ (which has no
reference checkpoint, so no converter there), the map from the flax tree
to the port's mirror of it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (``{"model": state_dict, ...}``, as the
    reference's ``train_worker.py`` writes it) or a bare ``state_dict``,
    with the DDP ``module.`` prefix stripped; tensors on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "model" in obj and not any(
            k.startswith(("conv1", "layer", "encoder", "decoder"))
            for k in obj):
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


def fpn_state_dict_from_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX FPN's ``params``/``batch_stats`` (numpy leaves) → the port
    FPN's ``state_dict`` (smp names).  Conv kernels go HWIO → OIHW; BN
    ``scale/bias/mean/var`` become ``weight/bias/running_mean/running_var``
    with ``num_batches_tracked`` 0."""
    sd = resnet_state_dict_from_jax(params["encoder"],
                                    batch_stats["encoder"], "encoder.")
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
    sd = resnet_state_dict_from_jax(params["encoder"],
                                    batch_stats["encoder"], "encoder.")
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
    sd = resnet_state_dict_from_jax(params["encoder"],
                                    batch_stats["encoder"], "encoder.")
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
    ``head`` too, the encoder takes torchvision's."""
    sd = resnet_state_dict_from_jax(params["encoder"],
                                    batch_stats["encoder"], "encoder.")
    nodes = sorted((k for k in params if k.startswith("x_")),
                   key=lambda k: tuple(int(v) for v in k[2:].split("_"))[::-1])
    for name in nodes:
        p, s = params[name], batch_stats[name]
        for i in (0, 1):
            _conv(sd, f"{name}.conv{i}", p[f"conv{i}"])
            _bn(sd, f"{name}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
    _conv(sd, "head", params["head"], bias=True)
    return sd


def drop_unbuilt_keys(model: torch.nn.Module,
                      sd: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """``sd`` without the keys of reference parameters that ``model`` does
    not build (its class's ``unbuilt_keys`` prefixes; ResUNet's
    ``encoder.fc.*``), so that the rest loads with ``strict=True``."""
    unbuilt = tuple(getattr(model, "unbuilt_keys", ()))
    return {k: v for k, v in sd.items() if not k.startswith(unbuilt)}

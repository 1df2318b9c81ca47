"""Weights carried across: reference checkpoints in, JAX model trees out.

The port's modules keep torchvision/smp/reference ``state_dict`` names, so
a reference ``.pth`` loads with ``load_state_dict(strict=True)`` once
:func:`drop_unbuilt_keys` has removed what the port does not build.
:func:`fpn_state_dict_from_jax` and :func:`resunet_state_dict_from_jax`
are the inverses of the JAX package's ``convert_smp_fpn_state_dict`` and
``convert_resunet_state_dict``: they turn that package's parameter trees
(as numpy arrays) into the port's ``state_dict``.
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


def drop_unbuilt_keys(model: torch.nn.Module,
                      sd: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """``sd`` without the keys of reference parameters that ``model`` does
    not build (its class's ``unbuilt_keys`` prefixes; ResUNet's
    ``encoder.fc.*``), so that the rest loads with ``strict=True``."""
    unbuilt = tuple(getattr(model, "unbuilt_keys", ()))
    return {k: v for k, v in sd.items() if not k.startswith(unbuilt)}

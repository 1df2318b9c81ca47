"""Model factory keyed by ``cfg.model`` (the JAX package's
``models/registry.py``).  The port builds FPN and ResUNet so far."""

from __future__ import annotations

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN
from pdac_pathological_image_segmentation_tpu_torch.models.resunet import (
    ResUNet,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_ROADMAP = {
    name: "ROADMAP.md Queue 1, item 4 (the reference's other architectures)"
    for name in ("deeplabv3+", "pspnet", "unet++")
}


def _dtype(name, what: str) -> torch.dtype:
    key = str(name).lower()
    if key not in DTYPES:
        raise ValueError(f"{what} must be one of {tuple(DTYPES)}, got {name!r}")
    return DTYPES[key]


def build_model(cfg: Config) -> nn.Module:
    """The eval-mode model for ``cfg`` on the CPU; move it with ``.to``."""
    dtype = _dtype(cfg.compute_dtype, "compute_dtype")
    if cfg.model == "unet":
        # the reference builds ResUNet on resnet18 whatever cfg.backbone
        # says; the extra layer1_barrier is a TPU fusion barrier and means
        # nothing here, so it is accepted and ignored
        model = ResUNet(num_classes=cfg.num_classes, output_size=cfg.img_size,
                        compute_dtype=dtype,
                        head_dtype=_dtype(cfg.extras.get("head_dtype",
                                                         "float32"),
                                          "head_dtype"))
        return model.eval()
    if cfg.model == "fpn":
        model = FPN(num_classes=cfg.num_classes, output_size=cfg.img_size,
                    backbone=cfg.backbone, compute_dtype=dtype)
        return model.eval()
    if cfg.model in _ROADMAP:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet: {_ROADMAP[cfg.model]}")
    raise ValueError(f"unknown model {cfg.model!r}")

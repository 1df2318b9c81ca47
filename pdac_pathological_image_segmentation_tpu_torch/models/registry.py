"""Model factory keyed by ``cfg.model`` (the JAX package's
``models/registry.py``): all five architectures.  ``pspnet+`` (the
reference ``test.py``'s typo) is canonicalised to ``pspnet`` by
``Config``."""

from __future__ import annotations

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.models.deeplabv3plus import (
    DeepLabV3Plus,
)
from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN
from pdac_pathological_image_segmentation_tpu_torch.models.pspnet import PSPNet
from pdac_pathological_image_segmentation_tpu_torch.models.resunet import (
    ResUNet,
)
from pdac_pathological_image_segmentation_tpu_torch.models.unetplusplus import (
    UNetPlusPlus,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

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
    common = dict(num_classes=cfg.num_classes, output_size=cfg.img_size,
                  backbone=cfg.backbone, compute_dtype=dtype)
    if cfg.model == "fpn":
        return FPN(**common).eval()
    if cfg.model == "deeplabv3+":
        # the reference's smp factory takes cfg["dilations"] as the rates
        return DeepLabV3Plus(atrous_rates=tuple(cfg.dilations),
                             **common).eval()
    if cfg.model == "pspnet":
        return PSPNet(**common).eval()
    if cfg.model == "unet++":
        return UNetPlusPlus(**common).eval()
    raise ValueError(f"unknown model {cfg.model!r}")

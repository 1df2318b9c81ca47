"""Model factory keyed by ``cfg.model`` (the JAX package's
``models/registry.py``).  The port builds FPN so far."""

from __future__ import annotations

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_ROADMAP = {
    "unet": "ROADMAP.md Queue 1, item 3 (unet/resnet18 train step and "
            "ResUNet serving)",
    "deeplabv3+": "ROADMAP.md Queue 1, item 4 (the rest)",
    "pspnet": "ROADMAP.md Queue 1, item 4 (the rest)",
    "unet++": "ROADMAP.md Queue 1, item 4 (the rest)",
}


def build_model(cfg: Config) -> nn.Module:
    """The eval-mode model for ``cfg`` on the CPU; move it with ``.to``."""
    if cfg.model == "fpn":
        model = FPN(num_classes=cfg.num_classes, output_size=cfg.img_size,
                    backbone=cfg.backbone,
                    compute_dtype=DTYPES[cfg.compute_dtype])
        return model.eval()
    if cfg.model in _ROADMAP:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet: {_ROADMAP[cfg.model]}")
    raise ValueError(f"unknown model {cfg.model!r}")

"""Step builders (the JAX package's ``train/steps.py``).  The port has the
inference step so far; the train step is ROADMAP.md Queue 1, item 2."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from pdac_pathological_image_segmentation_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
)

STEM = "encoder.conv1.weight"


def fold_normalize_into_stem(weight: torch.Tensor) -> torch.Tensor:
    """The ImageNet normalize's per-channel scale folded into the stem
    conv's OIHW weight — an exact linear identity:

        normalize(x) = (x − 255·mean)·s,  s = 1/(255·std)
        conv_w(normalize(x)) = conv_{w·s}(x − 255·mean)

    The shifted input is zero exactly where the normalized one is, so the
    stem's zero padding stays exact.  The product is taken in float32, as
    the JAX package takes it."""
    s = torch.as_tensor(
        (1.0 / (255.0 * np.asarray(IMAGENET_STD))).astype(np.float32),
        device=weight.device)
    return weight * s.view(1, 3, 1, 1)


def make_infer_step(model: nn.Module, img_size: int, stain: str = "none"):
    """``step(images_u8) → probs`` — the tile→mask inference path (resize,
    normalize fold, forward, sigmoid), mirroring the JAX
    ``make_infer_step``.

    ``images_u8`` is a uint8 ``(N, H, W, 3)`` tensor on the model's device.
    Tiles of another size are resized to ``img_size`` (float32 bilinear,
    half-pixel centres).  Binary models return float32 ``(N, H, W)`` sigmoid
    probabilities; multi-class models ``(N, H, W, C)`` softmax ones."""
    if stain != "none":
        raise NotImplementedError(
            f"stain={stain!r} is not ported yet (ROADMAP.md Queue 1, item 4)")
    dtype = getattr(model, "compute_dtype", torch.float32)
    stem = dict(model.named_parameters())[STEM]
    if tuple(stem.shape[1:]) != (3, 7, 7):
        raise ValueError(f"{STEM} has shape {tuple(stem.shape)}; the "
                         "normalize fold needs the torchvision stem")
    m255 = torch.as_tensor(
        (255.0 * np.asarray(IMAGENET_MEAN)).astype(np.float32))

    @torch.inference_mode()
    def step(images: torch.Tensor) -> torch.Tensor:
        folded = {STEM: fold_normalize_into_stem(stem)}
        x = images.permute(0, 3, 1, 2)
        if tuple(x.shape[-2:]) != (img_size, img_size):
            x = resize_bilinear(x.float(), img_size, img_size)
        # mean-shifted 0..255 pixels, in the compute dtype; the 1/(255·std)
        # scale lives in the folded stem weight
        shift = m255.to(device=x.device, dtype=dtype).view(1, 3, 1, 1)
        x = x.to(dtype) - shift
        out = functional_call(model, folded, (x.contiguous(),))
        if getattr(model, "num_classes", 1) > 1:
            return torch.softmax(out.float(), dim=1).permute(0, 2, 3, 1)
        return torch.sigmoid(out[:, 0].float())

    return step

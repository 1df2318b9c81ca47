"""Step factories (the JAX package's ``train/steps.py``): the train step,
the eval step and the tile→mask inference step.

The train step is the reference's per-batch body (``train_worker.py:67-83``):
augmentation (the fused kernel, ``ops/fused_augment.py``) → train-mode
forward → Dice → backward (the GroupNorm backward kernel at every GN site)
→ Adam.  It returns the loss and the score as tensors on the device and
never waits for the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from pdac_pathological_image_segmentation_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    check_supported,
    draw_augment_scalars,
    eval_images,
    eval_transform,
    make_augment_tables,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
    fused_train_transform,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.stain import (
    check_method,
)
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    Objective,
)

STEM = "encoder.conv1.weight"
_NOT_PORTED = {
    "remat": "remat (activation recomputation) is not ported yet "
             "(ROADMAP.md Queue 1, item 4)",
    "grad_accum_steps": "grad_accum_steps > 1 is not ported yet "
                        "(ROADMAP.md Queue 1, item 4)",
    "fused_augment": "fused_augment: false would run the plain augmentation "
                     "on the card, which the port does not do (the plain "
                     "chain is the kernel's reference only; ROADMAP.md "
                     "Queue 1, item 4)",
}


def step_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The CPU generator of one train step, seeded from ``(seed, epoch,
    step)`` (the JAX package folds the epoch and the step into its key).
    The augmentation draws and the dropout masks come from it, on the host,
    so a step draws the same numbers on the card and on the CPU."""
    state = np.random.SeedSequence([seed, epoch, step]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    img_size: int, objective: Objective,
                    augment: bool = True, fused_augment: bool = True,
                    remat: bool = False, grad_accum_steps: int = 1,
                    parity_mode: bool = False, stain: str = "none"):
    """``step(images_u8, masks_u8, valid, generator) → (loss, score)``.

    ``images_u8`` (N, S, S, 3) and ``masks_u8`` (N, S, S) uint8 and
    ``valid`` (N,) bool lie on the model's device; ``valid`` False marks
    the wrap-padded samples of a final partial batch, which pass through
    BatchNorm's batch statistics but not the loss or the score.  The
    augmentation is the fused kernel on bf16 (the JAX package's default
    where the kernel applies); ``augment=False`` takes ``eval_transform``
    in float32, as the JAX step does, and the model rounds it once to its
    compute dtype at its input.  The score is taken on the pre-update
    forward (``steps.py:92-94`` of the JAX package)."""
    if remat:
        raise NotImplementedError(_NOT_PORTED["remat"])
    if grad_accum_steps != 1:
        raise NotImplementedError(_NOT_PORTED["grad_accum_steps"])
    if augment and not fused_augment:
        raise NotImplementedError(_NOT_PORTED["fused_augment"])
    check_supported(parity_mode, stain)

    def step(images, masks, valid, generator: torch.Generator):
        model.train()
        if augment:
            if tuple(images.shape[1:3]) != (img_size, img_size):
                raise ValueError(
                    f"the fused augmentation takes tiles at img_size "
                    f"{img_size}, got {tuple(images.shape[1:3])} (resize on "
                    "ingest is not ported for training)")
            facs, ints = draw_augment_scalars(images.shape[0], generator)
            tables = make_augment_tables(facs, ints).to(images.device)
            imgs, msks = fused_train_transform(images, masks, tables)
        else:
            imgs, msks = eval_transform(images, masks, img_size)
        out = model(imgs, generator)
        loss = objective.loss_fn(out, msks, valid)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            score = objective.score_fn(out, msks, valid)
        return loss.detach(), score

    return step


def make_eval_step(model: nn.Module, img_size: int, objective: Objective,
                   stain: str = "none"):
    """``step(images_u8, masks_u8, valid) → (loss, score)`` in eval mode,
    with wrap-padded samples masked out."""
    dtype = getattr(model, "compute_dtype", torch.float32)

    @torch.inference_mode()
    def step(images, masks, valid):
        model.eval()
        imgs, msks = eval_transform(images, masks, img_size, dtype, stain)
        out = model(imgs)
        return (objective.loss_fn(out, msks, valid),
                objective.score_fn(out, msks, valid))

    return step


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
    normalize, forward, sigmoid), mirroring the JAX ``make_infer_step``.
    The step puts the model in eval mode itself (the JAX step is always
    ``train=False``), so a model the trainer left in train mode is still
    normalized with its running statistics.

    On torchvision's 3×7×7 stem (the ResNet encoders) the normalize's scale
    is folded into the stem weight and only the mean shift is applied to
    the input; every other stem (MobileNetV2's, EfficientNet's), and every
    model under ``stain`` (``reinhard`` or ``macenko``, ``ops/stain.py``),
    gets ``eval_images`` in the compute dtype, as the JAX step does there.

    ``images_u8`` is a uint8 ``(N, H, W, 3)`` tensor on the model's device.
    Tiles of another size are resized to ``img_size`` (float32 bilinear,
    half-pixel centres).  Binary models return float32 ``(N, H, W)`` sigmoid
    probabilities; multi-class models ``(N, H, W, C)`` softmax ones.  A
    model with a bfloat16 head (``head_dtype``) gives bf16 logits, whose
    sigmoid is taken in float32 here (the JAX step takes it in bf16)."""
    check_method(stain)
    dtype = getattr(model, "compute_dtype", torch.float32)
    # the JAX rule: no stain, and torchvision's 3x7x7 encoder.conv1 only
    stem = dict(model.named_parameters()).get(STEM)
    fold = stain == "none" and stem is not None \
        and tuple(stem.shape[1:]) == (3, 7, 7)
    m255 = torch.as_tensor(
        (255.0 * np.asarray(IMAGENET_MEAN)).astype(np.float32))

    def folded_forward(images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        if tuple(x.shape[-2:]) != (img_size, img_size):
            x = resize_bilinear(x.float(), img_size, img_size)
        # mean-shifted 0..255 pixels, in the compute dtype; the 1/(255·std)
        # scale lives in the folded stem weight
        shift = m255.to(device=x.device, dtype=dtype).view(1, 3, 1, 1)
        x = x.to(dtype) - shift
        return functional_call(model, {STEM: fold_normalize_into_stem(stem)},
                               (x.contiguous(),))

    @torch.inference_mode()
    def step(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        out = (folded_forward(images) if fold
               else model(eval_images(images, img_size, dtype, stain)))
        if getattr(model, "num_classes", 1) > 1:
            return torch.softmax(out.float(), dim=1).permute(0, 2, 3, 1)
        return torch.sigmoid(out[:, 0].float())

    return step


def make_predict_step(model: nn.Module, img_size: int, objective: Objective,
                      stain: str = "none"):
    """``step(images_u8) → hard labels (N, S, S)`` in eval mode, from the
    objective's ``predict_fn`` (the JAX ``make_predict_step``)."""
    dtype = getattr(model, "compute_dtype", torch.float32)

    @torch.inference_mode()
    def step(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        return objective.predict_fn(
            model(eval_images(images, img_size, dtype, stain)))

    return step

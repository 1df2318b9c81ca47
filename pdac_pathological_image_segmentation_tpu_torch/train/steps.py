"""Step factories (the JAX package's ``train/steps.py``): the train step,
the eval step and the tile→mask inference step.

The train step is the reference's per-batch body (``train_worker.py:67-83``):
augmentation (the fused kernel, ``ops/fused_augment.py``, where it applies;
else the non-fused chain, ``ops/augment.py::train_transform``) → train-mode
forward (recomputed in the backward under ``remat``) → the objective →
backward (the GroupNorm backward kernel at every GN site) → Adam, over
``grad_accum_steps`` microbatches.  It returns the loss and the score as
tensors on the device and never waits for the card.

In a process group of N > 1 ranks, each rank's step takes
its rows of the global batch and computes what the JAX step computes on
the global array: the augmentation draws and the dropout masks are drawn
for the global batch and sliced, BatchNorm takes the global statistics
(``parallel/batchnorm.py``), the objective the global sums
(``make_objective(cfg, reduce=global_sum)``), and one ``all_reduce`` sums
the ranks' gradients before Adam.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from pdac_pathological_image_segmentation_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
    set_dropout_rows,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    draw_augment_scalars,
    eval_images,
    eval_transform,
    make_augment_tables,
    train_transform_drawn,
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
from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    Objective,
)

STEM = "encoder.conv1.weight"


def step_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The CPU generator of one train step, seeded from ``(seed, epoch,
    step)`` (the JAX package folds the epoch and the step into its key).
    The augmentation draws and the dropout masks come from it, on the host,
    so a step draws the same numbers on the card and on the CPU."""
    state = np.random.SeedSequence([seed, epoch, step]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def can_fuse_augment(image_shape, img_size: int, parity_mode: bool,
                     stain: str, dtype: torch.dtype) -> bool:
    """Whether the train step takes the fused augmentation (the JAX
    ``_can_fuse_augment``): a bfloat16 chain, square uint8 tiles at
    ``img_size`` with ``img_size % 8 == 0``, default mode, no stain.  On a
    CUDA tensor that is the kernel, on a CPU tensor its plain version."""
    if parity_mode or stain != "none" or dtype != torch.bfloat16:
        return False
    if tuple(image_shape[1:3]) != (img_size, img_size):
        return False
    return img_size % 8 == 0


def _frozen_batchnorm(model: nn.Module):
    """A context that puts ``model``'s BatchNorm buffers (running
    statistics, ``num_batches_tracked``) back as it found them: the
    recompute of a remat step runs in it, so the buffers move once per
    step, as the JAX package's (whose statistics are an output of the one
    forward).  The recompute itself runs BatchNorm as the forward did, so
    it saves the same tensors."""
    bufs = [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]

    @contextlib.contextmanager
    def frozen():
        kept = [b.clone() for b in bufs]
        try:
            yield
        finally:
            for b, k in zip(bufs, kept):
                b.copy_(k)

    return lambda: (contextlib.nullcontext(), frozen())


def remat_forward(model: nn.Module):
    """``forward(x, generator)``: ``model(x, generator)`` under
    ``torch.utils.checkpoint`` (non-reentrant), the JAX ``jax.checkpoint``
    of the forward.  The backward recomputes the activations with the
    first run's draws (a generator restored to the state the first run
    started from: checkpoint's own RNG stashing covers only the default
    generators), and puts the BatchNorm buffers back after it
    (:func:`_frozen_batchnorm`)."""
    context_fn = _frozen_batchnorm(model)

    def forward(x: torch.Tensor, generator: torch.Generator | None):
        start = None if generator is None else generator.get_state()
        runs = []

        def run(inp):
            g = generator
            if runs and generator is not None:  # the recompute
                g = torch.Generator(device=generator.device)
                g.set_state(start)
            runs.append(None)
            return model(inp, g)

        return checkpoint(run, x, use_reentrant=False,
                          context_fn=context_fn, preserve_rng_state=False)

    return forward


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    img_size: int, objective: Objective,
                    augment: bool = True, fused_augment: bool = True,
                    remat: bool = False, grad_accum_steps: int = 1,
                    parity_mode: bool = False, stain: str = "none",
                    debug_nans: bool = False):
    """``step(images_u8, masks_u8, valid, generator) → (loss, score)``.

    ``images_u8`` (N, H, W, 3) and ``masks_u8`` (N, H, W) uint8 and
    ``valid`` (N,) bool lie on the model's device; ``valid`` False marks
    the wrap-padded samples of a final partial batch, which pass through
    BatchNorm's batch statistics but not the loss or the score.  The
    augmentation is the fused kernel where :func:`can_fuse_augment` holds
    and ``fused_augment`` is on, else ``train_transform`` in the model's
    compute dtype (``parity_mode``, ``stain``, tiles not at ``img_size``, a
    float32 model); ``augment=False`` takes ``eval_transform`` in float32
    (with the stain), as the JAX step does, and the model rounds it once
    to its compute dtype at its input.

    ``remat`` recomputes the forward in the backward
    (:func:`remat_forward`).  ``grad_accum_steps = k`` splits the batch
    into k microbatches, each a forward and a backward in turn (BatchNorm's
    running statistics chain through them), sums their gradients, divides
    by k and takes one Adam update; the loss and the score are the means
    over the microbatches.  The score is taken on the pre-update forward
    (``steps.py:92-94`` of the JAX package).  ``debug_nans`` checks each
    microbatch's loss before its backward and the gradients before the
    update (the host waits for the card there), raising
    ``FloatingPointError`` that names the first non-finite tensor.

    In a process group of N > 1 ranks the step is data-parallel: its
    batch is this rank's rows of a global batch of N times its size (rank
    r holds rows ``[r·n, (r+1)·n)``); ``model``'s BatchNorm must be
    ``parallel.batchnorm.GlobalBatchNorm2d`` and ``objective`` one made
    with a global ``reduce``.  Microbatch i of ``grad_accum_steps`` is global rows
    ``[i·B/k, (i+1)·B/k)``, as in the JAX step, so a rank may hold none of
    its rows; it still runs the microbatch's forward and backward (and
    joins their collectives).  In one process, or a group of one rank, the
    step is the one-device step."""
    check_method(stain)
    k = int(grad_accum_steps)
    if k < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {k}")
    world, rank = mesh.world_size(), mesh.rank()
    if world > 1:
        if any(type(m) is nn.BatchNorm2d for m in model.modules()):
            raise ValueError("a data-parallel step needs the global "
                             "BatchNorm (parallel.batchnorm."
                             "convert_batchnorm)")
        if getattr(objective, "reduce", None) is None:
            raise ValueError("a data-parallel step needs an objective with "
                             "a global reduce (make_objective(cfg, "
                             "reduce=global_sum))")
    dtype = getattr(model, "compute_dtype", torch.float32)
    forward = remat_forward(model) if remat else model

    def augment_batch(images, masks, generator, rows=None):
        """The batch's augmentation; ``rows`` ``(start, stop, total)``
        draws for ``total`` rows and takes ``[start, stop)``."""
        if not augment:
            return eval_transform(images, masks, img_size, stain=stain)
        n = images.shape[0]
        start, stop, total = rows or (0, n, n)
        facs, ints = draw_augment_scalars(total, generator)
        facs, ints = facs[start:stop], ints[start:stop]
        if fused_augment and can_fuse_augment(images.shape, img_size,
                                              parity_mode, stain, dtype):
            tables = make_augment_tables(facs, ints).to(images.device)
            return fused_train_transform(images, masks, tables)
        return train_transform_drawn(images, masks, img_size, facs, ints,
                                     parity_mode=parity_mode, stain=stain,
                                     dtype=dtype)

    def micro(imgs, msks, valid, generator, rows=None):
        set_dropout_rows(model, rows)
        try:
            out = forward(imgs, generator)
            loss = objective.loss_fn(out, msks, valid)
            if debug_nans and not torch.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss {loss.detach().item()}")
            loss.backward()
        finally:
            set_dropout_rows(model, None)
        with torch.no_grad():
            score = objective.score_fn(out, msks, valid)
        return loss.detach(), score

    def check_gradients():
        bad = next((name for name, p in model.named_parameters()
                    if p.grad is not None
                    and not torch.isfinite(p.grad).all()), None)
        if bad is not None:
            raise FloatingPointError(f"non-finite gradient of {bad}")

    def step(images, masks, valid, generator: torch.Generator):
        # this rank's rows [r0, r0 + n) of a global batch of `total`
        n = images.shape[0]
        total, r0 = n * world, rank * n
        if total % k:
            raise ValueError(f"batch {total} does not divide into "
                             f"grad_accum_steps={k} microbatches")
        model.train()
        imgs, msks = augment_batch(images, masks, generator,
                                   (r0, r0 + n, total))
        if valid is None and (k > 1 or world > 1):
            valid = torch.ones(n, dtype=torch.bool, device=imgs.device)
        optimizer.zero_grad(set_to_none=True)
        m = total // k
        loss = score = 0.0
        for i in range(k):
            # the rank's rows of global rows [i·m, (i+1)·m), maybe none
            lo = max(i * m, r0)
            hi = max(min((i + 1) * m, r0 + n), lo)
            part = slice(lo - r0, hi - r0)
            li, si = micro(imgs[part], msks[part],
                           None if valid is None else valid[part], generator,
                           (lo - i * m, hi - i * m, m) if world > 1 else None)
            loss, score = loss + li, score + si
        if k > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
            loss, score = loss / k, score / k
        if world > 1:
            mesh.sum_gradients(model)
        if debug_nans:
            check_gradients()
        optimizer.step()
        return loss, score

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

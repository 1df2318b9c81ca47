"""Training objective: loss and score of (logits, masks, valid) (the JAX
package's ``train/objective.py``), for NCHW logits.

The reference's binary Dice, binary Dice + BCE (``loss: dice_ce``), and
the multi-class objectives of BASELINE.json configs #2 and #3
(``num_classes > 1``): softmax Dice (``loss: dice``) or Dice + CE with
``dice_weight``/``ce_weight`` and optional ``class_weights``, the score the
macro hard Dice of the argmax.  The class axis of the logits is dim 1.
``valid`` (N bool) masks wrap-padded samples of a final partial batch out
of every sum, after the sigmoid or the softmax.

``make_objective(cfg, reduce=parallel.mesh.global_sum)`` is the objective
of a data-parallel rank: every sum (Dice terms, the cross-entropy and the
valid count) is the global batch's, so the loss and the score are the
global ones on every rank, and each rank's gradient is its share of the
global gradient.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.ops.dice import (
    SMOOTH,
    dice_coefficient,
    softmax_dice_ce,
    weighted_dice_ce_loss,
)


class Objective(NamedTuple):
    loss_fn: Callable  # (logits NCHW, masks NHW, valid N | None) -> scalar
    score_fn: Callable  # (logits NCHW, masks NHW, valid N | None) -> scalar
    predict_fn: Callable  # (logits NCHW) -> hard labels NHW
    num_classes: int
    reduce: Optional[Callable] = None  # the global sum of a data-parallel run


def _vmask(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return x
    return x * valid.to(x.dtype).view(-1, *([1] * (x.dim() - 1)))


def binary_dice_loss(logits, masks, valid=None, reduce=None):
    probs = torch.sigmoid(logits[:, 0].float())
    return 1.0 - dice_coefficient(_vmask(probs, valid),
                                  _vmask(masks.float(), valid),
                                  reduce=reduce)


def binary_predict(logits):
    return (torch.sigmoid(logits[:, 0].float()) >= 0.5).float()


def binary_dice_score(logits, masks, valid=None, reduce=None):
    return dice_coefficient(_vmask(binary_predict(logits), valid),
                            _vmask(masks.float(), valid), reduce=reduce)


def multiclass_predict(logits):
    return torch.argmax(logits.float(), dim=1)


def multiclass_macro_dice(logits, masks, valid=None, reduce=None):
    """Macro-averaged hard Dice over classes of the argmax."""
    nc = logits.shape[1]
    pred = _vmask(F.one_hot(multiclass_predict(logits), nc).float(), valid)
    mask = _vmask(F.one_hot(masks.long(), nc).float(), valid)
    inter = (pred * mask).sum(dim=(0, 1, 2))
    denom = pred.sum(dim=(0, 1, 2)) + mask.sum(dim=(0, 1, 2))
    if reduce is not None:
        inter, denom = reduce(torch.cat([inter, denom])).split(nc)
    return ((2.0 * inter + SMOOTH) / (denom + SMOOTH)).mean()


def _global_count(count: torch.Tensor, reduce) -> torch.Tensor:
    """A count (no gradient) summed over ranks under ``reduce``."""
    return count if reduce is None else reduce(count.reshape(1))[0]


def _multiclass_objective(nc: int, loss_name: str, dice_w: float,
                          ce_w: float, class_weights,
                          reduce=None) -> Objective:
    d_w, c_w = (1.0, 0.0) if loss_name == "dice" else (dice_w, ce_w)

    def loss_fn(logits, masks, valid=None):
        cw = (None if class_weights is None
              else class_weights.to(logits.device))
        if valid is None:
            return weighted_dice_ce_loss(logits, masks, d_w, c_w, cw,
                                         reduce=reduce)
        # masked after the softmax (a padded sample's masked logits would
        # give it a uniform softmax); the CE averaged over the valid
        # samples' pixels
        dice, per_px = softmax_dice_ce(logits, masks, cw, valid,
                                       reduce=reduce)
        pixels = masks.shape[1] * masks.shape[2]
        n_valid_px = _global_count(valid.float().sum(), reduce).clamp_min(
            1.0) * pixels
        ce_sum = per_px.sum()
        if reduce is not None:
            ce_sum = reduce(ce_sum.reshape(1))[0]
        return d_w * (1.0 - dice) + c_w * (ce_sum / n_valid_px)

    return Objective(loss_fn,
                     functools.partial(multiclass_macro_dice, reduce=reduce),
                     multiclass_predict, nc, reduce)


def make_objective(cfg: Config, reduce: Optional[Callable] = None
                   ) -> Objective:
    loss_name = str(cfg.extras.get("loss", "dice")).lower()
    dice_w = float(cfg.extras.get("dice_weight", 0.5))
    ce_w = float(cfg.extras.get("ce_weight", 0.5))
    if cfg.num_classes != 1:
        cw = cfg.extras.get("class_weights")
        return _multiclass_objective(
            cfg.num_classes, loss_name, dice_w, ce_w,
            None if cw is None else torch.tensor(cw, dtype=torch.float32),
            reduce)
    score_fn = functools.partial(binary_dice_score, reduce=reduce)
    if loss_name == "dice":
        return Objective(functools.partial(binary_dice_loss, reduce=reduce),
                         score_fn, binary_predict, 1, reduce)
    if loss_name not in ("dice_ce", "dice+ce"):
        raise ValueError(f"unknown loss {loss_name!r}")

    def dice_ce_loss(logits, masks, valid=None):
        """Dice on masked probabilities plus BCE averaged over the valid
        samples' pixels."""
        logits1 = logits[:, 0].float()
        per_px = F.binary_cross_entropy_with_logits(logits1, masks.float(),
                                                    reduction="none")
        pixels = per_px.shape[1] * per_px.shape[2]
        bce_sum = _vmask(per_px, valid).sum()
        if reduce is None:
            n_valid = (float(logits1.shape[0]) if valid is None
                       else valid.float().sum().clamp_min(1.0))
        else:
            n_valid = (valid.float().sum() if valid is not None
                       else per_px.new_tensor(float(logits1.shape[0])))
            bce_sum, n_valid = reduce(torch.stack([bce_sum,
                                                   n_valid])).unbind()
            n_valid = n_valid.clamp_min(1.0)
        bce = bce_sum / (n_valid * pixels)
        return (dice_w * binary_dice_loss(logits, masks, valid, reduce)
                + ce_w * bce)

    return Objective(dice_ce_loss, score_fn, binary_predict, 1, reduce)

"""Training objective: loss and score of (logits, masks, valid) (the JAX
package's ``train/objective.py``), for NCHW logits.

The reference's binary Dice, binary Dice + BCE (``loss: dice_ce``), and
the multi-class objectives of BASELINE.json configs #2 and #3
(``num_classes > 1``): softmax Dice (``loss: dice``) or Dice + CE with
``dice_weight``/``ce_weight`` and optional ``class_weights``, the score the
macro hard Dice of the argmax.  The class axis of the logits is dim 1.
``valid`` (N bool) masks wrap-padded samples of a final partial batch out
of every sum, after the sigmoid or the softmax.
"""

from __future__ import annotations

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


def _vmask(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return x
    return x * valid.to(x.dtype).view(-1, *([1] * (x.dim() - 1)))


def binary_dice_loss(logits, masks, valid=None):
    probs = torch.sigmoid(logits[:, 0].float())
    return 1.0 - dice_coefficient(_vmask(probs, valid),
                                  _vmask(masks.float(), valid))


def binary_predict(logits):
    return (torch.sigmoid(logits[:, 0].float()) >= 0.5).float()


def binary_dice_score(logits, masks, valid=None):
    return dice_coefficient(_vmask(binary_predict(logits), valid),
                            _vmask(masks.float(), valid))


def multiclass_predict(logits):
    return torch.argmax(logits.float(), dim=1)


def multiclass_macro_dice(logits, masks, valid=None):
    """Macro-averaged hard Dice over classes of the argmax."""
    nc = logits.shape[1]
    pred = _vmask(F.one_hot(multiclass_predict(logits), nc).float(), valid)
    mask = _vmask(F.one_hot(masks.long(), nc).float(), valid)
    inter = (pred * mask).sum(dim=(0, 1, 2))
    denom = pred.sum(dim=(0, 1, 2)) + mask.sum(dim=(0, 1, 2))
    return ((2.0 * inter + SMOOTH) / (denom + SMOOTH)).mean()


def _multiclass_objective(nc: int, loss_name: str, dice_w: float,
                          ce_w: float, class_weights) -> Objective:
    d_w, c_w = (1.0, 0.0) if loss_name == "dice" else (dice_w, ce_w)

    def loss_fn(logits, masks, valid=None):
        cw = (None if class_weights is None
              else class_weights.to(logits.device))
        if valid is None:
            return weighted_dice_ce_loss(logits, masks, d_w, c_w, cw)
        # masked after the softmax (a padded sample's masked logits would
        # give it a uniform softmax); the CE averaged over the valid
        # samples' pixels
        dice, per_px = softmax_dice_ce(logits, masks, cw, valid)
        n_valid_px = valid.float().sum().clamp_min(1.0) * masks[0].numel()
        return d_w * (1.0 - dice) + c_w * (per_px.sum() / n_valid_px)

    return Objective(loss_fn, multiclass_macro_dice, multiclass_predict, nc)


def make_objective(cfg: Config) -> Objective:
    loss_name = str(cfg.extras.get("loss", "dice")).lower()
    dice_w = float(cfg.extras.get("dice_weight", 0.5))
    ce_w = float(cfg.extras.get("ce_weight", 0.5))
    if cfg.num_classes != 1:
        cw = cfg.extras.get("class_weights")
        return _multiclass_objective(
            cfg.num_classes, loss_name, dice_w, ce_w,
            None if cw is None else torch.tensor(cw, dtype=torch.float32))
    if loss_name == "dice":
        return Objective(binary_dice_loss, binary_dice_score, binary_predict,
                         1)
    if loss_name not in ("dice_ce", "dice+ce"):
        raise ValueError(f"unknown loss {loss_name!r}")

    def dice_ce_loss(logits, masks, valid=None):
        """Dice on masked probabilities plus BCE averaged over the valid
        samples' pixels."""
        logits1 = logits[:, 0].float()
        per_px = F.binary_cross_entropy_with_logits(logits1, masks.float(),
                                                    reduction="none")
        n_valid = (float(logits1.shape[0]) if valid is None
                   else valid.float().sum().clamp_min(1.0))
        bce = _vmask(per_px, valid).sum() / (n_valid * per_px[0].numel())
        return dice_w * binary_dice_loss(logits, masks, valid) + ce_w * bce

    return Objective(dice_ce_loss, binary_dice_score, binary_predict, 1)

"""Training objective: loss and score of (logits, masks, valid) (the JAX
package's ``train/objective.py``), for NCHW logits.

The reference's binary Dice is ported, and binary Dice + BCE
(``loss: dice_ce``).  ``valid`` (N bool) masks wrap-padded samples of a
final partial batch out of every sum, after the sigmoid.  Multi-class
objectives raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.ops.dice import (
    dice_coefficient,
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


def make_objective(cfg: Config) -> Objective:
    if cfg.num_classes != 1:
        raise NotImplementedError(
            f"num_classes={cfg.num_classes}: multi-class objectives are not "
            "ported yet (ROADMAP.md Queue 1, item 4)")
    loss_name = str(cfg.extras.get("loss", "dice")).lower()
    if loss_name == "dice":
        return Objective(binary_dice_loss, binary_dice_score, binary_predict,
                         1)
    if loss_name not in ("dice_ce", "dice+ce"):
        raise ValueError(f"unknown loss {loss_name!r}")
    dice_w = float(cfg.extras.get("dice_weight", 0.5))
    ce_w = float(cfg.extras.get("ce_weight", 0.5))

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

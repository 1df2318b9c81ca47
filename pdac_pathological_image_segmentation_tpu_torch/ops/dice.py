"""The Dice coefficient and the weighted Dice + cross-entropy loss (the
JAX package's ``ops/dice.py``).

The reference's ``util.py:6-26``: the whole batch flattened into one vector
(global Dice, not a per-sample mean), ``smooth = 1e-6``, sums in float32
whatever the input dtype.  On sigmoid probabilities it is the soft Dice of
the loss (``1 - dice``); on thresholded predictions the hard Dice of the
score.  :func:`weighted_dice_ce_loss` is the multi-class loss of
BASELINE.json configs #2 and #3.

``reduce`` (``parallel.mesh.global_sum`` in a data-parallel run) maps a
vector of this rank's sums to the global batch's: every ratio is then
taken of global sums, as the JAX step takes it of the global array.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

SMOOTH = 1e-6


def dice_coefficient(pred: torch.Tensor, target: torch.Tensor,
                     smooth: float = SMOOTH,
                     reduce: Optional[Callable] = None) -> torch.Tensor:
    """``(2·Σ pred·target + smooth) / (Σ pred + Σ target + smooth)``."""
    pred = pred.float().reshape(-1)
    target = target.float().reshape(-1)
    inter, p_sum, t_sum = (pred * target).sum(), pred.sum(), target.sum()
    if reduce is not None:
        inter, p_sum, t_sum = reduce(torch.stack([inter, p_sum,
                                                  t_sum])).unbind()
    return (2.0 * inter + smooth) / (p_sum + t_sum + smooth)


def softmax_dice_ce(logits: torch.Tensor, targets: torch.Tensor,
                    class_weights: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None,
                    smooth: float = SMOOTH,
                    reduce: Optional[Callable] = None):
    """``(dice, per-pixel CE)`` of NCHW multi-class logits against (N, H, W)
    integer labels: the soft Dice per class over the whole batch, then
    their mean (or their ``class_weights``-weighted mean, the weights
    normalized to sum 1), and each pixel's softmax cross-entropy (weighted
    by its target's class weight).  ``valid`` (N bool) zeroes the padded
    samples' probabilities and targets after the softmax.  ``logits`` are
    taken in float32."""
    nc = logits.shape[1]
    x = logits.float().permute(0, 2, 3, 1)
    t = F.one_hot(targets.long(), nc).float()
    p = torch.softmax(x, dim=-1)
    log_p = torch.log_softmax(x, dim=-1).reshape(-1, nc)
    if valid is not None:
        v = valid.float().view(-1, 1, 1, 1)
        p, t = p * v, t * v
    p, t = p.reshape(-1, nc), t.reshape(-1, nc)
    inter = (p * t).sum(dim=0)
    denom = p.sum(dim=0) + t.sum(dim=0)
    if reduce is not None:
        inter, denom = reduce(torch.cat([inter, denom])).split(nc)
    dice_per_class = (2.0 * inter + smooth) / (denom + smooth)
    if class_weights is None:
        return dice_per_class.mean(), -(t * log_p).sum(dim=-1)
    w = class_weights / class_weights.sum()
    return (dice_per_class * w).sum(), -(t * log_p * w).sum(dim=-1)


def weighted_dice_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                          dice_weight: float = 0.5, ce_weight: float = 0.5,
                          class_weights: Optional[torch.Tensor] = None,
                          smooth: float = SMOOTH,
                          reduce: Optional[Callable] = None) -> torch.Tensor:
    """Weighted Dice + cross-entropy of NCHW multi-class logits and
    (N, H, W) integer labels (the JAX ``weighted_dice_ce_loss``'s
    multi-class branch): ``dice_weight·(1 − dice) + ce_weight·mean CE``."""
    dice, per_px = softmax_dice_ce(logits, targets, class_weights,
                                   smooth=smooth, reduce=reduce)
    if reduce is None:
        ce = per_px.mean()
    else:
        ce_sum, count = reduce(torch.stack([
            per_px.sum(), per_px.new_tensor(float(per_px.numel()))])).unbind()
        ce = ce_sum / count
    return dice_weight * (1.0 - dice) + ce_weight * ce

"""The Dice coefficient (the JAX package's ``ops/dice.py``).

The reference's ``util.py:6-26``: the whole batch flattened into one vector
(global Dice, not a per-sample mean), ``smooth = 1e-6``, sums in float32
whatever the input dtype.  On sigmoid probabilities it is the soft Dice of
the loss (``1 - dice``); on thresholded predictions the hard Dice of the
score.
"""

from __future__ import annotations

import torch

SMOOTH = 1e-6


def dice_coefficient(pred: torch.Tensor, target: torch.Tensor,
                     smooth: float = SMOOTH) -> torch.Tensor:
    """``(2·Σ pred·target + smooth) / (Σ pred + Σ target + smooth)``."""
    pred = pred.float().reshape(-1)
    target = target.float().reshape(-1)
    inter = (pred * target).sum()
    return (2.0 * inter + smooth) / (pred.sum() + target.sum() + smooth)

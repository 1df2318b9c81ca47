"""Per-sample segmentation metrics from confusion counts (the JAX package's
``ops/metrics.py``), on tensors.

The reference reports one number, the mean hard Dice over the test set
(``test.py:145-150,182``).  The evaluation also gives, per patch, IoU,
precision, recall, specificity and pixel accuracy, all from one pass of
confusion counts on the device:

* :func:`per_sample_confusion`: (N, C, 4) ``[tp, fp, fn, tn]`` per sample
  and class, from hard predictions;
* :func:`prob_histograms`: class-split probability histograms, from which
  :func:`threshold_sweep` derives the metrics at every threshold
  ``k / SWEEP_BINS`` on the host;
* :func:`derive_metrics`: the metric family from counts, with the
  reference's Dice smoothing (``SMOOTH``), so empty pairs give 1.0.

Binary models (``num_classes == 1``) report the tumor class (``> 0``);
multi-class ones one-vs-rest per class.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch.ops.dice import SMOOTH

METRIC_NAMES = ("dice", "iou", "precision", "recall", "specificity",
                "accuracy")

#: thresholds ``k / SWEEP_BINS`` for ``k = 0..SWEEP_BINS``; the histograms
#: carry ``SWEEP_BINS + 1`` buckets so that ``prob == 1.0`` has its own
SWEEP_BINS = 256


def per_sample_confusion(preds: torch.Tensor, masks: torch.Tensor,
                         valid: Optional[torch.Tensor] = None,
                         num_classes: int = 1) -> torch.Tensor:
    """float32 (N, C, 4) ``[tp, fp, fn, tn]`` of (N, H, W) hard labels;
    C = 1 for binary (class = ``> 0``), else one-vs-rest over
    ``num_classes``.  Padded samples (``valid`` False) count zero."""
    if num_classes <= 1:
        p = (preds > 0)[..., None]
        m = (masks > 0)[..., None]
    else:
        cls = torch.arange(num_classes, device=preds.device)
        p = preds.long()[..., None] == cls
        m = masks.long()[..., None] == cls
    f32 = torch.float32
    counts = torch.stack([(p & m).to(f32).sum(dim=(1, 2)),
                          (p & ~m).to(f32).sum(dim=(1, 2)),
                          (~p & m).to(f32).sum(dim=(1, 2)),
                          (~p & ~m).to(f32).sum(dim=(1, 2))], dim=-1)
    if valid is not None:
        counts = counts * valid.to(f32)[:, None, None]
    return counts


def prob_histograms(probs: torch.Tensor, masks: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    bins: int = SWEEP_BINS) -> torch.Tensor:
    """int64 ``(2, bins + 1)`` histograms of (N, H, W) tumor probabilities:
    row 0 counts pixels whose ground truth is negative, row 1 positive,
    in bucket ``min(floor(prob * bins), bins)``.  ``prob == 1.0`` (a
    float32 sigmoid saturates for logits above about 16.6) owns bucket
    ``bins``, so ``prob >= k/bins ⇔ bucket >= k`` for every ``k``.  Counts
    are integers, exact where float32 would lose them past 2^24; the
    pixels of padded samples go to a spare bucket that is dropped."""
    idx = (probs.float() * bins).long().clamp(0, bins)
    flat = (masks > 0).long() * (bins + 1) + idx
    if valid is not None:
        flat = torch.where(valid.view(-1, 1, 1), flat, 2 * (bins + 1))
    hist = torch.bincount(flat.reshape(-1), minlength=2 * (bins + 1) + 1)
    return hist[: 2 * (bins + 1)].view(2, bins + 1)


def threshold_sweep(hists, smooth: float = SMOOTH) -> Dict[str, np.ndarray]:
    """The metric family at every threshold ``k / bins`` (predicted positive
    iff ``prob >= threshold``), from ``(2, bins + 1)`` histogram totals, on
    the host: numpy arrays of shape ``(bins + 1,)``, ``"threshold"`` and
    every :data:`METRIC_NAMES` entry."""
    hists = np.asarray(hists, np.float64)
    neg, pos = hists[0], hists[1]
    bins = neg.shape[0] - 1
    # suffix sums: positive at threshold k/bins ⇔ bucket >= k
    tp = np.cumsum(pos[::-1])[::-1]
    fp = np.cumsum(neg[::-1])[::-1]
    counts = np.stack([tp, fp, pos.sum() - tp, neg.sum() - fp], axis=-1)
    out = {k: np.asarray(v) for k, v in derive_metrics(counts, smooth).items()}
    out["threshold"] = np.arange(bins + 1, dtype=np.float64) / bins
    return out


def derive_metrics(counts, smooth: float = SMOOTH) -> dict:
    """The metric family from ``[..., 4] = [tp, fp, fn, tn]`` counts, a
    tensor or a numpy array: per sample (N, C, 4) or pooled (C, 4)."""
    tp, fp, fn, tn = (counts[..., i] for i in range(4))
    return {
        "dice": (2 * tp + smooth) / (2 * tp + fp + fn + smooth),
        "iou": (tp + smooth) / (tp + fp + fn + smooth),
        "precision": (tp + smooth) / (tp + fp + smooth),
        "recall": (tp + smooth) / (tp + fn + smooth),
        "specificity": (tn + smooth) / (tn + fp + smooth),
        "accuracy": (tp + tn + smooth) / (tp + fp + fn + tn + smooth),
    }

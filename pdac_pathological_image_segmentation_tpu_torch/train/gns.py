"""Gradient-noise-scale (GNS) measurement for data-parallel training (the
JAX package's ``train/gns.py``).

McCandlish et al., "An Empirical Model of Large-Batch Training" (2018):
``B_simple = tr(Σ) / |G|²``, from two gradient norms that data-parallel
training has at hand:

* ``|g_small|²``, the mean over ranks of each rank's gradient's squared
  norm (batch ``b = B / N``);
* ``|g_big|²``, the squared norm of the rank-mean gradient (batch ``B``).

Solving the pair (ibid., appendix A.1):

    S_est  = (|g_small|² − |g_big|²) / (1/b − 1/B)          (≈ tr(Σ))
    G2_est = (B·|g_big|² − b·|g_small|²) / (B − b)          (≈ |G|²)
    B_simple = S_est / G2_est

Each rank computes its gradient, reduces it to one squared norm, and two
``all_reduce`` s (the norms and the gradient) give both sides; with one
rank the estimates are NaN (``b == B``).  The trainer measures it on a
sampled cadence (``gns_every: N``), and :class:`GnsEma` smooths S and G²
separately (ibid. §A.2).  As in the JAX package, the Dice loss is a
batch-global ratio, so the per-rank gradients are batch-b Dice gradients:
a consistent scaling diagnostic rather than tr(Σ)/|G|² of per-sample
losses.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh


class GnsStats(NamedTuple):
    """One measurement's pair of gradient norms and their estimates
    (float32 scalar tensors)."""
    g_small_sq: torch.Tensor  # E_rank |g_rank|²  (batch-b gradients)
    g_big_sq: torch.Tensor  # |g_global|²  (batch-B gradient)
    s_est: torch.Tensor  # ≈ tr(Σ)
    g2_est: torch.Tensor  # ≈ |G|²
    b_simple: torch.Tensor  # S / G², the gradient noise scale


def _sq_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum((g.float() * g.float()).sum() for g in grads)


def _grad_list(grads) -> list:
    if isinstance(grads, dict):
        return [grads[k] for k in sorted(grads)]
    return list(grads)


def make_gns_stats(grad_fn: Callable, batch_size: int,
                   n_repl_args: int = 0):
    """``stats(*args) → GnsStats``.

    ``grad_fn(*args)`` returns this rank's gradients (a sequence or a dict
    of tensors) on its rows alone, with no reduction over ranks: the
    wrapper owns the reductions.  The first ``n_repl_args`` arguments are
    the same on every rank; the rest lead with this rank's
    ``batch_size / N`` rows (checked).  ``batch_size`` is the global
    batch and must divide by the ranks."""
    n_dev = mesh.world_size()
    if batch_size % n_dev:
        raise ValueError(
            f"batch {batch_size} must be divisible by {n_dev} devices")
    b_small, b_big = batch_size // n_dev, batch_size

    def stats(*args) -> GnsStats:
        for a in args[n_repl_args:]:
            if a.shape[0] != b_small:
                raise ValueError(f"a batch argument has {a.shape[0]} rows; "
                                 f"this rank's share is {b_small}")
        grads = [g.float() for g in _grad_list(grad_fn(*args))]
        local_sq = _sq_norm(grads).reshape(1)
        if n_dev == 1:
            # degenerate: b == B, the pair carries no noise split
            nan = torch.tensor(float("nan"), device=local_sq.device)
            return GnsStats(local_sq[0], local_sq[0], nan, nan.clone(),
                            nan.clone())
        flat = torch.cat([local_sq] + [g.reshape(-1) for g in grads])
        mesh.all_reduce(flat)
        flat = flat / n_dev
        g_small_sq, g_big_sq = flat[0], (flat[1:] * flat[1:]).sum()
        s_est = (g_small_sq - g_big_sq) / (1.0 / b_small - 1.0 / b_big)
        g2_est = (b_big * g_big_sq - b_small * g_small_sq) / (b_big - b_small)
        b_simple = s_est / torch.clamp_min(g2_est, 1e-30)
        return GnsStats(g_small_sq, g_big_sq, s_est, g2_est, b_simple)

    return stats


class GnsEma:
    """EMA smoothing of the (noisy) per-measurement estimates; tracks S and
    G² separately and reports their ratio (McCandlish §A.2)."""

    def __init__(self, alpha: float = 0.9) -> None:
        self.alpha = alpha
        self.s = None
        self.g2 = None

    def update(self, stats: GnsStats) -> float:
        s, g2 = float(stats.s_est), float(stats.g2_est)
        if not (s == s and g2 == g2):  # NaN guard (one rank)
            return float("nan")
        self.s = s if self.s is None else self.alpha * self.s + (1 - self.alpha) * s
        self.g2 = g2 if self.g2 is None else self.alpha * self.g2 + (1 - self.alpha) * g2
        if self.g2 <= 0:
            return float("nan")
        return self.s / max(self.g2, 1e-30)

    def state_dict(self) -> dict:
        return {"alpha": self.alpha, "s": self.s, "g2": self.g2}

    def load_state_dict(self, d: dict) -> None:
        self.alpha = d["alpha"]
        self.s = d["s"]
        self.g2 = d["g2"]

"""BatchNorm over the global batch of a data-parallel run.

The JAX step normalizes with the statistics of the global batch: flax's
``BatchNorm`` under ``jit`` reduces over the logical array, so XLA sums
across devices.  Per-rank statistics (plain DDP) would be another model.
``torch.nn.SyncBatchNorm`` refuses CPU tensors, so the port has its own:

* forward: one ``all_reduce`` of the per-channel sum, sum of squares and
  count (accumulated in float32, or float64 for a float64 input); the
  biased variance normalizes, the unbiased one (with the global count)
  goes into ``running_var``, as ``nn.BatchNorm2d`` does on one device;
* backward: one ``all_reduce`` of Σdy and Σdy·x̂, the input gradient from
  the global sums, and the parameter gradients of this rank's rows only
  (the step sums parameter gradients over ranks).

A rank with no rows (a micro-batch of ``grad_accum_steps`` that lies on
other ranks) adds zeros and still joins both collectives.  Eval mode is
``nn.BatchNorm2d``'s.  :func:`convert_batchnorm` swaps a model's
``nn.BatchNorm2d`` modules for :class:`GlobalBatchNorm2d`; the trainer does
so only when the world is larger than one rank.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.parallel.mesh import (
    all_reduce,
)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


class GlobalBatchNormFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        acc = _acc_dtype(x)
        c = x.shape[1]
        xf = x.to(acc)
        stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           torch.full((1,), float(x.numel() // c), dtype=acc,
                                      device=x.device)])
        all_reduce(stats)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        with torch.no_grad():
            unbiased = var * (n / (n - 1).clamp_min(1.0))
            running_mean.mul_(1 - momentum).add_(
                momentum * mean.to(running_mean.dtype))
            running_var.mul_(1 - momentum).add_(
                momentum * unbiased.to(running_var.dtype))
        xhat = (xf - mean.view(1, c, 1, 1)) * invstd.view(1, c, 1, 1)
        y = xhat * weight.to(acc).view(1, c, 1, 1) \
            + bias.to(acc).view(1, c, 1, 1)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        acc = _acc_dtype(x)
        c = x.shape[1]
        xhat = (x.to(acc) - mean.view(1, c, 1, 1)) * invstd.view(1, c, 1, 1)
        dyf = dy.to(acc)
        local = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        sums = all_reduce(local.clone())
        sum_dy, sum_dy_xhat = sums[:c] / n, sums[c:] / n
        scale = (weight.to(acc) * invstd).view(1, c, 1, 1)
        dx = scale * (dyf - sum_dy.view(1, c, 1, 1)
                      - xhat * sum_dy_xhat.view(1, c, 1, 1))
        return (dx.to(x.dtype), local[c:].to(weight.dtype),
                local[:c].to(weight.dtype), None, None, None, None)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and ``state_dict``
    names) whose train-mode statistics are those of the global batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return GlobalBatchNormFunction.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.momentum, self.eps)


def convert_batchnorm(model: nn.Module) -> nn.Module:
    """Turn every ``nn.BatchNorm2d`` of ``model`` into a
    :class:`GlobalBatchNorm2d`, in place: the modules keep their parameters
    and buffers (the optimizer's references stay valid)."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            if not (m.affine and m.track_running_stats) \
                    or m.momentum is None:
                raise ValueError("GlobalBatchNorm2d needs an affine "
                                 "BatchNorm with running statistics and a "
                                 "momentum")
            m.__class__ = GlobalBatchNorm2d
    return model

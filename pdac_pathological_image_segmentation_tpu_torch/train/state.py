"""The optimizer of a training run (the JAX package's ``train/state.py``).

Adam with torch's defaults, as the reference builds it
(``train_worker.py:184``; the JAX package's ``make_optimizer``).  It is
built over ``model.parameters()``, whose order is the ``state_dict``'s
order without the BatchNorm buffers: a reference ``optimizer.state_dict()``
indexes its moments by that position, and the JAX package's converter
reads them so (``utils/torch_weights.py::_convert_optimizer_state``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def parameter_names(model: nn.Module) -> list:
    """The ``state_dict`` names of ``model``'s parameters, in the order
    the optimizer indexes them."""
    return [k for k in model.state_dict() if not k.endswith(BN_BUFFERS)]


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """``Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` over ``model``'s
    parameters in ``state_dict`` order (checked)."""
    named = dict(model.named_parameters())
    names = parameter_names(model)
    if names != list(named):
        raise ValueError("model.parameters() is not in state_dict order")
    return torch.optim.Adam([named[k] for k in names], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's learning rate (the plateau step)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)

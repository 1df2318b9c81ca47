"""Dropout whose masks come from the train step's generator, never from the
global RNG (flax ``nn.Dropout`` draws from the step's ``dropout`` key).

* :class:`Dropout2d` (FPN, PSPNet) drops whole (n, c) planes.  Its mask is
  ``N·C`` numbers: it is drawn on the generator's device (the host, for the
  train step's CPU generator) and copied to the activation's, so a step
  draws the same mask on the card and on the CPU.
* :class:`Dropout` (DeepLabV3+'s ASPP) drops single elements.  Its mask is
  the size of the activation, (128, 256, 32, 32) at the config's batch,
  which the host would take hundreds of milliseconds to draw: it is drawn
  on the activation's device by a ``torch.Generator`` there, seeded with
  one 64-bit number drawn from the step's generator.  The mask repeats for
  equal generator states on one device; the card's and the CPU's streams
  differ for the same seed.

In a data-parallel step each rank holds some rows of the global batch:
:func:`set_dropout_rows` gives every dropout module of a model the rows'
``(start, stop, total)``, and the mask is drawn for all ``total`` rows
(the same draws on every rank) and sliced, so N ranks drop what one
device would.  ``rows=None`` (the default) draws for the rows present.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch import host_to_device


def _check_rate(p: float) -> float:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p must be in [0, 1), got {p}")
    return p


def _global_rows(module, n: int) -> tuple:
    """``(start, stop, total)`` of the module's rows in the global batch."""
    rows = getattr(module, "rows", None)
    if rows is None:
        return 0, n, n
    start, stop, total = rows
    if stop - start != n:
        raise ValueError(f"dropout rows {rows} do not match a batch of {n}")
    return rows


def set_dropout_rows(model: nn.Module, rows) -> None:
    """Give every dropout module of ``model`` its rows ``(start, stop,
    total)`` in the global batch (None: the rows present)."""
    for m in model.modules():
        if isinstance(m, (Dropout, Dropout2d)):
            m.rows = rows


def _need_generator(generator, what: str) -> None:
    if generator is None:
        raise ValueError(f"{what} in train mode needs an explicit "
                         "torch.Generator")


class Dropout2d(nn.Module):
    """Whole-channel dropout (flax ``nn.Dropout(broadcast_dims=(1, 2))``,
    torch ``nn.Dropout2d``): in train mode each (n, c) plane is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``.  The mask is drawn
    on ``generator``'s device from that generator alone."""

    def __init__(self, p: float = 0.2) -> None:
        super().__init__()
        self.p = _check_rate(p)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        _need_generator(generator, "Dropout2d")
        n, c = x.shape[:2]
        start, stop, total = _global_rows(self, n)
        keep = torch.rand((total, c, 1, 1), generator=generator,
                          device=generator.device)[start:stop] >= self.p
        keep = host_to_device(keep, x.device)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class Dropout(nn.Module):
    """Elementwise dropout (flax ``nn.Dropout(rate)``, torch ``nn.Dropout``):
    in train mode each element is kept with probability ``1 - p`` and scaled
    by ``1 / (1 - p)``.  The mask is drawn on ``x``'s device by a generator
    there, seeded from ``generator`` (one 64-bit draw)."""

    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = _check_rate(p)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        _need_generator(generator, "Dropout")
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=generator,
                                 device=generator.device))
        local = torch.Generator(device=x.device).manual_seed(seed)
        start, stop, total = _global_rows(self, x.shape[0])
        keep = torch.rand((total, *x.shape[1:]), generator=local,
                          device=x.device)[start:stop] >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

"""Model FLOPs of a configuration, counted from its shapes.

``torch.utils.flop_counter.FlopCounterMode`` over the plain reference model
(``reference/models.py``) on the ``meta`` device, at one tile: it counts
the convolutions and matrix products (2 FLOPs a multiply-add), nothing
else, and takes no time.  The backward counts what autograd computes:
both gradients of every convolution but the stem's input gradient.
Counts scale exactly with the batch.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models


@functools.lru_cache(maxsize=None)
def _counts(cfg_json: str, tile: int) -> tuple:
    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        model = models.build(cfg)
        x = torch.empty(1, 3, tile, tile)
    model.eval()
    with FlopCounterMode(display=False) as fwd:
        out = model(x)
    with FlopCounterMode(display=False) as total:
        model(x).sum().backward()
    del out
    return fwd.get_total_flops(), total.get_total_flops()


def forward_flops(cfg: dict, tile: int) -> int:
    """FLOPs of one tile's forward."""
    return _counts(json.dumps(cfg, sort_keys=True), tile)[0]


def train_flops(cfg: dict, tile: int) -> int:
    """FLOPs of one tile's forward and backward."""
    return _counts(json.dumps(cfg, sort_keys=True), tile)[1]


@functools.lru_cache(maxsize=None)
def _sites(cfg_json: str, tile: int) -> tuple:
    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        model = models.build(cfg)
        x = torch.empty(1, 3, tile, tile)
    seen = []

    def hook(module, inputs, output):
        seen.append((module.site, tuple(inputs[0].shape),
                     tuple(module.weight.shape), tuple(output.shape)))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, models.QConv)]
    model.eval()
    model(x)
    for h in handles:
        h.remove()
    return tuple(seen)


def conv_sites(cfg: dict, tile: int) -> tuple:
    """``(site, input shape, weight shape, output shape)`` of each
    convolution of one tile's forward (not the transposed ones), in the
    order they run."""
    return _sites(json.dumps(cfg, sort_keys=True), tile)

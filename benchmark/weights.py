"""Seeded weights for a configuration, made on the device in two calls.

The names and shapes are those of the plain reference model
(``reference/models.py``), which are the published ``state_dict``'s; the
program under test loads the same dict (``load_state_dict`` checks every
name).  Convolutions are He-normal, N(0, 2/fan_in), but the head (the
last convolution) at half that scale, N(0, 1/(2·fan_in)), so that the
logits stay near 0 and few pixels saturate: a saturated probability
holds too little of its logit for the check to compare.  Norm scales and
BatchNorm running variances U(0.5, 1.5); biases and running means
N(0, 0.1²).
"""

from __future__ import annotations

import torch


def seeded_state_dict(model: torch.nn.Module, seed: int, device) -> dict:
    """``{name: tensor on device}`` for ``model``'s ``state_dict``, drawn
    from ``torch.Generator(device).manual_seed(seed)``."""
    items = list(model.state_dict().items())
    floats = [(k, t.shape) for k, t in items if t.is_floating_point()]
    total = sum(s.numel() for _, s in floats)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    head = [k for k, t in items if t.dim() == 4][-1]
    out, at = {}, 0
    for name, t in items:
        if not t.is_floating_point():
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
            continue
        n = t.numel()
        z, u = normal[at:at + n].view(t.shape), uniform[at:at + n].view(t.shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if t.dim() == 4:
            fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            out[name] = z * (2.0 / fan_in) ** 0.5 * (0.5 if name == head
                                                     else 1.0)
        elif leaf in ("weight", "running_var"):
            out[name] = 0.5 + u
        else:
            out[name] = 0.1 * z
    return out

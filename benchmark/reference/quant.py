"""Lower precisions for the plain reference's convolutions (the controls).

A quantizer is ``q(tensor, kind, site) → tensor`` with ``kind`` ``"act"``
or ``"weight"`` (a convolution's operands), ``"grad"`` (a convolution's
output, whose gradient it may round on the way back) or ``"out"`` (a
stored activation; ``models.set_quantizer(..., outputs=True)``).
Forward rounding passes the gradient through unchanged
(straight-through).  The fp8 formats take a per-tensor scale (amax → the
format's largest).

* ``fp8``: the slide cells' control, below bfloat16: convolution
  operands in e4m3.
* ``fp8_step``: the train cells' control: the step wholly in fp8,
  operands and stored activations e4m3, gradients e5m2;
  ``bf16_step`` the same in bfloat16, a witness of bf16's own rounding.
* ``integer(bits, act_scales, float_sites)``: symmetric integers,
  weights per output channel (amax / qmax) and activations per tensor at
  the scales that :func:`calibrate` measured, every convolution but those
  of ``float_sites`` (the head): int8 is the post-training scheme of int8
  serving, int4 the step below it.
"""

from __future__ import annotations

import torch

from benchmark.reference.models import set_quantizer

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach()


def _round8(x: torch.Tensor, fmt) -> torch.Tensor:
    dtype, largest = fmt
    xf = x.float()
    scale = (xf.abs().amax() / largest).clamp_min(1e-30)
    return ((xf / scale).to(dtype).float() * scale).to(x.dtype)


def fp8(x: torch.Tensor, kind: str, site: str) -> torch.Tensor:
    """Convolution operands in e4m3, the gradient at each convolution's
    output in e5m2; what the convolutions store stays float32."""
    if kind == "grad":
        return _GradOnly.apply(x, E5M2) if x.requires_grad else x
    if kind == "out":
        return x
    return _straight_through(x, _round8(x.detach(), E4M3))


class _RoundBoth(torch.autograd.Function):
    """Forward rounding with ``forward_fmt``, backward with
    ``backward_fmt`` (None: bfloat16)."""

    @staticmethod
    def forward(ctx, x, forward_fmt, backward_fmt):
        ctx.backward_fmt = backward_fmt
        return _round(x, forward_fmt)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.backward_fmt), None, None


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    if fmt is None:
        return x.to(torch.bfloat16).to(x.dtype)
    return _round8(x, fmt)


def whole_step(forward_fmt, backward_fmt):
    """A training step computed wholly in a precision: convolution
    operands and every stored activation rounded to ``forward_fmt``, the
    gradients at convolution outputs and stored activations to
    ``backward_fmt`` (``E4M3``/``E5M2`` per-tensor scaled, or None for
    bfloat16).  Set with ``set_quantizer(model, q, outputs=True)``."""

    def q(x: torch.Tensor, kind: str, site: str) -> torch.Tensor:
        if kind == "grad":
            return _GradOnly.apply(x, backward_fmt) if x.requires_grad else x
        if kind == "out":
            return _RoundBoth.apply(x, forward_fmt, backward_fmt)
        return _straight_through(x, _round(x.detach(), forward_fmt))

    return q


class _GradOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.fmt), None


fp8_step = whole_step(E4M3, E5M2)
bf16_step = whole_step(None, None)


def integer(bits: int, act_scales: dict, float_sites=()):
    qmax = float(2 ** (bits - 1) - 1)

    def q(x: torch.Tensor, kind: str, site: str) -> torch.Tensor:
        if kind in ("grad", "out") or site in float_sites:  # inference only
            return x
        xf = x.float()
        if kind == "weight":
            amax = xf.detach().abs().amax(dim=(1, 2, 3), keepdim=True)
            s = (amax / qmax).clamp_min(1e-30)
        else:
            s = torch.as_tensor(act_scales[site] / qmax, device=x.device)
        r = torch.clamp(torch.round(xf / s), -qmax, qmax) * s
        return _straight_through(x, r.to(x.dtype))

    return q


@torch.no_grad()
def calibrate(model, batches) -> dict:
    """``{site: the largest |input| of the convolution at site}`` over the
    float32 forwards of ``batches`` (normalized NCHW images)."""
    amax: dict = {}

    def record(x, kind, site):
        if kind == "act":
            v = float(x.detach().abs().amax())
            amax[site] = max(amax.get(site, 0.0), v)
        return x

    set_quantizer(model, record)
    try:
        model.eval()
        for x in batches:
            model(x)
    finally:
        set_quantizer(model, None)
    return amax

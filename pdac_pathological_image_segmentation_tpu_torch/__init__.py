"""PDAC WSI segmentation in PyTorch for NVIDIA Hopper (H100).

The port of ``pdac_pathological_image_segmentation_tpu`` (JAX/flax/Pallas),
which stays beside it as the reference.  This package imports ``torch``,
numpy, PIL and yaml, never ``jax`` nor anything of the JAX package.  Entry
points take an explicit ``device``, default ``"cuda"``, and raise when no
card is present unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import torch

from pdac_pathological_image_segmentation_tpu_torch.config import (
    Config,
    load_config,
)

__all__ = ["Config", "device_to_host", "host_to_device", "load_config",
           "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if a CUDA device is asked
    for and none is present (the port never drops to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: a CPU tensor bound for a card is pinned and
    copied without blocking (a copy from pageable memory would first wait
    for the card's queue to drain); a tensor already pinned is copied from
    where it is (``pin_memory`` returns it as it is)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_to_host(tensors) -> list:
    """The tensors as numpy arrays, in one fetch: every copy is queued
    without blocking, then the host waits once."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    cuda = [t for t in tensors if t.is_cuda]
    if cuda:
        torch.cuda.current_stream(cuda[0].device).synchronize()
    return [h.numpy() for h in host]

"""Process group and device list (the JAX package's ``parallel/mesh.py``).

The JAX package runs one program over a device mesh and leaves its
collectives to XLA.  The port runs one process per rank for training
(``torch.distributed``: NCCL on cards, gloo on the CPU, or gloo on a card
when the caller names it) and one process over a list of devices for
sharded whole-slide inference (``infer/wsi_sharded.py``):

* :func:`initialize_distributed` is ``dist.init_process_group`` with the
  rendezvous given or read from a launcher's environment (``torchrun``:
  ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a no-op when
  a group exists or no rendezvous is named; a failing rendezvous raises;
* :func:`create_mesh` is the list of local devices the sharded runner
  and the evaluator take (``[cpu] * n`` on the CPU, the counterpart of
  the JAX tests' forced CPU device count); :func:`replicate` puts a model
  on each distinct device of such a list;
* :func:`rank`, :func:`world_size`, :func:`is_chief`,
  :func:`sync_global_devices` (a barrier);
* :func:`global_sum`: a tensor of per-rank partial sums whose value is the
  sum over ranks and whose gradient is this rank's own: the Dice of the
  global batch, formed on every rank, whose gradients then add up over
  ranks to the gradient of the global loss.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from pdac_pathological_image_segmentation_tpu_torch import resolve_device

LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def launched() -> bool:
    """Whether this process is one rank of a group: a group exists, or a
    launcher (``torchrun``) set the rendezvous in the environment."""
    return dist.is_initialized() or all(k in os.environ
                                        for k in LAUNCHER_ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           device="cuda") -> None:
    """Join the process group (``dist.init_process_group``).

    The rendezvous is ``init_method`` (``tcp://host:port``, ``file://…``)
    with ``rank`` and ``world_size``, or else the launcher's environment
    (``env://``).  Without either, and when a group already exists, it does
    nothing.  ``backend`` defaults to the device's: ``nccl`` for a CUDA
    device, ``gloo`` for the CPU; gloo on a card is taken only when named,
    and NCCL never gives way to it.  A rendezvous that fails raises (N
    ranks must not run on as N single-process runs writing one
    checkpoint); only a lost race against another initialization of this
    process is let pass."""
    if dist.is_initialized():
        return
    if init_method is None:
        if not all(k in os.environ for k in LAUNCHER_ENV):
            return
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if rank is None or world_size is None:
        raise ValueError(f"init_method {init_method!r} needs rank and "
                         "world_size")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, got {dev}")
    kwargs = {}
    if backend == "nccl" and dev.index is not None:
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kwargs)
    except (RuntimeError, ValueError):
        if not dist.is_initialized():
            raise


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    return rank() == 0


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier of every rank (``dist.barrier``); nothing in one process.
    ``name`` labels the point, as the JAX function's does."""
    del name
    if world_size() > 1:
        dist.barrier()


def create_mesh(num_devices: Optional[int] = None,
                device="cuda") -> List[torch.device]:
    """The local devices of a sharded run: every visible card, or the
    first ``num_devices`` (asking for more raises); on the CPU
    ``[cpu] * num_devices`` (one when None)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (num_devices or 1)
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    have = torch.cuda.device_count()
    if have == 0:
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    n = have if num_devices is None else num_devices
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def indexed_device(d) -> torch.device:
    """``d`` as a device with an index on a card (``cuda`` → the current
    card), so that equal devices compare equal."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def replicate(model: torch.nn.Module, devices
              ) -> Dict[torch.device, torch.nn.Module]:
    """``{device: model}`` for each distinct device of ``devices``: the
    model itself on the device it lies on, a deep copy moved to each
    other one (``[cuda:0] * 4`` holds one replica)."""
    home = indexed_device(next(model.parameters()).device)
    return {dev: model if dev == home else copy.deepcopy(model).to(dev)
            for dev in dict.fromkeys(indexed_device(d) for d in devices)}


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over ranks, in place (``dist.all_reduce``).  Under gloo a
    CUDA tensor goes through a host copy: gloo on torch 2.11 hands a large
    CUDA tensor's device pointer to its TCP transport, which fails
    ("writev ... Bad address", a 92 MB all_reduce on an H100), so the port
    never gives gloo a CUDA tensor.  NCCL takes it on the card."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ranks (one ``all_reduce``); the gradient flows to
    this rank's ``t`` only: ``t + (Σ_ranks t − t).detach()``.  A loss made
    of such sums has the global batch's value on every rank, and its
    gradient on rank r is rank r's share of the global gradient, so the
    gradients are summed over ranks, not averaged."""
    total = all_reduce(t.detach().clone())
    return t + (total - t.detach())


def sum_gradients(model: torch.nn.Module) -> None:
    """Sum every parameter's gradient over ranks, in place, with one
    ``all_reduce`` of a flat buffer in float32 (float64 for a float64
    model).  A parameter with no gradient on some rank takes zeros there;
    one with no gradient on any rank keeps none (Adam skips it, as on one
    device)."""
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        return
    acc = (torch.float64 if params[0].dtype == torch.float64
           else torch.float32)
    dev = params[0].device
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p))
         .reshape(-1).to(acc) for p in params]
        + [torch.tensor([float(p.grad is not None) for p in params],
                        dtype=acc, device=dev)])
    all_reduce(flat)
    has_grad = flat[-len(params):].tolist()  # one wait for the card
    offset = 0
    for p, flag in zip(params, has_grad):
        n = p.numel()
        if flag > 0:
            g = flat[offset:offset + n].view_as(p).to(p.dtype)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
        offset += n

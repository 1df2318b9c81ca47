"""Checkpoints: ``latest.pth`` every epoch, ``best.pth`` on improvement,
resume from ``latest.pth`` (the JAX package's ``train/checkpoint.py``).

The files are in the reference's format (``train_worker.py:116-125``):
``{"model": state_dict with the DDP "module." prefix, "optimizer":
Adam's state_dict, "epoch", "previous_best"}``, so the reference's
``test.py`` and the JAX package's ``load_reference_checkpoint_full`` read
them.  Beside those keys the port keeps the plateau scheduler's and the
early stop's state, which the reference does not save, so a resume
continues them.  Every tensor is written from the CPU to a temporary file
that replaces the old one: inline by :func:`save_checkpoint`, or by
:class:`AsyncCheckpointSaver` on a background thread while the next epoch
trains (the same bytes).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Callable, Optional

import torch
import torch.nn as nn

from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    BN_BUFFERS,
    parameter_names,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    drop_unbuilt_keys,
)

LATEST = "latest.pth"
BEST = "best.pth"
_PREFIX = "module."


def _map_tensors(obj, fn: Callable):
    if torch.is_tensor(obj):
        return fn(obj.detach())
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map_tensors(v, fn) for v in obj]
    return obj


def checkpoint_payload(model: nn.Module, optimizer: torch.optim.Optimizer,
                       epoch: int, previous_best: float,
                       scheduler_state: Optional[dict] = None,
                       earlystop_state: Optional[dict] = None,
                       to_host: Callable = torch.Tensor.cpu) -> dict:
    """The reference-format dictionary of one epoch, each tensor through
    ``to_host`` (by default the tensor on the CPU)."""
    payload = {
        "model": {_PREFIX + k: v for k, v in
                  _map_tensors(model.state_dict(), to_host).items()},
        "optimizer": _map_tensors(optimizer.state_dict(), to_host),
        "epoch": int(epoch),
        "previous_best": float(previous_best),
    }
    if scheduler_state is not None:
        payload["scheduler"] = dict(scheduler_state)
    if earlystop_state is not None:
        payload["earlystop"] = dict(earlystop_state)
    return payload


def save_checkpoint(pth_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int,
                    previous_best: float, scheduler_state: dict,
                    earlystop_state: dict, is_best: bool) -> None:
    """Write ``latest.pth`` and, when ``is_best``, ``best.pth``."""
    _write(pth_dir, checkpoint_payload(model, optimizer, epoch, previous_best,
                                       scheduler_state, earlystop_state),
           is_best)


def _write(pth_dir: str, payload: dict, is_best: bool) -> None:
    os.makedirs(pth_dir, exist_ok=True)
    latest = os.path.join(pth_dir, LATEST)
    tmp = latest + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, latest)
    if is_best:
        shutil.copyfile(latest, tmp)
        os.replace(tmp, os.path.join(pth_dir, BEST))


class AsyncCheckpointSaver:
    """Per-epoch checkpoints written while the next epoch trains (the JAX
    package's ``AsyncCheckpointSaver``).

    :meth:`save` takes a snapshot of the model, Adam, scheduler and early
    stop state and returns: a tensor on a card is cloned on the device (on
    the current stream, so the next step's in-place updates come after
    it), then copied to pinned host memory on a side stream; a CPU tensor
    is cloned.  A background thread waits for the copies and writes the
    files :func:`save_checkpoint` would write, byte for byte.  One save is
    in flight at a time: a second :meth:`save`, or :meth:`wait`, joins the
    previous write first and re-raises what it raised."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._stream = None

    def wait(self) -> None:
        """Block until the save in flight (if any) has landed; re-raise its
        failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _to_pinned(self, t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        host = torch.empty_like(t, device="cpu", pin_memory=True)
        with torch.cuda.stream(self._stream):
            host.copy_(t, non_blocking=True)
        t.record_stream(self._stream)  # freed once the copy has run
        return host

    def save(self, pth_dir: str, model: nn.Module,
             optimizer: torch.optim.Optimizer, epoch: int,
             previous_best: float, scheduler_state: dict,
             earlystop_state: dict, is_best: bool) -> None:
        """:func:`save_checkpoint`'s contract, returning once the snapshot
        is queued."""
        self.wait()
        payload = checkpoint_payload(model, optimizer, epoch, previous_best,
                                     scheduler_state, earlystop_state,
                                     to_host=torch.Tensor.clone)
        device = next(model.parameters()).device
        copied = None
        if device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
            payload = _map_tensors(payload, self._to_pinned)
            copied = self._stream.record_event()

        def write() -> None:
            try:
                if copied is not None:
                    copied.synchronize()
                _write(pth_dir, payload, is_best)
            except Exception as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="ckpt-save",
                                        daemon=True)
        self._thread.start()


def _adam_state_by_name(ckpt: dict, model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer``'s state_dict with the checkpoint's moments.  Torch
    indexes them by position in the checkpoint's own parameter list (its
    ``model`` keys without BN buffers), which may hold parameters the port
    does not build (a reference ResUNet's ``encoder.fc``, smp
    EfficientNet's ``encoder._conv_head``/``encoder._bn1``) and comes in
    smp's order for a reference DeepLabV3+ or PSPNet: each moment goes
    position → name → the port's position.  Parameters that never had a
    gradient (PSPNet's unrun stages, smp EfficientNet's head) have no
    moment.  The port's own ``param_groups`` (and learning rate) are
    kept."""
    ckpt_names = [k.removeprefix(_PREFIX) for k in ckpt["model"]
                  if not k.endswith(BN_BUFFERS)]
    params = dict(model.named_parameters())
    ours = {k: i for i, k in enumerate(parameter_names(model))}
    state = {}
    for idx, entry in (ckpt.get("optimizer") or {}).get("state", {}).items():
        name = ckpt_names[int(idx)]
        if name not in ours:  # dropped with the weights it belongs to
            continue
        if entry["exp_avg"].shape != params[name].shape:
            raise ValueError(f"Adam moment of {name}: shape "
                             f"{tuple(entry['exp_avg'].shape)}, parameter "
                             f"{tuple(params[name].shape)}")
        state[ours[name]] = entry
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def restore_checkpoint(pth_dir: str, model: nn.Module,
                       optimizer: torch.optim.Optimizer,
                       name: str = LATEST) -> Optional[dict]:
    """Load ``pth_dir/name`` (the port's or the reference's) into ``model``
    and ``optimizer`` (onto their devices) and return its other keys, or
    ``None`` when there is none.  Keys of parameters the model does not
    build are dropped; the rest loads strictly."""
    path = os.path.join(pth_dir, name)
    if not os.path.isfile(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(drop_unbuilt_keys(
        model, {k.removeprefix(_PREFIX): v for k, v in ckpt["model"].items()}),
        strict=True)
    optimizer.load_state_dict(_adam_state_by_name(ckpt, model, optimizer))
    return {k: v for k, v in ckpt.items() if k not in ("model", "optimizer")}

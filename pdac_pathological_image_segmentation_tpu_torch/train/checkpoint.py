"""Checkpoints: ``latest.pth`` every epoch, ``best.pth`` on improvement,
resume from ``latest.pth`` (the JAX package's ``train/checkpoint.py``).

The files are in the reference's format (``train_worker.py:116-125``):
``{"model": state_dict with the DDP "module." prefix, "optimizer":
Adam's state_dict, "epoch", "previous_best"}``, so the reference's
``test.py`` and the JAX package's ``load_reference_checkpoint_full`` read
them.  Beside those keys the port keeps the plateau scheduler's and the
early stop's state, which the reference does not save, so a resume
continues them.  Every tensor is written from the CPU, synchronously, to a
temporary file that replaces the old one.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

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


def _cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_cpu(v) for v in obj]
    return obj


def checkpoint_payload(model: nn.Module, optimizer: torch.optim.Optimizer,
                       epoch: int, previous_best: float,
                       scheduler_state: Optional[dict] = None,
                       earlystop_state: Optional[dict] = None) -> dict:
    """The reference-format dictionary of one epoch, on the CPU."""
    payload = {
        "model": {_PREFIX + k: v for k, v in _cpu(model.state_dict()).items()},
        "optimizer": _cpu(optimizer.state_dict()),
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
    os.makedirs(pth_dir, exist_ok=True)
    payload = checkpoint_payload(model, optimizer, epoch, previous_best,
                                 scheduler_state, earlystop_state)
    latest = os.path.join(pth_dir, LATEST)
    tmp = latest + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, latest)
    if is_best:
        shutil.copyfile(latest, tmp)
        os.replace(tmp, os.path.join(pth_dir, BEST))


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

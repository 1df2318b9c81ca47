"""Serving artifacts of the port (the JAX package's ``infer/export.py``).

Layout: an 8-byte magic (:data:`MAGIC`, distinct from the JAX package's
``PDACSRV1``, whose loader therefore refuses this file as "bad magic"), a
u32 little-endian length, JSON metadata (tile, model, backbone, stain,
int8, compute_dtype, head_dtype, num_classes, dilations), then
``torch.save`` of the model's ``state_dict``.  Loading rebuilds the model
from the metadata on the requested device; an artifact without
``head_dtype`` loads with a float32 head, one without ``dilations`` with
the default atrous rates (3, 6, 9).  DeepLabV3+'s weights have the same
shapes at any rates, so the rates must travel in the metadata.
"""

from __future__ import annotations

import io
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch import resolve_device
from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    drop_unbuilt_keys,
)

MAGIC = b"PDACPT01"
_INT8 = "int8 serving is not ported yet (ROADMAP.md Queue 1, item 4: int8)"


def export_serving_artifact(cfg: Config, state_dict: Mapping[str, torch.Tensor],
                            out_path: str, *, tile: Optional[int] = None,
                            int8: bool = False) -> int:
    """Write ``state_dict`` (the port model's names; keys of parameters the
    model does not build, such as a reference ResUNet's ``encoder.fc`` or
    smp EfficientNet's ``encoder._conv_head``, are dropped) for ``cfg`` to ``out_path``; returns the artifact size in
    bytes.  The model is built and loaded strictly first, so a file that
    would not load is never written."""
    if int8:
        raise NotImplementedError(_INT8)
    if cfg.stain != "none":
        raise NotImplementedError(
            f"stain={cfg.stain!r} is not ported yet (ROADMAP.md Queue 1, "
            "item 4)")
    from pdac_pathological_image_segmentation_tpu_torch.models.registry import (
        build_model,
    )

    tile = int(tile or cfg.img_size)
    model = build_model(cfg)
    state_dict = drop_unbuilt_keys(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    meta = json.dumps({
        "tile": tile,
        "model": cfg.model,
        "backbone": cfg.backbone,
        "stain": cfg.stain,
        "int8": False,
        "compute_dtype": cfg.compute_dtype,
        "head_dtype": str(cfg.extras.get("head_dtype", "float32")).lower(),
        "num_classes": int(cfg.num_classes),
        "dilations": [int(d) for d in cfg.dilations],
    }).encode()
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, buf)
    payload = MAGIC + len(meta).to_bytes(4, "little") + meta + buf.getvalue()
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, out_path)  # readers never see a partial artifact
    return len(payload)


class ServingArtifact:
    """A loaded artifact: ``artifact(images_u8) → probs``.

    ``images_u8`` is uint8 ``(b, tile, tile, 3)`` (numpy or tensor); the
    result is a float32 numpy ``(b, tile, tile)`` array.  ``meta`` carries
    the export-time metadata and ``device`` the torch device it runs on."""

    def __init__(self, model: torch.nn.Module, meta: dict,
                 device: torch.device) -> None:
        from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
            make_infer_step,
        )

        self.meta = dict(meta)
        self.tile = int(meta["tile"])
        self.device = device
        self.step = make_infer_step(model, self.tile, stain=meta["stain"])

    def __call__(self, images) -> np.ndarray:
        if not torch.is_tensor(images):
            arr = np.asarray(images, np.uint8)
            # torch.from_numpy wants a writable array (PIL's are not)
            images = torch.from_numpy(
                arr if arr.flags.writeable else arr.copy())
        return self.step(images.to(self.device)).cpu().numpy()

    def aot(self, batch_size: int):
        """The callable for one batch size, after one warm-up run of zeros
        at that size (cuDNN picks its algorithms there, so the first real
        request runs at steady-state speed)."""
        b = int(batch_size)
        shape = (b, self.tile, self.tile, 3)
        self(np.zeros(shape, np.uint8))

        def fn(images) -> np.ndarray:
            if tuple(images.shape) != shape:
                raise ValueError(f"bucket expects {shape}, got "
                                 f"{tuple(images.shape)}")
            return self(images)

        return fn


def read_artifact(path: str):
    """``(meta, state_dict)`` of an artifact file, tensors on the CPU."""
    with open(path, "rb") as f:
        payload = f.read()
    if payload[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{path} is not a port serving artifact (bad "
                         f"magic; expected {MAGIC!r})")
    off = len(MAGIC)
    meta_len = int.from_bytes(payload[off: off + 4], "little")
    off += 4
    if off + meta_len > len(payload):
        raise ValueError(f"{path} is truncated (header claims {meta_len} "
                         f"metadata bytes, {len(payload) - off} present)")
    try:
        meta = json.loads(payload[off: off + meta_len].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path} has corrupt metadata: {e}") from e
    state_dict = torch.load(io.BytesIO(payload[off + meta_len:]),
                            map_location="cpu", weights_only=True)
    return meta, state_dict


def load_serving_artifact(path: str, device="cuda") -> ServingArtifact:
    """Rebuild the artifact's model on ``device`` (default ``"cuda"``,
    which raises when no card is present)."""
    from pdac_pathological_image_segmentation_tpu_torch.models.registry import (
        build_model,
    )

    dev = resolve_device(device)
    meta, state_dict = read_artifact(path)
    if meta.get("int8"):
        raise NotImplementedError(_INT8)
    cfg = Config(model=meta["model"], backbone=meta["backbone"],
                 img_size=int(meta["tile"]), stain=meta["stain"],
                 compute_dtype=meta["compute_dtype"],
                 num_classes=int(meta.get("num_classes", 1)),
                 # artifacts written before these fields existed have an
                 # f32 head and the default rates
                 dilations=tuple(meta.get("dilations", (3, 6, 9))),
                 extras={"head_dtype": meta.get("head_dtype", "float32")})
    model = build_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    return ServingArtifact(model.to(dev), meta, dev)

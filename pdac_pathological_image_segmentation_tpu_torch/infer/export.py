"""Serving artifacts of the port (the JAX package's ``infer/export.py``).

Layout: an 8-byte magic (:data:`MAGIC`, distinct from the JAX package's
``PDACSRV1``, whose loader therefore refuses this file as "bad magic"), a
u32 little-endian length, JSON metadata (tile, model, backbone, stain,
int8, act_storage, compute_dtype, head_dtype, num_classes, dilations), then
``torch.save`` of the payload.  A float artifact's payload is the model's
``state_dict``; loading rebuilds the model from the metadata on the
requested device.  An artifact without ``head_dtype`` loads with a float32
head, one without ``dilations`` with the default atrous rates (3, 6, 9).
DeepLabV3+'s weights have the same shapes at any rates, so the rates must
travel in the metadata.

An int8 artifact (``int8=True``, ``infer/quantized.py``) holds each
quantized site's int8 weights and scales, the calibrated activation scales
and only the float tensors the int8 forward still reads (BatchNorm
statistics, biases, GroupNorm, upconvs, depthwise convs, heads), not the
float copies of the quantized kernels; loading rebuilds the quantized step
without calibrating again.
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


def _int8_payload(cfg: Config, state_dict, tile: int, calib_batches,
                  device) -> dict:
    """Calibrate on ``device`` and quantize: the int8 artifact's payload."""
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized as q,
    )

    if not calib_batches:
        raise ValueError("int8 export needs calibration batches (uint8 NHWC)")
    if tile != cfg.img_size:
        raise ValueError(f"int8 export serves at cfg.img_size={cfg.img_size} "
                         f"(calibration runs there); got tile={tile}")
    dev = resolve_device(device)
    sd = {k: v.to(dev) for k, v in state_dict.items()}
    bundle, _ = q.quantize_from_config(cfg, sd, calib_batches)
    # the depth-3 PSPNet never runs the encoder's last two stages
    unrun = ("encoder.layer3.", "encoder.layer4.") \
        if cfg.model == "pspnet" else ()
    quantized = {key for key, _ in q.SITES[cfg.model](sd).values()}
    floats = {k: v.cpu() for k, v in state_dict.items()
              if k not in quantized and not k.startswith(unrun)
              and not k.endswith("num_batches_tracked")}
    return {"state_dict": floats,
            "qweights": {site: (kq.cpu(), ks.cpu()) for site, (kq, ks)
                         in bundle["qweights"].items()},
            "act_scales": dict(bundle["act_scales"])}


def export_serving_artifact(cfg: Config, state_dict: Mapping[str, torch.Tensor],
                            out_path: str, *, tile: Optional[int] = None,
                            int8: bool = False, calib_batches=None,
                            device="cuda") -> int:
    """Write ``state_dict`` (the port model's names; keys of parameters the
    model does not build, such as a reference ResUNet's ``encoder.fc`` or
    smp EfficientNet's ``encoder._conv_head``, are dropped) for ``cfg`` to
    ``out_path``; returns the artifact size in bytes.  The model is built
    and loaded strictly first, so a file that would not load is never
    written.  ``int8=True`` calibrates on ``calib_batches`` (uint8 NHWC at
    ``cfg.img_size``) on ``device`` (default ``"cuda"``, which raises
    without a card) and writes the int8 artifact."""
    from pdac_pathological_image_segmentation_tpu_torch.models.registry import (
        build_model,
    )

    tile = int(tile or cfg.img_size)
    model = build_model(cfg)
    state_dict = drop_unbuilt_keys(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    state_dict = {k: v.detach().cpu() for k, v in state_dict.items()}
    if int8:
        payload = _int8_payload(cfg, state_dict, tile, calib_batches,
                                device)
    else:
        payload = state_dict
    meta = json.dumps({
        "tile": tile,
        "model": cfg.model,
        "backbone": cfg.backbone,
        "stain": cfg.stain,
        "int8": bool(int8),
        # int8 artifacts keep activations int8 between sites (the JAX
        # default); the loader reads the mode from here
        "act_storage": "int8" if int8 else None,
        "compute_dtype": cfg.compute_dtype,
        "head_dtype": str(cfg.extras.get("head_dtype", "float32")).lower(),
        "num_classes": int(cfg.num_classes),
        "dilations": [int(d) for d in cfg.dilations],
    }).encode()
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = MAGIC + len(meta).to_bytes(4, "little") + meta + buf.getvalue()
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, out_path)  # readers never see a partial artifact
    return len(blob)


class ServingArtifact:
    """A loaded artifact: ``artifact(images_u8) → probs``.

    ``images_u8`` is uint8 ``(b, tile, tile, 3)`` (numpy or tensor); the
    result is a float32 numpy ``(b, tile, tile)`` array.  ``step`` is the
    device step (``step(images_u8) → probs`` on the device), ``meta`` the
    export-time metadata and ``device`` the torch device it runs on."""

    def __init__(self, step, meta: dict, device: torch.device) -> None:
        self.meta = dict(meta)
        self.tile = int(meta["tile"])
        self.device = device
        self.step = step

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
    """``(meta, payload)`` of an artifact file, tensors on the CPU: the
    ``state_dict``, or for an int8 artifact ``{"state_dict", "qweights",
    "act_scales"}``."""
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
    body = torch.load(io.BytesIO(payload[off + meta_len:]),
                      map_location="cpu", weights_only=True)
    return meta, body


def _config(meta: dict) -> Config:
    return Config(model=meta["model"], backbone=meta["backbone"],
                  img_size=int(meta["tile"]), stain=meta["stain"],
                  compute_dtype=meta["compute_dtype"],
                  num_classes=int(meta.get("num_classes", 1)),
                  # artifacts written before these fields existed have an
                  # f32 head and the default rates
                  dilations=tuple(meta.get("dilations", (3, 6, 9))),
                  extras={"head_dtype": meta.get("head_dtype", "float32")})


def load_serving_artifact(path: str, device="cuda") -> ServingArtifact:
    """Rebuild the artifact's step on ``device`` (default ``"cuda"``, which
    raises when no card is present): the model for a float artifact, the
    quantized step for an int8 one."""
    from pdac_pathological_image_segmentation_tpu_torch.models.registry import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_infer_step,
    )

    dev = resolve_device(device)
    meta, payload = read_artifact(path)
    cfg = _config(meta)
    if meta.get("int8"):
        from pdac_pathological_image_segmentation_tpu_torch.infer import (
            quantized as q,
        )

        sd = {k: v.to(dev) for k, v in payload["state_dict"].items()}
        bundle = {"qweights": {site: (kq.to(dev), ks.to(dev)) for site,
                               (kq, ks) in payload["qweights"].items()},
                  "act_scales": payload["act_scales"]}
        forward = q.make_forward(cfg.model, cfg.backbone, cfg.stain,
                                 **q.model_kwargs(cfg))
        step = q.make_quantized_infer_step(
            sd, bundle, cfg.img_size, forward,
            act_storage=meta["act_storage"])
        return ServingArtifact(step, meta, dev)
    model = build_model(cfg)
    model.load_state_dict(payload, strict=True)
    model = model.to(dev)
    return ServingArtifact(make_infer_step(model, cfg.img_size, cfg.stain),
                           meta, dev)


def calib_batches_from_dir(path: str, tile: int, n: int = 16,
                           batch: int = 8) -> list:
    """Calibration batches for int8 export from a patch directory (the
    reference's filesystem contract, ``data/discovery.py``): the first
    ``n`` images, resized on the host to ``tile`` where they differ, in
    uint8 NHWC batches of ``batch``."""
    from PIL import Image

    from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
        discover_split,
    )

    img_paths, _ = discover_split(path)
    imgs = []
    for img_path in img_paths[:n]:
        im = Image.open(img_path).convert("RGB")
        if im.size != (tile, tile):
            im = im.resize((tile, tile), Image.BILINEAR)
        imgs.append(np.asarray(im, dtype=np.uint8))
    arr = np.stack(imgs)
    return [arr[i: i + batch] for i in range(0, len(arr), batch)]

"""Fused train-time augmentation (the JAX package's
``ops/pallas/fused_augment.py``).

:func:`fused_train_transform` takes the loader's NHWC uint8 patches and
(N, H, W) uint8 masks with the batch's :class:`~.augment.AugmentTables` and
returns NCHW bfloat16 normalized, augmented images and float32 masks.  On a
CUDA tensor it launches the hand-written Hopper kernel
``csrc/fused_augment.cu`` (which replaces the Pallas ``_augment_kernel``);
on a CPU tensor it runs :func:`fused_train_transform_reference`, the plain
chain of ``ops/augment.py``.  There is no fallback: on a CUDA tensor the
kernel runs or the call raises.  Square tiles only, as in the JAX kernel.

The random draws stay outside the kernel (``augment.draw_augment_scalars``
→ ``augment.make_augment_tables``), so tests can feed both versions, and
the JAX package, the same tables.
"""

from __future__ import annotations

import ctypes

import torch

from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    AugmentTables,
    train_transform,
)

_SOURCE = "fused_augment.cu"
_PIXELS_PER_BLOCK = 256 * 16  # kPixelsPerBlock in the kernel
_SLOTS = 4


def fused_train_transform_reference(images: torch.Tensor, masks: torch.Tensor,
                                    tables: AugmentTables):
    """The plain version: :func:`~.augment.train_transform` in its default
    mode (bf16 chain, jitter on [0, 1] with per-slot clipping)."""
    return train_transform(images, masks, tables)


def _lib():
    from pdac_pathological_image_segmentation_tpu_torch.ops import _build

    fn = _build.load(_SOURCE).pdac_fused_augment
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_tables(tables: AugmentTables, n: int, device: torch.device):
    want = {"a_mats": ((n, _SLOTS, 3, 3), torch.float32),
            "gammas": ((n, _SLOTS), torch.float32),
            "ints": ((n, 8), torch.int32),
            "geom": ((n, 3), torch.int32)}
    for name, (shape, dtype) in want.items():
        t = getattr(tables, name)
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"tables.{name} must be a contiguous {dtype} {shape} tensor "
                f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def fused_train_transform(images: torch.Tensor, masks: torch.Tensor,
                          tables: AugmentTables):
    """(N,S,S,3) uint8 images + (N,S,S) uint8 masks + the batch's tables →
    (bf16 (N,3,S,S) images, f32 (N,S,S) masks).

    A CPU tensor goes to :func:`fused_train_transform_reference`; a CUDA
    tensor launches the kernel on the current stream or raises.  Each
    launch adds one to ``fused_train_transform.launches`` and to
    ``fused_train_transform.launches_by_shape[(n, size)]``."""
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected NHWC RGB images, got {tuple(images.shape)}")
    n, h, w, _ = images.shape
    if h != w:
        raise ValueError(f"square tiles only, got {h}x{w}")
    if tuple(masks.shape) != (n, h, w):
        raise ValueError(f"masks must be {(n, h, w)}, got {tuple(masks.shape)}")
    if images.dtype != torch.uint8 or masks.dtype != torch.uint8:
        raise TypeError(f"images and masks must be uint8, got {images.dtype} "
                        f"and {masks.dtype}")
    if masks.device != images.device:
        raise ValueError("images and masks must share a device")
    _check_tables(tables, n, images.device)
    if images.device.type == "cpu":
        return fused_train_transform_reference(images, masks, tables)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    if n * h * w * 3 >= 2 ** 31:
        raise ValueError(f"batch {tuple(images.shape)} exceeds the kernel's "
                         "limits")
    images, masks = images.contiguous(), masks.contiguous()
    out = torch.empty((n, 3, h, w), dtype=torch.bfloat16, device=images.device)
    mout = torch.empty((n, h, w), dtype=torch.float32, device=images.device)
    blocks = -(-h * w // _PIXELS_PER_BLOCK)
    partials = torch.empty(_SLOTS * n * blocks * 3, dtype=torch.float32,
                           device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = _lib()(images.data_ptr(), masks.data_ptr(),
                 tables.a_mats.data_ptr(), tables.gammas.data_ptr(),
                 tables.ints.data_ptr(), tables.geom.data_ptr(),
                 out.data_ptr(), mout.data_ptr(), partials.data_ptr(), n, h,
                 stream)
    if err != 0:
        raise RuntimeError(f"fused augment kernel launch failed: cudaError "
                           f"{err}")
    fused_train_transform.launches += 1
    by_shape = fused_train_transform.launches_by_shape
    by_shape[(n, h)] = by_shape.get((n, h), 0) + 1
    return out, mout


fused_train_transform.launches = 0
fused_train_transform.launches_by_shape = {}

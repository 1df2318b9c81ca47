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

The kernel works on 64×64 source tiles.  :func:`out_tile` and
:func:`in_tile` are its index math (the kernel follows the same formulas):
where a source tile lands under the geometry ``(t, l, r)`` of
``augment.geom_bits``, and where each of its pixels lands in that output
tile.  :func:`lookup_tables` are the byte tables it reads instead of
dividing.
"""

from __future__ import annotations

import ctypes

import torch

from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    AugmentTables,
    normalize_bf16,
    train_transform,
    unit_bf16,
)

_SOURCE = "fused_augment.cu"
TILE = 64  # kTile in the kernel
_VEC_BYTES = 16  # the kernel's vector loads and stores
_SLOTS = 4
_tables: dict = {}


def fused_train_transform_reference(images: torch.Tensor, masks: torch.Tensor,
                                    tables: AugmentTables):
    """The plain version: :func:`~.augment.train_transform` in its default
    mode (bf16 chain, jitter on [0, 1] with per-slot clipping)."""
    return train_transform(images, masks, tables)


def out_tile(size: int, ty0: int, tx0: int, t: int, l: int, r: int):
    """``(row0, col0, rows, cols)`` of the output tile that the source tile
    at ``(ty0, tx0)`` of a ``size``² sample maps to under
    ``out = (exch@)ˡ Tᵗ(x) (@exch)ʳ``; tiles at the bottom and right edges
    are ragged."""
    th, tw = min(TILE, size - ty0), min(TILE, size - tx0)
    a0, ah, b0, bw = (tx0, tw, ty0, th) if t else (ty0, th, tx0, tw)
    return (size - a0 - ah if l else a0, size - b0 - bw if r else b0, ah, bw)


def in_tile(i, j, th: int, tw: int, t: int, l: int, r: int):
    """Where pixel ``(i, j)`` of a ``th``×``tw`` source tile lands in its
    output tile (:func:`out_tile`); ``i``, ``j`` may be arrays."""
    yr, yc = (j, i) if t else (i, j)
    ah, bw = (tw, th) if t else (th, tw)
    return (ah - 1 - yr if l else yr, bw - 1 - yc if r else yc)


def lookup_tables(device) -> tuple:
    """``(unit (256,) f32, norm (3, 256) bf16)`` on ``device``: ``unit[v]``
    is ``bf16(v / 255)`` and ``norm[c, v]`` the normalized channel-``c``
    output of an un-jittered byte ``v``, both computed by the plain chain's
    own steps (``augment.unit_bf16``, ``augment.normalize_bf16``) on that
    device, so they equal it bit for bit.  Built once per device."""
    device = torch.device(device)
    cached = _tables.get(device)
    if cached is None:
        byte = torch.arange(256, device=device).to(torch.uint8)
        unit = unit_bf16(byte.view(1, 1, 256, 1).expand(1, 1, 256, 3))
        norm = normalize_bf16(unit)[0, :, 0].contiguous()
        cached = (unit[0, 0, 0].float().contiguous(), norm)
        _tables[device] = cached
    return cached


def _lib():
    from pdac_pathological_image_segmentation_tpu_torch.ops import _build

    fn = _build.load(_SOURCE).pdac_fused_augment
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
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


def vector_path(size: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernel takes its 16-byte instantiation: every row of a
    ``size``² sample starts on a 16-byte boundary (``size % 16 == 0``) and
    so does each tensor; otherwise its byte-load instantiation runs."""
    return size % _VEC_BYTES == 0 and all(
        t.data_ptr() % _VEC_BYTES == 0 for t in tensors)


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
    tiles = (-(-h // TILE)) ** 2
    partials = torch.empty(_SLOTS * n * tiles * 3, dtype=torch.float32,
                           device=images.device)
    unit, norm = lookup_tables(images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = _lib()(images.data_ptr(), masks.data_ptr(),
                 tables.a_mats.data_ptr(), tables.gammas.data_ptr(),
                 tables.ints.data_ptr(), tables.geom.data_ptr(),
                 unit.data_ptr(), norm.data_ptr(), out.data_ptr(),
                 mout.data_ptr(), partials.data_ptr(), n, h,
                 int(vector_path(h, images, masks, out, mout)), stream)
    if err != 0:
        raise RuntimeError(f"fused augment kernel launch failed: cudaError "
                           f"{err}")
    fused_train_transform.launches += 1
    by_shape = fused_train_transform.launches_by_shape
    by_shape[(n, h)] = by_shape.get((n, h), 0) + 1
    return out, mout


fused_train_transform.launches = 0
fused_train_transform.launches_by_shape = {}

"""Overlap-blend stitching for sliding-window WSI inference (the JAX
package's ``ops/stitch.py``), on device tensors.

Predicted probability tiles are weighted by a blend window and added into
a canvas, with a matching weight canvas; the final map is
``accum / weight``, seamless across tile boundaries when tiles overlap (the
reference's 0-overlap paste is ``blend="uniform"`` with stride == tile).

Tiles are added one after another, in tile order (the JAX package's
``lax.scan``): overlapping sums never depend on how atomics interleave, so
a stitched map repeats bit for bit run to run.  The canvases are updated in
place (the JAX package donates them).  On CPU tensors the adds are the
plain loop of slice adds (:func:`stitch_tiles_into_reference`); on CUDA
tensors one launch of the hand-written kernel of ``csrc/stitch.cu`` adds a
whole batch, in the same order and with the same float32 roundings, so its
maps equal the loop's bit for bit.  There is no fallback: on a CUDA tensor
the kernel runs or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch import host_to_device

_SOURCE = "stitch.cu"
# csrc/stitch.cu, enum Dtype
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fn = None


@functools.lru_cache(maxsize=16)
def _blend_window_np(tile: int, mode: str) -> np.ndarray:
    if mode == "uniform":
        return np.ones((tile, tile), dtype=np.float32)
    if mode == "hann":
        # separable raised-cosine, >0 everywhere so division is safe even
        # for non-overlapping tiles
        w1 = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
        w1 = np.maximum(w1, 1e-3).astype(np.float32)
        return np.outer(w1, w1)
    if mode == "pyramid":
        r = np.arange(tile, dtype=np.float32)
        w1 = np.minimum(r + 1.0, tile - r)
        w1 /= w1.max()
        return np.outer(w1, w1)
    raise ValueError(f"unknown blend mode {mode!r}")


@functools.lru_cache(maxsize=16)
def _blend_window_on(tile: int, mode: str, device: torch.device
                     ) -> torch.Tensor:
    # a plain tensor even when first asked for under inference_mode
    with torch.inference_mode(False):
        return torch.from_numpy(_blend_window_np(tile, mode)).to(device)


def blend_window(tile: int, mode: str = "hann", device="cpu") -> torch.Tensor:
    """The ``(tile, tile)`` float32 blend window on ``device``: one cached
    tensor per ``(tile, mode, device)``, made (and copied to a card) at the
    first call only.  Callers read it and never write it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _blend_window_on(tile, mode, device)


def stitch_tiles(probs: torch.Tensor, coords, canvas_hw: tuple,
                 blend: str = "hann") -> tuple:
    """Add ``probs`` (``(T, t, t)`` binary or ``(T, t, t, C)`` channelled)
    at ``coords`` (``(T, 2)`` top-left ``(y, x)``, host ints) into fresh
    canvases on ``probs``' device; returns ``(accum, weight)``.

    Channelled tiles get an ``(h, w, C)`` accumulation canvas; the weight
    canvas is always 2-D (every class shares the blend window)."""
    h, w = canvas_hw
    shape = (h, w) if probs.ndim == 3 else (h, w, probs.shape[-1])
    accum = torch.zeros(shape, dtype=torch.float32, device=probs.device)
    weight = torch.zeros((h, w), dtype=torch.float32, device=probs.device)
    return stitch_tiles_into(accum, weight, probs, coords, blend=blend)


def stitch_tiles_into_reference(accum: torch.Tensor, weight: torch.Tensor,
                                probs: torch.Tensor, coords,
                                blend: str = "hann") -> tuple:
    """The plain version of :func:`stitch_tiles_into`: one slice add a
    window into each canvas, from a Python loop, in tile order."""
    tile = probs.shape[1]
    win = blend_window(tile, blend, accum.device)
    weighted = probs.float() * (win[..., None] if probs.ndim == 4 else win)
    h, w = weight.shape
    yx = _host_coords(coords)
    for i, (y, x) in enumerate(yx.tolist()):
        y = min(max(y, 0), h - tile)
        x = min(max(x, 0), w - tile)
        accum[y:y + tile, x:x + tile] += weighted[i]
        weight[y:y + tile, x:x + tile] += win
    return accum, weight


def _host_coords(coords) -> np.ndarray:
    return np.asarray(coords.cpu() if torch.is_tensor(coords) else coords,
                      np.int64).reshape(-1, 2)


def clamped_span(coords, tile: int, canvas_hw: tuple) -> tuple:
    """``(origins, (y_lo, y_hi, x_lo, x_hi))``: the ``(k, 2)`` int32 window
    origins shifted inside the canvas (as ``lax.dynamic_slice`` clamps) and
    the rows and columns their windows cover; raises on a canvas smaller
    than a tile."""
    h, w = canvas_hw
    if h < tile or w < tile:
        raise ValueError(f"canvas {(h, w)} is smaller than a {tile}² tile")
    yx = np.clip(_host_coords(coords), 0, (h - tile, w - tile)
                 ).astype(np.int32)
    if not len(yx):
        return yx, (0, 0, 0, 0)
    lo = yx.min(0)
    hi = yx.max(0) + tile
    return yx, (int(lo[0]), int(hi[0]), int(lo[1]), int(hi[1]))


def _check(accum, weight, probs, k: int) -> None:
    dev = accum.device
    if weight.device != dev or probs.device != dev:
        raise ValueError(f"accum on {dev}, weight on {weight.device}, probs "
                         f"on {probs.device}")
    for name, t in (("accum", accum), ("weight", weight)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 canvas, "
                             f"got {t.dtype} with strides {t.stride()}")
    if probs.dtype not in _DTYPES:
        raise TypeError(f"probs must be float32, bfloat16 or float16, got "
                        f"{probs.dtype}")
    channels = accum.shape[2:] if accum.ndim == 3 else ()
    if weight.ndim != 2 or accum.ndim not in (2, 3) \
            or tuple(accum.shape[:2]) != tuple(weight.shape) \
            or probs.ndim != accum.ndim + 1 \
            or probs.shape[1] != probs.shape[2] \
            or tuple(probs.shape[3:]) != tuple(channels):
        raise ValueError(f"accum {tuple(accum.shape)}, weight "
                         f"{tuple(weight.shape)} and probs "
                         f"{tuple(probs.shape)} do not fit together")
    if probs.shape[0] < k:
        raise ValueError(f"{k} coordinates for {probs.shape[0]} windows")
    # int32 offsets within a row; 16-row patches on the grid's y, which
    # CUDA caps at 65,535 blocks
    if accum[0].numel() >= 2 ** 31 - 256 \
            or -(-weight.shape[0] // 16) > 65535:
        raise ValueError(f"canvas {tuple(accum.shape)} exceeds the kernel's "
                         "limits")


def _lib():
    global _fn
    if _fn is None:
        from pdac_pathological_image_segmentation_tpu_torch.ops import _build

        fn = _build.load(_SOURCE).pdac_stitch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, p, p] + [i] * 4 + [ll] * 4 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def stitch_tiles_into(accum: torch.Tensor, weight: torch.Tensor,
                      probs: torch.Tensor, coords,
                      blend: str = "hann") -> tuple:
    """Add a chunk of tiles into existing canvases, in place and in tile
    order; returns ``(accum, weight)``.  A window that would cross the
    canvas edge is shifted inside it, as ``lax.dynamic_slice`` clamps.

    ``coords`` (host ints) gives the ``k`` windows to add; ``probs`` may
    hold more rows (a padded batch), which are never read.  CPU canvases
    take :func:`stitch_tiles_into_reference`.  CUDA canvases launch the
    kernel of ``csrc/stitch.cu`` once on the current stream, over the rows
    and columns the windows cover, or raise; the launch neither allocates
    in the kernel nor waits for the card (the origins go up through pinned
    memory, the blend window is cached there).  Each launch adds one to
    ``stitch_tiles_into.launches``."""
    tile = probs.shape[1]
    yx, (y_lo, y_hi, x_lo, x_hi) = clamped_span(coords, tile, weight.shape)
    if accum.device.type == "cpu":
        return stitch_tiles_into_reference(accum, weight, probs, coords,
                                           blend=blend)
    if accum.device.type != "cuda":
        raise ValueError(f"unsupported device {accum.device}")
    k = len(yx)
    _check(accum, weight, probs, k)
    if k == 0:
        return accum, weight
    win = blend_window(tile, blend, accum.device)
    sn, sh, sw = probs.stride()[:3]
    sc = probs.stride(3) if probs.ndim == 4 else 0
    channels = accum.shape[2] if accum.ndim == 3 else 1
    origins = host_to_device(torch.from_numpy(yx), accum.device)
    err = _lib()(
        accum.data_ptr(), weight.data_ptr(), probs.data_ptr(),
        _DTYPES[probs.dtype], win.data_ptr(), origins.data_ptr(), k, tile,
        weight.shape[1], channels, sn, sh, sw, sc, y_lo, y_hi, x_lo, x_hi,
        torch._C._cuda_getCurrentRawStream(accum.device.index))
    if err != 0:
        raise RuntimeError(f"stitch kernel launch failed: cudaError {err}")
    stitch_tiles_into.launches += 1
    return accum, weight


stitch_tiles_into.launches = 0


def finalize_canvas(accum: torch.Tensor, weight: torch.Tensor,
                    threshold: float = 0.5) -> tuple:
    """Blend-normalize and decide: ``(probability map, hard mask)``.
    Binary canvases threshold at ``threshold`` (the reference's 0.5,
    ``test.py:143``); channelled canvases take the argmax over classes.
    Pixels never covered by a tile get probability 0 (class 0)."""
    if accum.ndim == 3:  # (h, w, C) multi-class canvas, 2-D weight
        w = weight.clamp_min(1e-12)[..., None]
        prob = torch.where(weight[..., None] > 0, accum / w, 0.0)
        return prob, prob.argmax(dim=-1).to(torch.uint8)
    prob = torch.where(weight > 0, accum / weight.clamp_min(1e-12), 0.0)
    return prob, (prob >= threshold).to(torch.uint8)

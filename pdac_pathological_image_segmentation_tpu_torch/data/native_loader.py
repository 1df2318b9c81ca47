"""Batch PNG decoding for the trainer's loader (the JAX package's
``data/native_loader.py``): the port's own ctypes binding of the repo-level
``native/pngloader.cpp``.

The C++ decoder inflates and unfilters 8-bit non-interlaced PNGs (gray,
gray+alpha, RGB, RGBA, palette) on a thread pool, without the interpreter
lock, straight into a caller's NHWC uint8 buffer: a pinned host tensor's
memory in ``data/loader.py``, so the batch is copied to the card from where
it was decoded.

The library is compiled with ``g++`` at first use into ``build/native/``
as the TIFF reader is (``data/native_build.py``); it needs zlib's headers
and library, and a failed build raises with the compiler's output.  A file
that cannot be read, is not a PNG, or is of another size than asked,
raises too.  The one per-image PIL path is for PNGs outside the decoder's
scope (16-bit or interlaced), as in the JAX function; it is counted on
``decode_batch.pil_decodes``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from pdac_pathological_image_segmentation_tpu_torch.data import native_build

_SOURCES = ("pngloader.cpp",)

_lib = None
_lib_lock = threading.Lock()

_ERRORS = {0: "ok", 1: "open failed", 2: "not a PNG", 3: "unsupported",
           4: "inflate error", 5: "size mismatch", 6: "corrupt file"}
# outside the C++ decoder's scope (16-bit or interlaced), decoded by PIL as
# the JAX function does
_UNSUPPORTED = 3


def library_path() -> Path:
    """``build/native/libpngloader-<hash>.so`` for the current source."""
    return native_build.library_path("libpngloader", _SOURCES)


def build() -> Path:
    """Compile the decoder unless its library already exists; raises with
    the compiler's output when the build fails (for example without
    ``g++`` or zlib's headers)."""
    return native_build.build("libpngloader", _SOURCES,
                              "the native PNG decoder")


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.decode_png_batch.restype = ctypes.c_int
        lib.decode_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.png_info.restype = ctypes.c_int
        lib.png_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def png_info(path: str) -> Optional[Tuple[int, int]]:
    """``(height, width)`` from a PNG's header, or None when the file
    cannot be opened or is not a PNG."""
    h, w = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = _get_lib().png_info(os.fsencode(path), ctypes.byref(h),
                             ctypes.byref(w))
    return (h.value, w.value) if rc == 0 else None


def _pil_decode_into(path: str, out: np.ndarray) -> None:
    """The JAX function's PIL decode of one image into ``out`` (H, W, C);
    raises when the image does not have ``out``'s shape (a 16-bit or
    interlaced PNG of another size than asked)."""
    from PIL import Image

    with Image.open(path) as img:
        if out.shape[-1] == 3:
            arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
        else:
            arr = np.asarray(img, dtype=np.uint8)
            if arr.ndim == 3:
                arr = arr[..., 0]
            arr = arr[..., None]
    if arr.shape != out.shape:
        raise IOError(f"cannot decode {path}: {arr.shape[:2]} pixels, "
                      f"{out.shape[:2]} asked")
    out[...] = arr


def decode_batch(paths: Sequence[str], height: int, width: int,
                 channels: int, threads: int = 8,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode ``paths`` into an ``(N, height, width, channels)`` uint8 array
    (``out`` when given: C-contiguous, of that shape and dtype) on
    ``threads`` threads.  ``channels`` 3 gives RGB (alpha dropped, palette
    and gray expanded), 1 the first channel.  16-bit and interlaced PNGs go
    through PIL, counted on ``decode_batch.pil_decodes``; any other failure,
    a PNG of another size than asked included, raises ``IOError``."""
    n = len(paths)
    shape = (n, height, width, channels)
    if out is None:
        out = np.empty(shape, dtype=np.uint8)
    if out.shape != shape or out.dtype != np.uint8 \
            or not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError(f"out must be a writable C-contiguous uint8 array "
                         f"of shape {shape}, got {out.shape} {out.dtype}")
    if not n:
        return out
    lib = _get_lib()
    status = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.decode_png_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height, width, channels, max(1, int(threads)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if failures:
        for i in np.flatnonzero(status):
            rc = int(status[i])
            if rc != _UNSUPPORTED:
                raise IOError(f"cannot decode {paths[i]}: "
                              f"{_ERRORS.get(rc, rc)} (native rc={rc})")
            decode_batch.pil_decodes += 1
            _pil_decode_into(paths[i], out[i])
    return out


decode_batch.pil_decodes = 0

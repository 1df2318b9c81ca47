"""Pyramidal-TIFF whole-slide reader (the JAX package's
``data/tiffslide.py``): the port's own ctypes binding of the repo-level
``native/tiffreader.cpp`` + ``native/jpegdec.cpp``, and a WSI tile source.

The C++ reader parses tiled and stripped (Big)TIFF and decodes
deflate/LZW/uncompressed/baseline-JPEG tiles on a thread pool straight into
HWC uint8 buffers.  JPEG tiles with shared tables (the SVS layout) decode in
C++ too; only streams outside its decoder's scope
(arithmetic/lossless/CMYK/12-bit) are decoded per tile by PIL on the host.

The library is compiled with ``g++`` at first use into ``build/native/``
(``data/native_build.py``).  It needs zlib's headers and library: when
they are missing the build fails, and opening a slide raises with the
compiler's message.  There is no Python fallback parser for whole slides.

``TiffSlideSource`` adapts a slide level to the tile-source protocol of
``infer/wsi.py`` (``len``, ``get``, ``tile``, ``canvas_hw``, ``orig_hw``,
``read_region``), so a pyramidal slide streams through
``SlidingWindowInference`` / ``BandedSlidingWindow`` without the level ever
existing in host RAM.
"""

from __future__ import annotations

import ctypes
import io
import os
import re
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from pdac_pathological_image_segmentation_tpu_torch.data import native_build
from pdac_pathological_image_segmentation_tpu_torch.ops.tissue import (
    tissue_mask_np,
)

_SOURCES = ("tiffreader.cpp", "jpegdec.cpp")

_lib = None
_lib_lock = threading.Lock()

_ERRORS = {
    0: "ok", 1: "open failed", 2: "bad magic", 3: "corrupt file",
    4: "unsupported feature", 5: "bad argument", 6: "jpeg tile",
    7: "decode error",
}
_JPEG_TILE = 6


def library_path() -> Path:
    """``build/native/libtiffreader-<hash>.so`` for the current sources."""
    return native_build.library_path("libtiffreader", _SOURCES)


def build() -> Path:
    """Compile the reader unless its library already exists; raises with
    the compiler's output when ``g++`` fails (for example without zlib's
    headers)."""
    return native_build.build("libtiffreader", _SOURCES,
                              "the native TIFF reader")


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.tiff_open.restype = ctypes.c_void_p
        lib.tiff_open.argtypes = [ctypes.c_char_p]
        lib.tiff_close.argtypes = [ctypes.c_void_p]
        lib.tiff_levels.restype = ctypes.c_int32
        lib.tiff_levels.argtypes = [ctypes.c_void_p]
        lib.tiff_level_info.restype = ctypes.c_int32
        lib.tiff_level_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tiff_jpeg_tables.restype = ctypes.c_int32
        lib.tiff_jpeg_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
        ]
        lib.tiff_description.restype = ctypes.c_int64
        lib.tiff_description.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.tiff_tile_raw.restype = ctypes.c_int32
        lib.tiff_tile_raw.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tiff_read_tile.restype = ctypes.c_int32
        lib.tiff_read_tile.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p,
        ]
        lib.tiff_read_region.restype = ctypes.c_int32
        lib.tiff_read_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.jpeg_decode_rgb.restype = ctypes.c_int32
        lib.jpeg_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


class TiffSlide:
    """A pyramidal (Big)TIFF slide.

    ``levels`` are sorted full-resolution-first.  ``read_region`` and
    ``read_tile`` return uint8 RGB arrays; JPEG-compressed tiles decode
    natively (``native/jpegdec.cpp``), with PIL splicing the level's
    JPEGTables as the fallback for out-of-scope streams."""

    def __init__(self, path: str) -> None:
        lib = _get_lib()
        self._lib = lib
        self._h = lib.tiff_open(os.fspath(path).encode())
        if not self._h:
            raise IOError(f"cannot open TIFF slide: {path}")
        self.path = path
        # levels whose JPEG streams the native decoder rejected once —
        # skip the doomed (and wasted) native region attempt thereafter
        self._pil_levels: set = set()
        # PIL-fallback analog of the C reader's decoded-tile LRU
        # (overlapping windows re-touch stored tiles; see tiffreader.cpp)
        self._pil_cache: "dict[tuple, np.ndarray]" = {}
        self._pil_cache_cap = 64
        self._pil_cache_lock = threading.Lock()
        self.level_info: List[dict] = []
        for lv in range(lib.tiff_levels(self._h)):
            info = (ctypes.c_int64 * 8)()
            rc = lib.tiff_level_info(self._h, lv, info)
            if rc:
                raise IOError(f"level_info failed: {_ERRORS.get(rc, rc)}")
            self.level_info.append(dict(
                width=int(info[0]), height=int(info[1]),
                tile_w=int(info[2]), tile_h=int(info[3]),
                compression=int(info[4]),
                tiles_x=int(info[5]), tiles_y=int(info[6]),
                jpeg_tables_len=int(info[7]),
            ))

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tiff_close(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "TiffSlide":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- metadata ----------------------------------------------------------

    @property
    def level_count(self) -> int:
        return len(self.level_info)

    def dimensions(self, level: int = 0) -> Tuple[int, int]:
        """(width, height) of ``level``."""
        i = self.level_info[level]
        return i["width"], i["height"]

    @property
    def description(self) -> str:
        """ImageDescription (tag 270) of the first IFD carrying one —
        Aperio/SVS slides put their scanner metadata here."""
        n = int(self._lib.tiff_description(self._h, None, 0))
        if n <= 0:
            return ""
        buf = ctypes.create_string_buffer(n)
        self._lib.tiff_description(self._h, buf, n)
        return buf.raw[:n].decode("utf-8", "replace")

    @property
    def mpp(self) -> Optional[float]:
        """Microns-per-pixel at level 0, parsed from the ImageDescription
        (the Aperio ``|MPP = 0.2498|`` convention); None when the slide
        doesn't state one (the Groovy exporter's
        ``getAveragedPixelSize()``, ``QuPath_WSI_to_Patch.groovy:16``)."""
        m = re.search(r"MPP\s*=\s*([0-9]*\.?[0-9]+)", self.description)
        return float(m.group(1)) if m else None

    # -- pixel access ------------------------------------------------------

    def _jpeg_tables(self, level: int) -> bytes:
        n = self.level_info[level]["jpeg_tables_len"]
        if not n:
            return b""
        buf = ctypes.create_string_buffer(n)
        rc = self._lib.tiff_jpeg_tables(self._h, level, buf)
        if rc:
            raise IOError(f"jpeg_tables failed: {_ERRORS.get(rc, rc)}")
        return buf.raw

    def _tile_raw(self, level: int, tx: int, ty: int) -> bytes:
        cap = ctypes.c_int64(0)
        rc = self._lib.tiff_tile_raw(self._h, level, tx, ty, None,
                                     ctypes.byref(cap))
        buf = ctypes.create_string_buffer(int(cap.value))
        rc = self._lib.tiff_tile_raw(self._h, level, tx, ty, buf,
                                     ctypes.byref(cap))
        if rc:
            raise IOError(f"tile_raw failed: {_ERRORS.get(rc, rc)}")
        return buf.raw[: cap.value]

    def _decode_jpeg_tile(self, level: int, tx: int, ty: int) -> np.ndarray:
        """PIL fallback for tiles the native decoder hands off: JPEG streams
        outside its scope, and Aperio JPEG2000 (33003/33005) codestreams."""
        from PIL import Image

        key = (level, tx, ty)
        with self._pil_cache_lock:
            cached = self._pil_cache.get(key)
        if cached is not None:
            # writable copy: the native path returns fresh arrays, so the
            # cached master must never be handed out directly
            return cached.copy()

        info = self.level_info[level]
        data = self._tile_raw(level, tx, ty)
        if info["compression"] == 7:
            tables = self._jpeg_tables(level)
            if tables:
                # abbreviated JPEG: tables stream is SOI..tables..EOI, the
                # tile stream is SOI..scan..EOI — splice the tables after
                # the tile's SOI
                body = (tables[2:-2] if tables[-2:] == b"\xff\xd9"
                        else tables[2:])
                data = data[:2] + body + data[2:]
        img = Image.open(io.BytesIO(data)).convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
        th, tw = info["tile_h"], info["tile_w"]
        out = np.zeros((th, tw, 3), np.uint8)
        out[: arr.shape[0], : arr.shape[1]] = arr[:th, :tw]
        out.setflags(write=False)  # cached master: callers get copies
        with self._pil_cache_lock:
            if len(self._pil_cache) >= self._pil_cache_cap:
                # FIFO evict; pop(..., None) so two threads racing on the
                # same first key can't raise
                self._pil_cache.pop(next(iter(self._pil_cache)), None)
            self._pil_cache[key] = out
        return out.copy()

    def read_tile(self, level: int, tx: int, ty: int) -> np.ndarray:
        """One stored tile as (tile_h, tile_w, 3) uint8 (edge tiles are
        zero-padded to full tile size, as stored in the file)."""
        info = self.level_info[level]
        out = np.empty((info["tile_h"], info["tile_w"], 3), np.uint8)
        rc = self._lib.tiff_read_tile(
            self._h, level, tx, ty,
            out.ctypes.data_as(ctypes.c_char_p),
        )
        if rc == _JPEG_TILE:
            return self._decode_jpeg_tile(level, tx, ty)
        if rc:
            raise IOError(f"read_tile failed: {_ERRORS.get(rc, rc)}")
        return out

    def read_region(self, level: int, x: int, y: int, w: int,
                    h: int) -> np.ndarray:
        """Arbitrary (x, y, w, h) region of ``level`` as (h, w, 3) uint8,
        zero-filled outside the image."""
        info = self.level_info[level]
        rc = _JPEG_TILE
        if level not in self._pil_levels:
            out = np.empty((h, w, 3), np.uint8)
            rc = self._lib.tiff_read_region(
                self._h, level, x, y, w, h,
                out.ctypes.data_as(ctypes.c_char_p),
            )
        if rc == _JPEG_TILE:
            self._pil_levels.add(level)
            # a JPEG stream outside the native decoder's scope
            # (arithmetic/lossless/CMYK/12-bit): assemble tile-by-tile, each tile
            # preferring native and falling back to PIL individually
            out = np.zeros((h, w, 3), np.uint8)
            tw, th = info["tile_w"], info["tile_h"]
            for ty in range(max(0, y // th),
                            min(info["tiles_y"], -(-(y + h) // th))):
                for tx in range(max(0, x // tw),
                                min(info["tiles_x"], -(-(x + w) // tw))):
                    tile = self.read_tile(level, tx, ty)
                    sx0, sy0 = max(x, tx * tw), max(y, ty * th)
                    sx1 = min(x + w, (tx + 1) * tw)
                    sy1 = min(y + h, (ty + 1) * th, info["height"])
                    if sx1 <= sx0 or sy1 <= sy0:
                        continue
                    out[sy0 - y:sy1 - y, sx0 - x:sx1 - x] = \
                        tile[sy0 - ty * th:sy1 - ty * th,
                             sx0 - tx * tw:sx1 - tx * tw]
            return out
        if rc:
            raise IOError(f"read_region failed: {_ERRORS.get(rc, rc)}")
        return out

    def level_for_downsample(self, downsample: float) -> int:
        """Largest level whose downsample factor is ≤ ``downsample``."""
        w0 = self.level_info[0]["width"]
        best = 0
        for lv, i in enumerate(self.level_info):
            if w0 / i["width"] <= downsample + 1e-9:
                best = lv
        return best


class TiffSlideSource:
    """Tile source over one level of a :class:`TiffSlide` — the streaming,
    on-disk analog of ``infer/wsi.GridTiler``.

    Implements the tile-source protocol consumed by
    ``SlidingWindowInference`` / ``BandedSlidingWindow`` (``len``, ``get(i) → (tile_u8, (y, x))``,
    ``tile``, ``canvas_hw``, ``orig_hw``): overlapping ``tile``×``tile``
    windows at ``stride``, fetched per ``get`` via ``read_region`` (windows
    may straddle stored tiles; edge windows shift inward like GridTiler).
    Host memory stays O(tile) — the level is never materialized.

    ``tissue_threshold > 0`` drops background windows using the slide's own
    **pyramid**: the tissue mask is computed once on a ≤``thumb_max``-wide
    pyramid level and each window's tissue fraction is read off that
    thumbnail — O(thumbnail) work instead of decoding the full level twice
    (the production version of GridTiler's full-res filter)."""

    def __init__(self, slide: TiffSlide, level: int = 0, tile: int = 512,
                 stride: Optional[int] = None,
                 tissue_threshold: float = 0.0,
                 thumb_max: int = 2048) -> None:
        self.slide = slide
        self.level = level
        self.tile = tile
        self.stride = stride or tile
        w, h = slide.dimensions(level)
        self.orig_hw = (h, w)
        # slides smaller than one tile are served zero-padded by read_region;
        # the canvas matches GridTiler's edge-padded contract
        ch, cw = max(h, tile), max(w, tile)
        self.canvas_hw = (ch, cw)

        def starts(extent: int) -> List[int]:
            if extent <= tile:
                return [0]
            xs = list(range(0, extent - tile + 1, self.stride))
            if xs[-1] != extent - tile:
                xs.append(extent - tile)
            return xs

        self.coords: List[Tuple[int, int]] = [
            (y, x) for y in starts(ch) for x in starts(cw)
        ]
        self.skipped = 0
        if tissue_threshold > 0.0:
            self._filter_by_thumbnail(tissue_threshold, thumb_max)

    def _filter_by_thumbnail(self, threshold: float, thumb_max: int) -> None:
        # level_for_downsample measures relative to level 0, so the target
        # downsample must too — using the source level's width here would pick
        # a thumbnail wider than thumb_max whenever self.level > 0.
        full_w = self.slide.dimensions(0)[0]
        tl = self.slide.level_for_downsample(max(1.0, full_w / thumb_max))
        tw, th = self.slide.dimensions(tl)
        thumb = self.slide.read_region(tl, 0, 0, tw, th)
        mask = tissue_mask_np(thumb)  # (th, tw) bool
        sy, sx = th / max(1, self.canvas_hw[0]), tw / max(1, self.canvas_hw[1])
        kept = []
        for (y, x) in self.coords:
            y0, y1 = int(y * sy), max(int(y * sy) + 1, int((y + self.tile) * sy))
            x0, x1 = int(x * sx), max(int(x * sx) + 1, int((x + self.tile) * sx))
            frac = float(mask[y0:y1, x0:x1].mean()) if mask.size else 0.0
            if frac >= threshold:
                kept.append((y, x))
            else:
                self.skipped += 1
        self.coords = kept

    def __len__(self) -> int:
        return len(self.coords)

    def get(self, i: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        y, x = self.coords[i]
        return (
            self.slide.read_region(self.level, x, y, self.tile, self.tile),
            (y, x),
        )

    def read_region(self, y: int, x: int, h: int, w: int) -> np.ndarray:
        """(h, w, 3) uint8 region at pixel (y, x) of this source's level,
        zero-filled outside — the band-input read used by
        ``BandedSlidingWindow`` (each stored slide tile decodes once per
        band instead of once per overlapping window)."""
        return self.slide.read_region(self.level, x, y, w, h)

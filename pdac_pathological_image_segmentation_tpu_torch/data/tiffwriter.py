"""Pure-Python tiled pyramidal-TIFF writer (the port's own copy of the JAX
package's ``data/tiffwriter.py``; it writes the same bytes).

Two jobs:

* **export**: write segmentation probability/label maps (and thumbnails) as
  pyramidal tiled TIFFs that QuPath/openslide/ImageJ can open — the
  downstream half of the reference's QuPath workflow (SURVEY.md C14: tiles
  go QuPath → model; results here go model → QuPath);
* **fixtures**: generate real tiled/BigTIFF files to pin the native reader
  (``native/tiffreader.cpp``) against in tests without shipping binary
  fixtures.

Writes classic TIFF (magic 42) or BigTIFF (magic 43), tile-organized,
8-bit, RGB or grayscale, compression none/deflate, optional horizontal-
differencing predictor, pyramid as a chain of full IFDs (level 0 first,
each next level 2× downsampled until ``min_size``) — the layout
libvips/openslide expect.  Little-endian only (the universal default).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

# TIFF tags
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_SAMPLES_PER_PIXEL = 277
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_IMAGE_DESCRIPTION = 270
# field types
_ASCII, _SHORT, _LONG, _LONG8 = 2, 3, 4, 16


def _tile_bytes(img: np.ndarray, x: int, y: int, tile: int,
                compression: int, predictor: int) -> bytes:
    h, w = img.shape[:2]
    spp = img.shape[2]
    block = np.zeros((tile, tile, spp), np.uint8)
    ys, xs = min(tile, h - y), min(tile, w - x)
    block[:ys, :xs] = img[y:y + ys, x:x + xs]
    if predictor == 2:
        block = block.astype(np.int16)
        block[:, 1:, :] -= block[:, :-1, :]
        block = block.astype(np.uint8)
    raw = block.tobytes()
    if compression == 8:
        return zlib.compress(raw, 6)
    return raw


def _pack_value(type_: int, values) -> bytes:
    if type_ == _ASCII:
        return bytes(values)  # NUL-terminated by the caller
    fmt = {_SHORT: "H", _LONG: "I", _LONG8: "Q"}[type_]
    return struct.pack("<" + fmt * len(values), *values)


class _IfdBuilder:
    """Accumulates (tag, type, values) entries for one IFD."""

    def __init__(self) -> None:
        self.entries: List[Tuple[int, int, List[int]]] = []

    def add(self, tag: int, type_: int, values) -> None:
        if type_ != _ASCII:
            values = list(values)
        self.entries.append((tag, type_, values))

    def serialize(self, ifd_off: int, big: bool
                  ) -> Tuple[bytes, bytes, int, int]:
        """Returns (ifd_bytes_without_next, overflow_bytes, next_ptr_pos,
        overflow_base).  Overflow data (values too big to inline) is placed
        immediately after the IFD."""
        self.entries.sort(key=lambda e: e[0])
        esz = 20 if big else 12
        cnt_w = 8 if big else 2
        inline_cap = 8 if big else 4
        n = len(self.entries)
        overflow_base = ifd_off + cnt_w + n * esz + (8 if big else 4)

        body = bytearray()
        overflow = bytearray()
        body += struct.pack("<Q" if big else "<H", n)
        for tag, type_, values in self.entries:
            data = _pack_value(type_, values)
            body += struct.pack("<HH", tag, type_)
            body += struct.pack("<Q" if big else "<I", len(values))
            if len(data) <= inline_cap:
                body += data + b"\0" * (inline_cap - len(data))
            else:
                off = overflow_base + len(overflow)
                body += struct.pack("<Q" if big else "<I", off)
                overflow += data
        next_ptr_pos = ifd_off + len(body)
        body += b"\0" * (8 if big else 4)  # next-IFD pointer placeholder
        return bytes(body), bytes(overflow), next_ptr_pos, overflow_base


def write_tiff(path: str, image: np.ndarray, *, tile: int = 256,
               compression: str = "deflate", predictor: bool = False,
               pyramid: bool = True, min_size: int = 256,
               big: bool = False,
               description: Optional[str] = None) -> List[Tuple[int, int]]:
    """Write ``image`` (H×W×3 RGB or H×W grayscale uint8) as a tiled
    (optionally pyramidal) TIFF.  Returns the (width, height) of every
    level written."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError("uint8 images only")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] not in (1, 3):
        raise ValueError("1 or 3 channels only")
    comp_code = {"none": 1, "deflate": 8}[compression]
    pred_code = 2 if predictor else 1

    # build pyramid levels (2× box-filter downsample)
    levels = [img]
    while pyramid and max(levels[-1].shape[:2]) // 2 >= min_size:
        prev = levels[-1]
        h2, w2 = prev.shape[0] // 2, prev.shape[1] // 2
        ds = prev[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, prev.shape[2])
        levels.append(
            (ds.astype(np.uint16).sum(axis=(1, 3)) // 4).astype(np.uint8)
        )

    with open(path, "wb") as f:
        if big:
            f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16))
        else:
            f.write(struct.pack("<2sHI", b"II", 42, 8))
        prev_next_ptr: Optional[int] = None
        first = True

        for lv_img in levels:
            h, w = lv_img.shape[:2]
            spp = lv_img.shape[2]
            tiles_x = -(-w // tile)
            tiles_y = -(-h // tile)

            # write tile data first
            data_off = f.tell()
            offsets, counts = [], []
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    tb = _tile_bytes(lv_img, tx * tile, ty * tile, tile,
                                     comp_code, pred_code)
                    offsets.append(f.tell())
                    counts.append(len(tb))
                    f.write(tb)
            if f.tell() % 2:
                f.write(b"\0")  # word-align the IFD

            off_type = _LONG8 if big else _LONG
            b = _IfdBuilder()
            b.add(_IMAGE_WIDTH, _LONG, [w])
            b.add(_IMAGE_LENGTH, _LONG, [h])
            b.add(_BITS_PER_SAMPLE, _SHORT, [8] * spp)
            b.add(_COMPRESSION, _SHORT, [comp_code])
            b.add(_PHOTOMETRIC, _SHORT, [2 if spp == 3 else 1])
            b.add(_SAMPLES_PER_PIXEL, _SHORT, [spp])
            b.add(_PLANAR_CONFIG, _SHORT, [1])
            if pred_code == 2:
                b.add(_PREDICTOR, _SHORT, [pred_code])
            if description is not None and lv_img is levels[0]:
                b.add(_IMAGE_DESCRIPTION, _ASCII,
                      description.encode() + b"\0")
            b.add(_TILE_WIDTH, _SHORT, [tile])
            b.add(_TILE_LENGTH, _SHORT, [tile])
            b.add(_TILE_OFFSETS, off_type, offsets)
            b.add(_TILE_BYTE_COUNTS, off_type, counts)

            ifd_off = f.tell()
            body, overflow, next_ptr_pos, _ = b.serialize(ifd_off, big)
            f.write(body)
            f.write(overflow)
            end = f.tell()

            # link from header / previous IFD
            ptr_bytes = struct.pack("<Q" if big else "<I", ifd_off)
            if first:
                f.seek(8 if big else 4)
                f.write(ptr_bytes)
                first = False
            else:
                assert prev_next_ptr is not None
                f.seek(prev_next_ptr)
                f.write(ptr_bytes)
            prev_next_ptr = next_ptr_pos
            f.seek(end)

    return [(lv.shape[1], lv.shape[0]) for lv in levels]


def write_probability_tiff(path: str, probs: np.ndarray, *, tile: int = 256,
                           threshold: Optional[float] = None,
                           **kw) -> List[Tuple[int, int]]:
    """Export a float probability map (H×W, 0..1) as a grayscale pyramidal
    TIFF (probability × 255), or a binary mask TIFF if ``threshold`` is
    given — the artifact QuPath imports back over the slide."""
    p = np.asarray(probs)
    if threshold is not None:
        img = ((p >= threshold) * 255).astype(np.uint8)
    else:
        img = np.clip(np.round(p * 255.0), 0, 255).astype(np.uint8)
    return write_tiff(path, img, tile=tile, **kw)

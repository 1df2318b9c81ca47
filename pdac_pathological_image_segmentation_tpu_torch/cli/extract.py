"""WSI → training-patch extraction (the JAX package's ``cli/extract.py``):
the in-repo replacement for the reference's QuPath Groovy exporter
(``QuPath_WSI_to_Patch.groovy``).  Host work: the port's native slide
reader (``data/tiffslide.py``) and polygon rasterizer
(``data/geojson.py``), no device.

The reference produces its training data by running a Groovy script
inside the QuPath desktop app: a ``LabeledImageServer`` rasterizes the
project's annotation objects (``addLabel('Tumor', 1)``, background 0)
and a ``TileExporter`` writes paired 512×512 PNG tiles at 0.5 µm/px
(``QuPath_WSI_to_Patch.groovy:13-34``).  This CLI does the same job
headlessly from a slide file plus the annotations exported from QuPath
as GeoJSON (*File → Export objects as GeoJSON* — QuPath's native object
format), using the in-repo native slide reader and polygon rasterizer:

    python -m pdac_pathological_image_segmentation_tpu_torch.cli.extract \
        --slide case01.svs --annotations case01.geojson --out patches/

Output follows the QuPath TileExporter layout the reference's path
discovery expects (``train_main.py:52-56``): ``{name} [d=…,x=…,y=…,w=…,
h=…].png`` image tiles paired with ``…-labelled.png`` label tiles.

Groovy-parity knobs: ``--pixel_size`` (0.5), ``--tile`` (512),
``--overlap`` (0), ``--annotated_only`` (false), repeatable
``--label Name=value`` ("the order matters" — later labels overwrite
earlier, reproduced by ``rasterize_shapes``).  The downsample is
``pixel_size / slide_mpp`` (Groovy line 16); the slide's µm/px is read
from its Aperio ImageDescription (``TiffSlide.mpp``) or given with
``--slide_mpp``.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np


def _parse_labels(items: List[str]) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for it in items:
        if "=" not in it:
            raise SystemExit(f"--label expects Name=value, got {it!r}")
        name, val = it.rsplit("=", 1)
        try:
            out.append((name, int(val)))
        except ValueError:
            raise SystemExit(f"--label value must be an integer: {it!r}")
    return out


def _format_name(base: str, d: float, x: int, y: int, w: int, h: int) -> str:
    ds = f"{d:g}"
    return f"{base} [d={ds},x={x},y={y},w={w},h={h}]"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="WSI -> paired training patches "
        "(QuPath_WSI_to_Patch.groovy, headless)")
    parser.add_argument("--slide", required=True,
                        help="pyramidal TIFF/SVS slide")
    parser.add_argument("--annotations", default=None,
                        help="QuPath GeoJSON annotation export; omitted = "
                        "all-background labels (the Groovy exporter also "
                        "writes label tiles for unannotated area)")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--pixel_size", type=float, default=0.5,
                        help="export resolution in um/px "
                        "(QuPath_WSI_to_Patch.groovy:13)")
    parser.add_argument("--slide_mpp", type=float, default=None,
                        help="level-0 um/px override when the slide's "
                        "metadata lacks an MPP entry")
    parser.add_argument("--downsample", type=float, default=None,
                        help="explicit downsample factor (bypasses the "
                        "pixel-size/MPP computation)")
    parser.add_argument("--tile", type=int, default=512,
                        help="tile size in export pixels (Groovy:30)")
    parser.add_argument("--overlap", type=int, default=0,
                        help="tile overlap in export pixels (Groovy:33)")
    parser.add_argument("--annotated_only", action="store_true",
                        help="skip tiles whose label mask is empty "
                        "(Groovy:32, default false)")
    parser.add_argument("--label", action="append", default=[],
                        help="Name=value classification->label mapping, "
                        "repeatable, order matters (Groovy:22); default "
                        "Tumor=1")
    parser.add_argument("--default_label", type=int, default=None,
                        help="label for annotations whose classification "
                        "is not in the --label table (default: skip them)")
    parser.add_argument("--name", default=None,
                        help="base name for tiles (default: slide stem)")
    parser.add_argument("--include_partial", action="store_true",
                        help="also export zero-padded edge tiles (QuPath "
                        "TileExporter skips partial tiles by default)")
    parser.add_argument("--workers", type=int, default=None,
                        help="decode/write threads (default: cpu count)")
    args = parser.parse_args(argv)

    from PIL import Image

    from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
        parse_geojson,
        rasterize_shapes,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.tiffslide import (
        TiffSlide,
    )

    labels = _parse_labels(args.label) or [("Tumor", 1)]
    label_map = dict(labels)

    shapes = []
    if args.annotations:
        # default_label passed as given: parse_geojson's own default (1)
        # would make unlabeled annotations tumor
        shapes = parse_geojson(args.annotations, label_map=label_map,
                               default_label=args.default_label)
        if not shapes and args.annotated_only:
            raise SystemExit(
                "no annotations matched the --label table; nothing to "
                "export under --annotated_only")

    slide = TiffSlide(args.slide)
    w0, h0 = slide.dimensions(0)
    if args.downsample is not None:
        downsample = args.downsample
    else:
        mpp = args.slide_mpp if args.slide_mpp is not None else slide.mpp
        if mpp is None:
            raise SystemExit(
                "slide metadata has no MPP entry; pass --slide_mpp "
                "(level-0 um/px) or --downsample")
        # Groovy:16 — requestedPixelSize / averagedPixelSize
        downsample = args.pixel_size / mpp
    if downsample < 1.0:
        raise SystemExit(
            f"downsample {downsample:.3f} < 1 would upsample the slide "
            f"(pixel_size below the scan resolution)")

    # read from the deepest pyramid level still at or above the export
    # resolution, then resize the residual factor
    lv = slide.level_for_downsample(downsample)
    lw, lh = slide.dimensions(lv)
    lv_down = w0 / lw  # level downsample vs level 0

    tile, overlap = args.tile, args.overlap
    if overlap >= tile:
        raise SystemExit("--overlap must be smaller than --tile")
    step = tile - overlap
    # export-resolution canvas size; partial edge tiles (zero-padded by
    # read_region) only under --include_partial, like QuPath's TileExporter
    ew, eh = int(w0 / downsample), int(h0 / downsample)
    limit_w = ew if args.include_partial else ew - tile + 1
    limit_h = eh if args.include_partial else eh - tile + 1
    xs = list(range(0, max(limit_w, 0), step))
    ys = list(range(0, max(limit_h, 0), step))

    os.makedirs(args.out, exist_ok=True)
    base = args.name or os.path.splitext(os.path.basename(args.slide))[0]

    def export_one(ex: int, ey: int) -> bool:
        # level-0 window of this tile
        x0 = int(round(ex * downsample))
        y0 = int(round(ey * downsample))
        w_l0 = int(round(tile * downsample))
        h_l0 = int(round(tile * downsample))
        # source-level window
        sx = int(x0 / lv_down)
        sy = int(y0 / lv_down)
        sw = max(1, int(round(w_l0 / lv_down)))
        sh = max(1, int(round(h_l0 / lv_down)))
        region = slide.read_region(lv, sx, sy, sw, sh)
        if (sw, sh) != (tile, tile):
            region = np.asarray(
                Image.fromarray(region).resize((tile, tile),
                                               Image.BILINEAR))
        # label mask rasterized directly at export resolution — the
        # LabeledImageServer renders at the requested downsample rather
        # than resizing (QuPath_WSI_to_Patch.groovy:19-24)
        mask = rasterize_shapes(shapes, tile, tile, scale=downsample,
                                offset=(float(x0), float(y0)))
        if args.annotated_only and not mask.any():
            return False
        stem = _format_name(base, downsample, x0, y0, w_l0, h_l0)
        Image.fromarray(region).save(os.path.join(args.out, stem + ".png"))
        Image.fromarray(mask).save(
            os.path.join(args.out, stem + "-labelled.png"))
        return True

    coords = [(ex, ey) for ey in ys for ex in xs]
    workers = args.workers or min(8, os.cpu_count() or 1)
    try:
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            written = sum(pool.map(lambda c: export_one(*c), coords))
    finally:
        slide.close()

    print(f"extracted {written}/{len(coords)} tile pairs at "
          f"downsample {downsample:g} (level {lv}) -> {args.out}")
    return {"written": int(written), "total": len(coords),
            "downsample": downsample, "level": lv, "out": args.out}


if __name__ == "__main__":
    main()

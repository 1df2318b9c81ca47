"""WSI overlay CLI (the JAX package's ``cli/overlay.py``), the runnable
replacement for the reference's missing ``visualize/predict_overlay.ipynb``:

    python -m pdac_pathological_image_segmentation_tpu_torch.cli.overlay \\
        --config cfg.yaml --save_path runs/overlay --pth_path runs/fpn/pth \\
        [--slide slide.tiff] [--banded] [--tta [--uncertainty]] \\
        [--geojson] [--export_tiff] [--device cpu]

It predicts every kept PyHIST tile of the config's ``visualize_config.yaml``
schema (``tile_path``/``tsv_path``), or every window of a pyramidal TIFF
(``--slide``), stitches the probability map on the device and writes
``probability_map.npy``, ``overlay.png`` (a red tumor overlay over a slide
thumbnail) and, on request, ``uncertainty_map.npy``,
``probability_map.tiff`` and ``annotations.geojson``.  It runs on the card
(``--device cuda``, the default) and raises when there is none unless
``--device cpu`` is passed.  ``--int8`` serves the checkpoint's model on
the int8 path (``infer/quantized.py``; unet/fpn/deeplabv3+/pspnet on
resnet18), calibrated on the first 16 tiles that pass the tissue filter;
it composes with ``--banded``, ``--sharded`` and ``--tta``.  ``--sharded``
stitches in bands over ``create_mesh(num_devices)`` (every visible card by
default; ``[cpu] * num_devices`` under ``--device cpu``) with the halo
exchanged between bands (``infer/wsi_sharded.py``); with ``--band_h`` it
takes rolled mode.  As in the JAX CLI, ``--sharded`` refuses ``--artifact``
and ``--banded``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch import (
    load_config,
    resolve_device,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
    BandedSlidingWindow,
    PyHISTTileSource,
    SlidingWindowInference,
    overlay_figure,
)

def _load_thumbnail(path: str, max_dim: int = 2048) -> np.ndarray | None:
    """A slide rendering at most ``max_dim`` wide: the coarsest pyramid
    level the native reader finds at or above that size (reduced by PIL if
    it is still larger), else PIL's own thumbnail; None, with a warning,
    when neither reads the file."""
    from PIL import Image

    try:
        if path.lower().endswith((".svs", ".tif", ".tiff", ".ndpi")):
            try:
                from pdac_pathological_image_segmentation_tpu_torch.data.tiffslide import (
                    TiffSlide,
                )

                with TiffSlide(path) as s:
                    w0, _ = s.dimensions(0)
                    lv = s.level_for_downsample(max(1.0, w0 / max_dim))
                    w, h = s.dimensions(lv)
                    thumb = s.read_region(lv, 0, 0, w, h)
                if max(thumb.shape[:2]) <= max_dim:
                    return thumb
                img = Image.fromarray(thumb)
            except Exception:
                img = Image.open(path).convert("RGB")
        else:
            img = Image.open(path).convert("RGB")
        img.thumbnail((max_dim, max_dim))
        return np.asarray(img, dtype=np.uint8)
    except Exception as e:
        print(f"warning: could not load slide thumbnail ({e}); "
              "rendering mask only")
        return None


def _to_device(obj, device):
    """A state dict or an int8 bundle with every tensor on ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="pathology_project overlay")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--pth_path", default=None,
                        help="checkpoint (required unless --artifact)")
    parser.add_argument("--artifact", default=None,
                        help="serve from an exported port artifact "
                        "(cli/export.py) instead of a checkpoint; composes "
                        "with --banded/--tta/--slide")
    parser.add_argument("--tta", action="store_true",
                        help="dihedral-8 test-time augmentation")
    parser.add_argument("--uncertainty", action="store_true",
                        help="with --tta: also export the per-pixel TTA "
                        "disagreement map (variance across the 8 dihedral "
                        "predictions, overlap-blended) as "
                        "uncertainty_map.npy — zero extra forward passes")
    parser.add_argument("--blend", default="uniform",
                        choices=("uniform", "hann", "pyramid"),
                        help="overlap blend window (PyHIST tiles don't "
                        "overlap → uniform reproduces the reference paste)")
    parser.add_argument("--sharded", action="store_true",
                        help="band-sharded stitching over the config's "
                        "num_devices (every visible card by default), the "
                        "halo exchanged between bands; with --band_h, "
                        "rolled bands")
    parser.add_argument("--banded", action="store_true",
                        help="O(band)-memory runner for slides whose canvas "
                        "exceeds device memory; uploads each band's pixels "
                        "once and cuts the windows out on the device when "
                        "the source supports region reads (--slide does)")
    parser.add_argument("--band_h", type=int, default=None,
                        help="band height in rows for --banded "
                        "(default 4096); with --sharded, rolled mode with "
                        "this roll height")
    parser.add_argument("--slide", default=None,
                        help="run directly on a pyramidal TIFF/SVS slide "
                        "(native tiled reader, streaming O(tile) host "
                        "memory) instead of the PyHIST tile directory")
    parser.add_argument("--stride", type=int, default=None,
                        help="window stride for --slide mode (default: "
                        "img_size, i.e. no overlap)")
    parser.add_argument("--level", type=int, default=0,
                        help="pyramid level for --slide mode (0 = full "
                        "resolution)")
    parser.add_argument("--export_tiff", action="store_true",
                        help="also export the probability map as a "
                        "pyramidal tiled TIFF QuPath can overlay")
    parser.add_argument("--geojson", action="store_true",
                        help="also export the predicted tumor regions as "
                        "QuPath-importable GeoJSON annotation polygons "
                        "(File > Import objects); coordinates are level-0 "
                        "pixels when --slide is used")
    parser.add_argument("--geojson_min_area", type=float, default=0.0,
                        help="drop polygons below this area "
                        "(level-0 px^2)")
    parser.add_argument("--geojson_simplify", type=float, default=0.0,
                        help="Douglas-Peucker tolerance in level-0 px "
                        "(0 = exact pixel boundaries)")
    parser.add_argument("--min_region", type=float, default=0.0,
                        help="post-process: drop predicted regions below "
                        "this area (px^2 at the inference resolution) "
                        "before rendering/exporting the mask")
    parser.add_argument("--fill_holes", type=float, default=0.0,
                        help="post-process: fill holes inside predicted "
                        "regions below this area (px^2); use a huge value "
                        "to fill all holes")
    parser.add_argument("--geojson_class", default="Tumor",
                        help="classification name for the exported "
                        "annotations (QuPath_WSI_to_Patch.groovy:22)")
    parser.add_argument("--threshold", default="0.5",
                        help="tumor probability threshold for every "
                        "mask-derived output (overlay, geojson, tumor "
                        "fraction): a float, or 'auto' to calibrate the "
                        "Dice-optimal threshold on the config's val split "
                        "via the 257-point sweep (needs --pth_path and "
                        "val_path)")
    parser.add_argument("--int8", action="store_true",
                        help="serve on the int8 quantized path (calibrated "
                        "on the first 16 tissue tiles)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    os.makedirs(args.save_path, exist_ok=True)

    multiclass = cfg.num_classes > 1
    if multiclass:
        # multi-class slides stitch per-class softmax canvases and the mask
        # is the argmax class map — surfaces that assume one sigmoid canvas
        # are rejected up front (SlidingWindowInference carries the C axis)
        for flag, name in ((args.sharded, "--sharded"),
                           (args.banded, "--banded"),
                           (args.artifact, "--artifact"),
                           (args.export_tiff, "--export_tiff")):
            if flag:
                raise SystemExit(f"{name} is binary-only (num_classes="
                                 f"{cfg.num_classes} in the config)")
        if args.threshold != "0.5":
            raise SystemExit("--threshold applies to binary sigmoid masks; "
                             "multi-class masks are the per-pixel argmax")
    if args.artifact and args.sharded:
        raise SystemExit("--artifact does not compose with --sharded "
                         "(the sharded runner builds its step per device); "
                         "use --banded")
    if args.sharded and args.banded:
        raise SystemExit("--sharded and --banded are mutually exclusive "
                         "(the sharded runner is already banded per device)")
    if not args.artifact and not args.pth_path:
        raise SystemExit("one of --pth_path or --artifact is required")
    if args.int8 and args.artifact:
        raise SystemExit("--int8 quantizes the checkpoint's model; an "
                         "--artifact is already exported (cli.export --int8 "
                         "writes an int8 one)")
    if args.uncertainty and not args.tta:
        raise SystemExit("--uncertainty needs --tta (it is the variance "
                         "across the 8 TTA predictions)")

    evaluator = None
    if not args.artifact:
        from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
            Evaluator,
        )

        evaluator = Evaluator(cfg, args.pth_path, device=device)

    if args.threshold == "auto":
        if evaluator is None:
            raise SystemExit("--threshold auto calibrates on the val split "
                             "through the checkpointed model — it needs "
                             "--pth_path, not --artifact")
        if not cfg.val_path:
            raise SystemExit("--threshold auto needs val_path in the config")
        from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
            discover_split,
        )
        from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
            PatchDataset,
        )

        cal = evaluator.run(PatchDataset(*discover_split(cfg.val_path), cfg),
                            verbose=False)
        if "best_threshold" not in cal:
            raise SystemExit("--threshold auto needs a binary objective "
                             "(the sweep is sigmoid-threshold calibration)")
        threshold = float(cal["best_threshold"])
        print(f"calibrated threshold {threshold:.6f} on "
              f"{cal['n_samples']} val patches "
              f"(val dice {cal['best_dice']:.4f} vs "
              f"{cal['dice_at_0.5']:.4f} at 0.5)")
    else:
        threshold = float(args.threshold)
        if not 0.0 <= threshold <= 1.0:
            raise SystemExit(f"--threshold must be in [0, 1], "
                             f"got {threshold}")
    if args.slide:
        from pdac_pathological_image_segmentation_tpu_torch.data.tiffslide import (
            TiffSlide,
            TiffSlideSource,
        )

        slide = TiffSlide(args.slide)
        if not 0 <= args.level < slide.level_count:
            raise SystemExit(
                f"--level {args.level} out of range: slide has "
                f"{slide.level_count} pyramid level(s)")
        source = TiffSlideSource(
            slide, level=args.level, tile=cfg.img_size, stride=args.stride,
            tissue_threshold=cfg.tissue_threshold,
        )
    else:
        source = PyHISTTileSource(cfg.tile_path, cfg.tsv_path,
                                  tile=cfg.img_size,
                                  tissue_threshold=cfg.tissue_threshold,
                                  num_workers=cfg.num_worker)
    infer_step = None
    if args.artifact:
        from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
            load_serving_artifact,
        )

        art = load_serving_artifact(args.artifact, device=device)
        if art.tile != cfg.img_size:
            raise SystemExit(
                f"artifact serves {art.tile}x{art.tile} tiles but "
                f"cfg.img_size is {cfg.img_size}")
        # the device step: probabilities stay on the card for stitching
        infer_step = art.step

    if args.int8:
        from pdac_pathological_image_segmentation_tpu_torch.infer import (
            quantized as q,
        )

        if cfg.model not in q.FORWARDS:
            raise SystemExit(
                f"--int8 supports models {sorted(q.FORWARDS)}, "
                f"got {cfg.model!r}")
        if cfg.backbone != "resnet18":
            raise SystemExit(
                f"--int8 supports backbone resnet18, got {cfg.backbone!r}")
        if len(source) == 0:
            raise SystemExit(
                "no tiles passed the tissue filter — cannot calibrate "
                "int8 (try a lower tissue_threshold or a finer --level)")
        calib = np.stack([source.get(i)[0]
                          for i in range(min(len(source), 16))])
        sd = evaluator.model.state_dict()
        # config-driven: DeepLabV3+'s rates and cfg.stain, as the float path
        bundle, forward = q.quantize_from_config(cfg, sd, [calib])
        infer_step = q.make_quantized_infer_step(sd, bundle, cfg.img_size,
                                                 forward=forward)
    devices = None
    if args.sharded:
        from pdac_pathological_image_segmentation_tpu_torch.parallel.mesh import (
            create_mesh,
        )

        devices = create_mesh(cfg.num_devices, device=device)
        if args.int8:
            # the int8 step on each device, its weights copied there
            infer_step = {dev: q.make_quantized_infer_step(
                _to_device(sd, dev), _to_device(bundle, dev), cfg.img_size,
                forward=forward) for dev in dict.fromkeys(devices)}

    # under --artifact the runners never touch a model: the artifact's step
    # (weights loaded) is the infer_step
    model = evaluator.model if evaluator else None
    common = dict(tile=cfg.img_size, batch_size=max(cfg.batch_size, 8),
                  tta=args.tta, blend=args.blend, num_workers=cfg.num_worker,
                  stain=cfg.stain, infer_step=infer_step,
                  uncertainty=args.uncertainty, device=device)
    if args.sharded:
        from pdac_pathological_image_segmentation_tpu_torch.infer.wsi_sharded import (
            ShardedSlidingWindow,
        )

        runner = ShardedSlidingWindow(
            model, devices, tile=cfg.img_size,
            batch_per_device=max(1, max(cfg.batch_size, 8) // len(devices)),
            tta=args.tta, blend=args.blend, stain=cfg.stain,
            infer_step=infer_step, uncertainty=args.uncertainty,
            roll_h=args.band_h)
    elif args.banded:
        runner = BandedSlidingWindow(model, band_h=args.band_h, **common)
    else:
        runner = SlidingWindowInference(model, **common)
    out_maps = runner.run(source)
    prob, mask = out_maps[0], out_maps[1]
    if threshold != 0.5 and not multiclass:
        # runners threshold the blended probability map at the reference's
        # 0.5 (test.py:143); another threshold re-derives the mask from the
        # same probabilities
        mask = (prob >= threshold).astype(mask.dtype)

    np.save(os.path.join(args.save_path, "probability_map.npy"), prob)
    if multiclass:
        # the argmax class labels, separate from the (H, W, C) softmax map
        np.save(os.path.join(args.save_path, "class_map.npy"), mask)
    if args.uncertainty:
        unc = out_maps[2]
        np.save(os.path.join(args.save_path, "uncertainty_map.npy"), unc)
        if args.export_tiff:
            from pdac_pathological_image_segmentation_tpu_torch.data.tiffwriter import (
                write_probability_tiff,
            )

            # variance of a [0,1] mean caps at 0.25 — scale to use the
            # 8-bit range
            write_probability_tiff(
                os.path.join(args.save_path, "uncertainty_map.tiff"),
                np.clip(unc * 4.0, 0.0, 1.0),
            )
        print(f"uncertainty map (mean {float(unc.mean()):.5f}, "
              f"max {float(unc.max()):.5f}) -> uncertainty_map.npy")
    if args.min_region or args.fill_holes:
        from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
            clean_mask,
        )

        # the probability map stays raw; every mask-derived output
        # (overlay figure, geojson, tumor fraction) uses the cleaned mask
        mask = clean_mask(mask, min_area=args.min_region,
                          fill_holes_area=args.fill_holes)
    if args.geojson:
        from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
            mask_to_polygons,
            polygons_to_geojson,
            write_geojson,
        )

        # mask is at the inference level's resolution; QuPath wants
        # level-0 pixel coordinates
        coord_scale = 1.0
        if args.slide:
            coord_scale = (slide.dimensions(0)[0]
                           / slide.dimensions(args.level)[0])
        if multiclass:
            # one classified feature set per non-background class
            features, n_polys = [], 0
            for k in range(1, cfg.num_classes):
                polys = mask_to_polygons(
                    (mask == k).astype(np.uint8),
                    min_area=args.geojson_min_area,
                    simplify_tol=args.geojson_simplify, scale=coord_scale,
                )
                n_polys += len(polys)
                gj_k = polygons_to_geojson(
                    polys, class_name=f"{args.geojson_class}_{k}",
                    measurements={"class_fraction": float((mask == k).mean())},
                )
                features.extend(gj_k["features"])
            gj = {"type": "FeatureCollection", "features": features}
        else:
            polys = mask_to_polygons(
                mask, min_area=args.geojson_min_area,
                simplify_tol=args.geojson_simplify, scale=coord_scale,
            )
            n_polys = len(polys)
            gj = polygons_to_geojson(
                polys, class_name=args.geojson_class,
                measurements={"tumor_fraction": float(mask.mean())},
            )
        out_gj = write_geojson(
            os.path.join(args.save_path, "annotations.geojson"), gj
        )
        print(f"geojson: {n_polys} region(s) -> {out_gj}")
    if args.export_tiff:
        from pdac_pathological_image_segmentation_tpu_torch.data.tiffwriter import (
            write_probability_tiff,
        )

        write_probability_tiff(
            os.path.join(args.save_path, "probability_map.tiff"), prob
        )
    slide_path = args.slide or cfg.svs_path
    thumb = _load_thumbnail(slide_path) if slide_path else None
    if thumb is None:
        thumb = np.full((*[min(s, 2048) for s in mask.shape], 3), 255, np.uint8)
    out = overlay_figure(
        thumb, mask, os.path.join(args.save_path, "overlay.png"),
        num_classes=cfg.num_classes,
    )
    tumor_frac = float((mask > 0).mean() if multiclass else mask.mean())
    print(f"overlay written to {out} (tumor fraction {tumor_frac:.4f}, "
          f"{len(source)} tiles)")
    return {"overlay": out, "tumor_fraction": tumor_frac,
            "n_tiles": len(source), "threshold": threshold}


if __name__ == "__main__":
    main()

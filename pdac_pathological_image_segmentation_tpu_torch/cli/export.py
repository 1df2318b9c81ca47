"""Export CLI — write a port serving artifact from a reference checkpoint:

    python -m pdac_pathological_image_segmentation_tpu_torch.cli.export \\
        --config cfg.yaml --pth_path best.pth --out model.pdacpt

The flags are the JAX package's ``cli/export.py``'s.  ``--pth_path`` is a
reference-format ``.pth`` (``{"model": state_dict}`` or a bare
``state_dict``, ``module.`` prefixes allowed): smp names for FPN,
DeepLabV3+ and PSPNet on a ResNet, ``mobilenet_v2`` or
``efficientnet-b0``…``b7`` encoder (smp EfficientNet's unrun
``encoder._conv_head.*``/``encoder._bn1.*`` are dropped), the reference
ResUNet's for unet (its ``encoder.fc.*`` is dropped), or the port's own ``latest.pth``/``best.pth``
(UNet++'s among them).  ``head_dtype`` (a config extra) and ``dilations``
go into the artifact.  Orbax directories are the JAX package's format
and are not read here.  The
artifact holds the weights, not a compiled program: every batch size and
the device are chosen at load time.  ``--batch`` and ``--platforms`` keep
their names so that old command lines parse, and an error says why when
one of them is set.

``--int8`` writes the int8 serving artifact (``infer/quantized.py``,
unet/fpn/deeplabv3+/pspnet on resnet18): the first 16 patches of
``--calib_path`` (default the config's ``test_path``) calibrate the
activation scales on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import os

from pdac_pathological_image_segmentation_tpu_torch.config import load_config


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="pathology_project")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--pth_path", required=True,
                        help="reference .pth file (smp FPN, DeepLabV3+ or "
                        "PSPNet names on any supported backbone, or "
                        "reference ResUNet names) or the port's "
                        "latest/best.pth")
    parser.add_argument("--out", required=True,
                        help="output artifact path (suggest .pdacpt)")
    parser.add_argument("--tile", type=int, default=None,
                        help="tile size (default: cfg.img_size)")
    parser.add_argument("--batch", type=int, default=None,
                        help="not supported: the artifact serves any batch "
                        "size")
    parser.add_argument("--platforms", type=str, default=None,
                        help="not supported: the device is chosen at load "
                        "time (serve --device)")
    parser.add_argument("--int8", action="store_true",
                        help="export the int8 quantized serving step")
    parser.add_argument("--calib_path", type=str, default=None,
                        help="patch dir for int8 calibration "
                        "(default: cfg.test_path)")
    parser.add_argument("--device", default="cuda",
                        help="where --int8 calibrates: cuda (default) or "
                        "cpu")
    args = parser.parse_args(argv)
    if args.batch is not None:
        parser.error("--batch is not supported: the artifact holds weights "
                     "and serves any batch size")
    if args.platforms is not None:
        parser.error("--platforms is not supported: pass --device to "
                     "cli.serve (or device= to load_serving_artifact)")
    if args.calib_path is not None and not args.int8:
        parser.error("--calib_path is not supported without --int8 (it "
                     "names the int8 calibration patches)")

    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        calib_batches_from_dir,
        export_serving_artifact,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        load_reference_state_dict,
    )

    if os.path.isdir(args.pth_path):
        raise ValueError(
            f"{args.pth_path} is a directory (an Orbax checkpoint of the JAX "
            "package); pass a reference .pth file")
    cfg = load_config(args.config)
    tile = args.tile or cfg.img_size
    calib = None
    if args.int8:
        calib = calib_batches_from_dir(args.calib_path or cfg.test_path,
                                       tile)
    size = export_serving_artifact(
        cfg, load_reference_state_dict(args.pth_path), args.out, tile=tile,
        int8=args.int8, calib_batches=calib, device=args.device)
    print(f"serving artifact written to {args.out} ({size / 1e6:.1f} MB, "
          f"{cfg.model}/{cfg.backbone}, tile {tile}, "
          f"{'int8' if args.int8 else cfg.compute_dtype})")
    return {"path": args.out, "bytes": size}


if __name__ == "__main__":
    main()

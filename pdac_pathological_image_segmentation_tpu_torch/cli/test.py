"""Evaluation CLI, the reference's interface (``test.py:22-26``) plus a
device:

    python -m pdac_pathological_image_segmentation_tpu_torch.cli.test \\
        --config cfg.yaml --save_path runs/eval --pth_path runs/fpn/pth \\
        [--device cpu]

``--pth_path`` is a ``.pth`` file (a reference checkpoint, smp FPN,
DeepLabV3+ or PSPNet names on any backbone of ``VALID_BACKBONES``, with
smp EfficientNet's ``encoder._conv_head``/``_bn1``, or the reference
ResUNet's with ``encoder.fc``, or the port's own) or a directory holding ``best.pth`` (preferred) or ``latest.pth``.  It prints
the mean Test Score / Test Loss and writes triptych figures to
``<save_path>/figure`` (matplotlib is needed only for them), per-sample
metrics to ``metrics.csv`` and the 257-threshold sweep to
``threshold_sweep.csv``.  It runs on the card (``--device cuda``, the
default) and raises when there is none unless ``--device cpu`` is passed.

Each batch is split over every visible card, or over the first
``num_devices`` of the YAML, as the JAX CLI's mesh splits it (a
``batch_size`` they do not divide raises); ``--device cuda:K`` evaluates
on card K alone, and ``--device cpu`` with ``num_devices: N`` splits it
over ``[cpu] * N``.  There is no flag for it: the YAML drives it, as in
the JAX CLI.  No process group is joined: under a launcher each process
evaluates the whole split.
"""

from __future__ import annotations

import argparse
import os

from pdac_pathological_image_segmentation_tpu_torch import (
    load_config,
    resolve_device,
)
from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
    discover_split,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
    Evaluator,
)


def _csv_path(value: str, save_path: str, default: str):
    if value == "auto":
        return os.path.join(save_path, default)
    return None if value == "none" else value


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="pathology_project")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--pth_path", required=True)
    parser.add_argument("--max_figures", type=int, default=None,
                        help="cap figure output (reference renders all)")
    parser.add_argument("--metrics_csv", default="auto",
                        help="per-sample dice/iou/precision/recall/"
                        "specificity/accuracy CSV (+macro/micro rows); "
                        "'auto' = <save_path>/metrics.csv, 'none' disables")
    parser.add_argument("--sweep_csv", default="auto",
                        help="pooled metrics at all 257 thresholds k/256; "
                        "'auto' = <save_path>/threshold_sweep.csv, 'none' "
                        "disables")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    test_set = PatchDataset(*discover_split(cfg.test_path), cfg)
    evaluator = Evaluator(cfg, args.pth_path, device=device)
    result = evaluator.run(
        test_set, figure_path=os.path.join(args.save_path, "figure"),
        max_figures=args.max_figures,
        metrics_csv=_csv_path(args.metrics_csv, args.save_path,
                              "metrics.csv"),
        sweep_csv=_csv_path(args.sweep_csv, args.save_path,
                            "threshold_sweep.csv"))
    if "best_threshold" in result:
        print(f"Best threshold: {result['best_threshold']:.6f} "
              f"(dice {result['best_dice']:.6f}; "
              f"dice@0.5 {result['dice_at_0.5']:.6f})")
    return result


if __name__ == "__main__":
    main()

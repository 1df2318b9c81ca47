"""Training CLI, the reference's interface (``train_main.py:15-19``) plus a
device:

    python -m pdac_pathological_image_segmentation_tpu_torch.cli.train \\
        --config configs/train_config.yaml --save_path runs/fpn [--device cpu]

One process trains on one card (``--device cuda``, the default); it raises
when there is no card unless ``--device cpu`` is passed.  Checkpoints go to
``<save_path>/pth/{latest,best}.pth``, the scalar log to
``<save_path>/log_dir/scalars.csv``; an existing ``latest.pth`` is resumed.
"""

from __future__ import annotations

import argparse

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
from pdac_pathological_image_segmentation_tpu_torch.train.loop import Trainer


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="pathology_project")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    train_set = PatchDataset(*discover_split(cfg.train_path), cfg)
    val_set = PatchDataset(*discover_split(cfg.val_path), cfg)
    return Trainer(cfg, args.save_path, train_set, val_set,
                   device=device).train()


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Training parity of the PyTorch port against the JAX package: the port's
``Trainer`` (``device="cpu"``, float32) and the JAX ``Trainer`` train the
same model from the same initial weights on the same PNG patches, in the
same batch order, and their validation Dice is compared epoch by epoch.

* The data: ``--n-train`` and ``--n-val`` synthetic patches at ``--size``²,
  written once by the JAX package's ``generate_synthetic_patches`` (seeds 0
  and 1) into ``--root`` (by default a temporary directory, removed at the
  end: the JAX checkpoints take about a gigabyte).
* The recipe: the JAX ``scripts/train_parity.py``'s defaults (6 epochs,
  48 + 16 patches at 64², batch 8, Adam at lr 1e-4), the reference's Dice,
  ``augment: false`` on both sides (the two augmentation streams differ by
  design), one device.
* The start: one seeded ``state_dict`` of the port's model, written as a
  reference-format ``latest.pth`` at epoch -1 into both trainers' ``pth``
  directories; each trainer resumes from it (the JAX one through its
  reference-checkpoint resume), so both start at epoch 0 from the same
  weights with fresh Adam moments.
* Dropout (FPN's Dropout2d) is off on both sides, as in the step tests
  (``tests/torch_model_parity.py``): the two frameworks draw its masks from
  streams that differ by design, and a run compares their numerics.
  ``--keep-dropout`` leaves it on, each side with its own masks.

Prints a per-epoch table per model and exits non-zero unless |Δ val Dice|
≤ ``--tolerance`` (0.05, the JAX script's gate) at every epoch.

    JAX_PLATFORMS=cpu python scripts/torch_train_parity.py \\
        [--models unet fpn] [--epochs 6] [--keep-dropout] \\
        [--root DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def _configs(args, model: str, data: str) -> dict:
    return {"train_path": os.path.join(data, "train"),
            "val_path": os.path.join(data, "val"), "model": model,
            "backbone": "resnet18", "img_size": args.size,
            "batch_size": args.batch, "epochs": args.epochs, "lr": args.lr,
            "seed": 41, "num_worker": 2, "compute_dtype": "float32",
            "augment": False, "num_devices": 1,
            "earlystop_patience": args.epochs + 1}


def _start_checkpoint(raw: dict, pth_dir: str) -> None:
    """The port model seeded from ``raw["seed"]``, as a reference-format
    ``latest.pth`` at epoch -1 with no Adam moments."""
    import torch

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.schedule import (
        ReduceLROnPlateau,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.state import (
        make_optimizer,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
        EarlyStop,
    )

    cfg = Config.from_dict(raw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg)
    scheduler = ReduceLROnPlateau(
        init_lr=cfg.lr, mode="max", factor=cfg.plateau_factor,
        patience=cfg.plateau_patience, min_lr=cfg.min_lr)
    early = EarlyStop(patience=cfg.earlystop_patience,
                      delta=cfg.earlystop_delta)
    save_checkpoint(pth_dir, model, make_optimizer(model, cfg.lr), -1, 0.0,
                    scheduler.state_dict(), early.state_dict(),
                    is_best=False)


def _train_port(raw: dict, out: str, dropout: bool) -> list:
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
        discover_split,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
        PatchDataset,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.loop import (
        Trainer,
    )

    cfg = Config.from_dict(raw)
    sets = [PatchDataset(*discover_split(raw[k]), cfg)
            for k in ("train_path", "val_path")]
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, out, *sets, device="cpu")
        if not dropout:
            for m in trainer.model.modules():
                if hasattr(m, "p") and "Dropout" in type(m).__name__:
                    m.p = 0.0
        return trainer.train()["history"]


def _train_jax(raw: dict, out: str, dropout: bool) -> list:
    from pdac_pathological_image_segmentation_tpu.config import Config
    from pdac_pathological_image_segmentation_tpu.data.discovery import (
        discover_split,
    )
    from pdac_pathological_image_segmentation_tpu.data.loader import (
        PatchDataset,
    )
    from pdac_pathological_image_segmentation_tpu.train.loop import Trainer

    cfg = Config.from_dict(raw)
    sets = [PatchDataset(*discover_split(raw[k]), cfg)
            for k in ("train_path", "val_path")]
    import flax.linen

    flax_dropout = flax.linen.Dropout
    if not dropout:  # flax's Dropout as the identity, for this run only
        flax.linen.Dropout = lambda *a, **k: (lambda x, *a2, **k2: x)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return Trainer(cfg, out, *sets).train()["history"]
    finally:
        flax.linen.Dropout = flax_dropout


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--models", nargs="+", default=["unet", "fpn"])
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--n-train", type=int, default=48)
    p.add_argument("--n-val", type=int, default=16)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--tolerance", type=float, default=0.05)
    p.add_argument("--keep-dropout", action="store_true")
    p.add_argument("--root", default=None)
    args = p.parse_args()
    if args.root is None:
        with tempfile.TemporaryDirectory(prefix="torch_train_parity_") as d:
            args.root = d
            return run(args)
    shutil.rmtree(args.root, ignore_errors=True)
    return run(args)


def run(args) -> int:
    """Both trainers on both models under ``args.root``; 0 when every epoch
    is within the tolerance."""
    from pdac_pathological_image_segmentation_tpu.data.synthetic import (
        generate_synthetic_patches,
    )

    data = os.path.join(args.root, "data")
    for split, n, seed in (("train", args.n_train, 0), ("val", args.n_val,
                                                        1)):
        generate_synthetic_patches(os.path.join(data, split), n=n,
                                   size=args.size, seed=seed)
    ok = True
    for model in args.models:
        raw = _configs(args, model, data)
        runs = {side: os.path.join(args.root, f"{model}_{side}")
                for side in ("port", "jax")}
        for out in runs.values():
            _start_checkpoint(raw, os.path.join(out, "pth"))
        t0 = time.perf_counter()
        port = _train_port(raw, runs["port"], args.keep_dropout)
        t1 = time.perf_counter()
        ref = _train_jax(raw, runs["jax"], args.keep_dropout)
        t2 = time.perf_counter()
        print(f"\n{model}/resnet18, {args.n_train} + {args.n_val} patches "
              f"at {args.size}², batch {args.batch}, lr {args.lr}, f32, "
              f"augment off, dropout {'on' if args.keep_dropout else 'off'}"
              f" (port {t1 - t0:.0f} s, JAX {t2 - t1:.0f} s on the CPU)")
        print("| epoch | port train_loss | JAX train_loss | port val_dice "
              "| JAX val_dice | Δdice |")
        print("|---|---|---|---|---|---|")
        for a, b in zip(port, ref):
            delta = a["val_score"] - b["val_score"]
            ok &= abs(delta) <= args.tolerance
            print(f"| {a['epoch'] + 1} | {a['train_loss']:.4f} | "
                  f"{b['train_loss']:.4f} | {a['val_score']:.4f} | "
                  f"{b['val_score']:.4f} | {delta:+.4f} |", flush=True)
        ok &= len(port) == len(ref) == args.epochs
    print(f"\n{'PASS' if ok else 'FAIL'}: |Δ val Dice| <= {args.tolerance} "
          "at every epoch" + ("" if ok else " does not hold"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The training loop (the JAX package's ``train/loop.py::Trainer``, one
device).

Per epoch: the train steps (each with a generator seeded from ``(seed,
epoch, step)``), validation, the plateau step and the new rate into Adam,
the reference's four scalar tags in ``log_dir/scalars.csv``, the early stop
and the checkpoint.  The per-step loss and score stay on the device and are
fetched once per epoch.  ``previous_best``, the scheduler and the early
stop are restored on resume, as in the JAX package.

``pretrained_path`` names an ImageNet encoder file, loaded into the seeded
model's encoder before any resume (so a resume overrides it), as the JAX
``Trainer`` does.  Not ported, each raising: ``num_devices > 1``,
``gns_every``, ``profile_epoch``.
"""

from __future__ import annotations

import os
import time

import torch

from pdac_pathological_image_segmentation_tpu_torch import resolve_device
from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
    PatchLoader,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.train.schedule import (
    ReduceLROnPlateau,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    make_optimizer,
    set_lr,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    step_generator,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
    EarlyStop,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    load_pretrained_encoder,
)

TAGS = ("Score/Train_Score", "Loss/Train_Loss", "Score/Validation_Score",
        "Loss/Validation_Loss")


def check_supported(cfg: Config) -> None:
    """Raise for the training options the port does not have."""
    if cfg.num_devices is not None and cfg.num_devices > 1:
        raise NotImplementedError(
            f"num_devices={cfg.num_devices}: multi-device training is not "
            "ported yet (ROADMAP.md Queue 1, item 4)")
    # debug_nans: the JAX CLI traps a NaN at the op that made it
    for knob in ("gns_every", "profile_epoch", "debug_nans"):
        if cfg.extras.get(knob):
            raise NotImplementedError(
                f"{knob} is not ported yet (ROADMAP.md Queue 1, item 4)")


class Trainer:
    """The reference's ``main_worker`` + ``train`` (``train_worker.py``)
    on one device."""

    def __init__(self, cfg: Config, save_path: str, train_set: PatchDataset,
                 val_set: PatchDataset, device="cuda") -> None:
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.log_dir = os.path.join(save_path, "log_dir")
        self.pth_path = os.path.join(save_path, "pth")
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.pth_path, exist_ok=True)

        # the initial weights come from cfg.seed, as the JAX package's
        # PRNGKey(cfg.seed), without touching the caller's global RNG
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model(cfg)
        if cfg.pretrained_path:
            load_pretrained_encoder(model, cfg.pretrained_path)
        else:
            print("note: encoder starts from random init — the reference "
                  "always starts from ImageNet (models/resunet.py:12). "
                  "One-time setup: MIGRATION.md 'First-run site steps' "
                  "(download resnet18-f37072fd.pth, convert with "
                  "scripts/convert_torchvision_resnet18.py, set "
                  "`pretrained_path`).", flush=True)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model, cfg.lr)
        self.objective = make_objective(cfg)
        self.train_loader = PatchLoader(train_set, cfg.batch_size,
                                        shuffle=True, device=self.device,
                                        num_workers=cfg.num_worker)
        self.val_loader = PatchLoader(val_set, cfg.batch_size, shuffle=False,
                                      device=self.device,
                                      num_workers=cfg.num_worker)
        self.scheduler = ReduceLROnPlateau(
            init_lr=cfg.lr, mode="max", factor=cfg.plateau_factor,
            patience=cfg.plateau_patience, min_lr=cfg.min_lr)
        self.early_stopping = EarlyStop(patience=cfg.earlystop_patience,
                                        delta=cfg.earlystop_delta)
        extras = cfg.extras
        self.train_step = make_train_step(
            self.model, self.optimizer, cfg.img_size, self.objective,
            augment=bool(extras.get("augment", True)),
            fused_augment=bool(extras.get("fused_augment", True)),
            remat=bool(extras.get("remat", False)),
            grad_accum_steps=int(extras.get("grad_accum_steps", 1)),
            parity_mode=cfg.parity_mode, stain=cfg.stain)
        self.eval_step = make_eval_step(self.model, cfg.img_size,
                                        self.objective, stain=cfg.stain)
        self.history: list = []

    def _validate(self):
        losses, scores = [], []
        for batch in self.val_loader.epoch(0):
            loss, score = self.eval_step(batch.image, batch.mask, batch.valid)
            losses.append(loss)
            scores.append(score)
        return (float(torch.stack(scores).mean()),
                float(torch.stack(losses).mean()))

    def _resume(self) -> tuple:
        meta = restore_checkpoint(self.pth_path, self.model, self.optimizer)
        if meta is None:
            return 0, 0.0
        previous_best = float(meta["previous_best"])
        if "scheduler" in meta:
            self.scheduler.load_state_dict(meta["scheduler"])
        if "earlystop" in meta:
            self.early_stopping.load_state_dict(meta["earlystop"])
        set_lr(self.optimizer, self.scheduler.lr)
        start = int(meta["epoch"]) + 1
        print(f"resumed from epoch {start - 1}, best={previous_best:.4f}",
              flush=True)
        return start, previous_best

    def train(self) -> dict:
        cfg = self.cfg
        start_epoch, previous_best = self._resume()
        last_epoch = start_epoch
        with open(os.path.join(self.log_dir, "scalars.csv"), "a") as csv:
            for epoch in range(start_epoch, cfg.epochs):
                last_epoch = epoch
                t0 = time.time()
                losses, scores = [], []
                n_samples = 0
                for step, batch in enumerate(self.train_loader.epoch(epoch)):
                    loss, score = self.train_step(
                        batch.image, batch.mask, batch.valid,
                        step_generator(cfg.seed, epoch, step))
                    losses.append(loss)
                    scores.append(score)
                    n_samples += batch.image.shape[0]
                if not losses:
                    raise RuntimeError("empty train epoch: check train_path")
                train_loss = float(torch.stack(losses).mean())
                train_score = float(torch.stack(scores).mean())
                epoch_time = time.time() - t0
                val_score, val_loss = self._validate()

                new_lr = self.scheduler.step(val_score)
                set_lr(self.optimizer, new_lr)
                print(f"epoch{epoch + 1}: Train_score:{train_score} "
                      f"Train_loss:{train_loss} Val_score:{val_score} "
                      f"Val_loss:{val_loss} "
                      f"({n_samples / max(epoch_time, 1e-9):.1f} patches/s, "
                      f"lr={new_lr:.2e})", flush=True)
                for tag, value in zip(TAGS, (train_score, train_loss,
                                             val_score, val_loss)):
                    csv.write(f"{epoch + 1},{tag},{value}\n")
                csv.flush()

                is_best = val_score > previous_best
                previous_best = max(val_score, previous_best)
                self.early_stopping(val_score)
                save_checkpoint(self.pth_path, self.model, self.optimizer,
                                epoch, previous_best,
                                self.scheduler.state_dict(),
                                self.early_stopping.state_dict(), is_best)
                self.history.append({
                    "epoch": epoch, "train_score": train_score,
                    "train_loss": train_loss, "val_score": val_score,
                    "val_loss": val_loss, "lr": new_lr,
                    "epoch_time_s": epoch_time,
                })
                if self.early_stopping.early_stop:
                    print("Early stopping!", flush=True)
                    break
        return {"best_val_score": previous_best, "last_epoch": last_epoch,
                "history": self.history}

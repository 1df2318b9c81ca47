"""The training loop (the JAX package's ``train/loop.py::Trainer``).

Per epoch: the train steps (each with a generator seeded from ``(seed,
epoch, step)``), validation, the plateau step and the new rate into Adam,
the reference's four scalar tags (``log_dir/scalars.csv``, and TensorBoard
events where ``torch.utils.tensorboard`` imports), the early stop and the
checkpoint, written on a background thread while the next epoch trains
(``AsyncCheckpointSaver``).  The per-step loss and score stay on the device
and are fetched once per epoch.  ``previous_best``, the scheduler and the
early stop are restored on resume, as in the JAX package; under
``parity_mode`` the best resets to 0 (the reference's quirk).

``pretrained_path`` names an ImageNet encoder file, loaded into the seeded
model's encoder before any resume (so a resume overrides it), as the JAX
``Trainer`` does.  ``profile_epoch: k`` traces epoch k with
``torch.profiler`` into ``log_dir/profile`` and prints the step times and
the trace's top kernels.  ``debug_nans: true`` runs the epochs under
autograd's anomaly mode and checks each step's loss and gradients
(``FloatingPointError`` naming the epoch, the step and the tensor).

In a process group of N > 1 ranks (``parallel/mesh.py``; ``cli.train``
makes or joins it) the trainer is one rank of a data-parallel run, as the
JAX trainer on an N-device mesh: BatchNorm over the global batch
(``parallel/batchnorm.py``), the Dice of the global batch, the loader's
per-rank split and the summed gradients (``train/steps.py``).  Every rank
sees the same metrics, so the plateau step and the early stop agree; only
the chief (rank 0) prints, writes the scalars and saves checkpoints, and
every rank resumes from the same ``latest.pth`` after a barrier.
``gns_every: k`` measures the gradient noise scale (``train/gns.py``) on
the first full batch of every k-th epoch and logs ``Diagnostics/GNS``
when it is finite (never with one rank).
"""

from __future__ import annotations

import contextlib
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
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    eval_transform,
)
from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
from pdac_pathological_image_segmentation_tpu_torch.parallel.batchnorm import (
    convert_batchnorm,
)
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    AsyncCheckpointSaver,
    restore_checkpoint,
)
from pdac_pathological_image_segmentation_tpu_torch.train.gns import (
    GnsEma,
    make_gns_stats,
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
from pdac_pathological_image_segmentation_tpu_torch.utils.profiling import (
    StepTimer,
    device_op_summary,
    trace,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    load_pretrained_encoder,
)

TAGS = ("Score/Train_Score", "Loss/Train_Loss", "Score/Validation_Score",
        "Loss/Validation_Loss")


class _ScalarWriter:
    """The reference's four scalar tags (``train_worker.py:100-109``):
    ``scalars.csv`` always, TensorBoard events as well where
    ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str) -> None:
        self._csv = open(os.path.join(log_dir, "scalars.csv"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: CSV only
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._csv.write(f"{global_step},{tag},{value}\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)

    def flush(self) -> None:
        self._csv.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._csv.close()
        if self._tb is not None:
            self._tb.close()


class Trainer:
    """The reference's ``main_worker`` + ``train`` (``train_worker.py``):
    one device, or one rank of a process group."""

    def __init__(self, cfg: Config, save_path: str, train_set: PatchDataset,
                 val_set: PatchDataset, device="cuda") -> None:
        self.world, self.rank = mesh.world_size(), mesh.rank()
        if cfg.num_devices is not None and cfg.num_devices != self.world:
            raise ValueError(
                f"num_devices={cfg.num_devices} but this process is one of "
                f"{self.world} rank(s): cli.train spawns the ranks, or "
                "joins the launcher's group of that size")
        self.is_chief = self.rank == 0
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
        elif self.is_chief:
            print("note: encoder starts from random init — the reference "
                  "always starts from ImageNet (models/resunet.py:12). "
                  "One-time setup: MIGRATION.md 'First-run site steps' "
                  "(download resnet18-f37072fd.pth, convert with "
                  "scripts/convert_torchvision_resnet18.py, set "
                  "`pretrained_path`).", flush=True)
        self.model = model.to(self.device)
        parallel = self.world > 1
        if parallel:
            convert_batchnorm(self.model)
        self.optimizer = make_optimizer(self.model, cfg.lr)
        self.objective = make_objective(
            cfg, reduce=mesh.global_sum if parallel else None)
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
            parity_mode=cfg.parity_mode, stain=cfg.stain,
            debug_nans=bool(extras.get("debug_nans", False)))
        self.eval_step = make_eval_step(self.model, cfg.img_size,
                                        self.objective, stain=cfg.stain)
        self.gns_every = int(extras.get("gns_every", 0) or 0)
        self.gns_stats = self._gns_stats() if self.gns_every else None
        self.gns_ema = GnsEma() if self.gns_every else None
        self.history: list = []

    def _gns_stats(self):
        """The JAX trainer's ``_build_gns_stats``: the gradient of this
        rank's own Dice (no reduction over ranks; ``make_gns_stats`` owns
        those) on the eval transform of its rows, the model in eval mode,
        so that the augmentation's draws add no variance of their own."""
        model, cfg = self.model, self.cfg
        local = make_objective(cfg)
        params = [p for p in model.parameters() if p.requires_grad]

        def grad_fn(images, masks):
            model.eval()
            try:
                imgs, msks = eval_transform(images, masks, cfg.img_size,
                                            stain=cfg.stain)
                loss = local.loss_fn(model(imgs), msks, None)
                return torch.autograd.grad(loss, params, allow_unused=True,
                                           materialize_grads=True)
            finally:
                model.train()

        return make_gns_stats(grad_fn, cfg.batch_size)

    def _validate(self):
        losses, scores = [], []
        for batch in self.val_loader.epoch(0):
            loss, score = self.eval_step(batch.image, batch.mask, batch.valid)
            losses.append(loss)
            scores.append(score)
        return (float(torch.stack(scores).mean()),
                float(torch.stack(losses).mean()))

    def _resume(self) -> tuple:
        # every rank reads the same latest.pth, once the chief has made the
        # directories
        mesh.sync_global_devices("resume")
        meta = restore_checkpoint(self.pth_path, self.model, self.optimizer)
        if meta is None:
            return 0, 0.0
        if self.cfg.parity_mode:
            # the reference's quirk: the best resets on resume, and the
            # scheduler and the early stop start afresh; the rate is the
            # one saved, as the reference's optimizer state carries it
            previous_best = 0.0
            if "scheduler" in meta:
                set_lr(self.optimizer, meta["scheduler"]["lr"])
        else:
            previous_best = float(meta["previous_best"])
            if "scheduler" in meta:
                self.scheduler.load_state_dict(meta["scheduler"])
            if "earlystop" in meta:
                self.early_stopping.load_state_dict(meta["earlystop"])
            set_lr(self.optimizer, self.scheduler.lr)
        start = int(meta["epoch"]) + 1
        if self.is_chief:
            print(f"resumed from epoch {start - 1}, "
                  f"best={previous_best:.4f}", flush=True)
        return start, previous_best

    def train(self) -> dict:
        start_epoch, previous_best = self._resume()
        # the chief's alone (None on the other ranks)
        saver = self.saver = AsyncCheckpointSaver() if self.is_chief else None
        writer = self.writer = (_ScalarWriter(self.log_dir) if self.is_chief
                                else None)
        anomaly = (torch.autograd.set_detect_anomaly(True)
                   if self.cfg.extras.get("debug_nans")
                   else contextlib.nullcontext())
        try:
            with anomaly:
                return self._train_epochs(start_epoch, previous_best, saver,
                                          writer)
        finally:
            # an exception mid-epoch must not abandon the write in flight
            if saver is not None:
                saver.wait()
            if writer is not None:
                writer.close()

    def _gns(self, epoch: int, step: int, batch):
        """The GNS estimate of this batch when the cadence asks for it: the
        first step of every ``gns_every``-th epoch (a full batch: a final
        partial one is wrap-padded to the batch, as in the JAX loader)."""
        if self.gns_stats is None or step or epoch % self.gns_every:
            return None
        return self.gns_ema.update(self.gns_stats(batch.image, batch.mask))

    def _train_epoch(self, epoch: int, timer: StepTimer):
        losses, scores = [], []
        n_samples = 0
        gns_value = None
        timer.reset()
        for step, batch in enumerate(self.train_loader.epoch(epoch)):
            value = self._gns(epoch, step, batch)
            gns_value = value if value is not None else gns_value
            timer.start()
            try:
                loss, score = self.train_step(
                    batch.image, batch.mask, batch.valid,
                    step_generator(self.cfg.seed, epoch, step))
            except FloatingPointError as e:
                raise FloatingPointError(
                    f"epoch {epoch + 1}, step {step}: {e}") from e
            timer.stop()
            losses.append(loss)
            scores.append(score)
            n_samples += batch.image.shape[0] * self.world
        if not losses:
            raise RuntimeError("empty train epoch: check train_path")
        return (float(torch.stack(losses).mean()),
                float(torch.stack(scores).mean()), n_samples, gns_value)

    def _train_epochs(self, start_epoch: int, previous_best: float,
                      saver: AsyncCheckpointSaver | None,
                      writer: _ScalarWriter | None) -> dict:
        cfg = self.cfg
        last_epoch = start_epoch
        profile_epoch = cfg.extras.get("profile_epoch")
        timer = StepTimer()
        for epoch in range(start_epoch, cfg.epochs):
            last_epoch = epoch
            t0 = time.time()
            profiling = (profile_epoch is not None
                         and epoch == int(profile_epoch) and self.is_chief)
            profile_dir = os.path.join(self.log_dir, "profile")
            with (trace(profile_dir, cuda=self.device.type == "cuda")
                  if profiling else contextlib.nullcontext()):
                train_loss, train_score, n_samples, gns_value = \
                    self._train_epoch(epoch, timer)
            epoch_time = time.time() - t0
            val_score, val_loss = self._validate()

            new_lr = self.scheduler.step(val_score)
            set_lr(self.optimizer, new_lr)
            if self.is_chief:
                print(f"epoch{epoch + 1}: Train_score:{train_score} "
                      f"Train_loss:{train_loss} Val_score:{val_score} "
                      f"Val_loss:{val_loss} "
                      f"({n_samples / max(epoch_time, 1e-9):.1f} patches/s, "
                      f"lr={new_lr:.2e})", flush=True)
            if profiling:
                print(f"profile of epoch {epoch}: step times "
                      f"{timer.summary()}; trace in {profile_dir}",
                      flush=True)
                for us, name, _ in device_op_summary(profile_dir, top=10):
                    print(f"  {us / 1e3:10.3f} ms  {name}", flush=True)
            if writer is not None:
                for tag, value in zip(TAGS, (train_score, train_loss,
                                             val_score, val_loss)):
                    writer.add_scalar(tag, value, epoch + 1)
                if gns_value is not None and gns_value == gns_value:
                    writer.add_scalar("Diagnostics/GNS", gns_value,
                                      epoch + 1)
                writer.flush()

            is_best = val_score > previous_best
            previous_best = max(val_score, previous_best)
            # the same on every rank (global metrics): no rank stops alone
            self.early_stopping(val_score)
            if saver is not None:
                saver.save(self.pth_path, self.model, self.optimizer, epoch,
                           previous_best, self.scheduler.state_dict(),
                           self.early_stopping.state_dict(), is_best)
            self.history.append({
                "epoch": epoch, "train_score": train_score,
                "train_loss": train_loss, "val_score": val_score,
                "val_loss": val_loss, "lr": new_lr,
                "epoch_time_s": epoch_time, "step_time": timer.summary(),
                "gns": gns_value,
            })
            if self.early_stopping.early_stop:
                if self.is_chief:
                    print("Early stopping!", flush=True)
                break
            mesh.sync_global_devices(f"epoch_{epoch}")
        return {"best_val_score": previous_best, "last_epoch": last_epoch,
                "history": self.history}

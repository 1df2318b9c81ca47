"""Per-patch evaluation (the JAX package's ``infer/evaluate.py``; the
reference's ``test.py:137-191``).

One device step per batch, in eval mode: the loss and hard Dice score of
the batch, hard predictions, the masks, the denormalized inputs, per-sample
confusion counts (one-vs-rest per class for a multi-class model) and, for
a binary model, the probability histograms of the threshold sweep.
The host fetches once per batch.  As in the reference, the meters average
per batch (n = 1 per batch, ``test.py:149-150``), not per sample; the
wrap-padded samples of the last partial batch are masked out by ``valid``.

Each batch is split along its rows over a list of devices (``mesh``), as
the JAX ``Evaluator`` shards it over its mesh: every visible card by
default, or the config's first ``num_devices``; ``[cpu] * n`` on the CPU.
Each shard runs on its device and stream, with one model per distinct
device.  The loss and the score stay the whole batch's: each of their
ratios is formed once, of sums over every shard (:class:`_ShardSums`).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch import (
    device_to_host,
    resolve_device,
)
from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
    PatchLoader,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.figures import (
    save_triptych,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    denormalize,
    eval_transform,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.metrics import (
    METRIC_NAMES,
    SWEEP_BINS,
    derive_metrics,
    per_sample_confusion,
    prob_histograms,
    threshold_sweep,
)
from pdac_pathological_image_segmentation_tpu_torch.parallel.mesh import (
    create_mesh,
    indexed_device,
    replicate,
)
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    BEST,
    LATEST,
)
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
    AverageMeter,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    drop_unbuilt_keys,
    load_reference_state_dict,
)


def resolve_pth(pth_path: str) -> str:
    """The checkpoint file ``pth_path`` names: a ``.pth``/``.pt`` file
    (reference or the port's own), or a directory holding ``best.pth``
    (preferred) or ``latest.pth``.  Anything else raises
    ``FileNotFoundError``."""
    if os.path.isfile(pth_path) and pth_path.endswith((".pth", ".pt")):
        return pth_path
    if os.path.isdir(pth_path):
        for name in (BEST, LATEST):
            path = os.path.join(pth_path, name)
            if os.path.isfile(path):
                return path
    raise FileNotFoundError(f"no checkpoint found at {pth_path}")


def load_serving_state(cfg: Config, pth_path: str, device="cuda",
                       mesh: Optional[List[torch.device]] = None):
    """``(model, path)``: ``cfg``'s model with the weights of the
    checkpoint ``pth_path`` resolves to (:func:`resolve_pth`), in eval mode
    on ``device`` (default ``"cuda"``, which raises without a card), or,
    given a ``mesh``, on its first device (the home device)."""
    dev = indexed_device(mesh[0]) if mesh else resolve_device(device)
    path = resolve_pth(pth_path)
    model = build_model(cfg)
    model.load_state_dict(
        drop_unbuilt_keys(model, load_reference_state_dict(path)),
        strict=True)
    return model.to(dev).eval(), path


def resolve_mesh(cfg: Config, device="cuda",
                 mesh: Optional[List[torch.device]] = None
                 ) -> List[torch.device]:
    """The devices a batch is split over: ``mesh`` as given; else a card
    named with its index alone; else ``create_mesh(cfg.num_devices)`` on
    ``device``'s kind (every visible card, or ``[cpu] * (num_devices or
    1)``), as the JAX ``Evaluator`` builds its mesh."""
    if mesh is not None:
        devices = [indexed_device(d) for d in mesh]
        if not devices or len({d.type for d in devices}) > 1:
            raise ValueError(f"mesh {mesh}: give one kind of device, at "
                             "least once")
        return devices
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        return [dev]
    return create_mesh(cfg.num_devices, dev)


class _ShardSums:
    """The objective's ``reduce`` hook over the shards of one batch, in one
    process (``parallel.mesh.global_sum`` is the same hook over ranks).

    The JAX step forms each ratio of the loss and the score (a Dice, a
    mean cross-entropy) from sums over the whole batch array.  Here each
    shard's objective first runs collecting: every call's partial sums are
    kept and handed back as they are (the shard's own ratios are dropped).
    :meth:`total` then sums each call's partials over the shards on the
    home device, and the objective runs once more replaying: its k-th call
    returns the k-th total, so each ratio is formed once, of the batch's
    sums.  A mean of the shards' ratios would not be the batch's Dice."""

    def __init__(self) -> None:
        self.start()

    def start(self) -> None:
        """A new batch: nothing collected, nothing to replay."""
        self.parts: list = []  # per shard, each call's partial sums
        self.totals: Optional[list] = None

    def collect(self) -> None:
        """Start the next shard's calls."""
        self.parts.append([])

    def total(self, home: torch.device) -> None:
        """Sum each call's partials over the shards on ``home``, in mesh
        order, and replay the totals from the next call on."""
        self.totals = [functools.reduce(torch.add,
                                        [p[k].to(home) for p in self.parts])
                       for k in range(len(self.parts[0]))]
        self.totals.reverse()

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.totals is not None:
            return self.totals.pop()
        self.parts[-1].append(t)
        return t


class _Shard(NamedTuple):
    """One shard's rows of a batch, on its device, made on ``stream``."""
    stream: Optional[torch.cuda.Stream]
    preds: torch.Tensor
    masks: torch.Tensor
    originals: torch.Tensor
    counts: torch.Tensor


class Evaluator:
    """The test harness: ``Evaluator(cfg, pth_path, device, mesh).run(
    test_set)``.  ``mesh`` is the device list each batch is split over
    (:func:`resolve_mesh`); ``model`` is the home device's, the first of
    the mesh, and every other distinct device holds a copy."""

    def __init__(self, cfg: Config, pth_path: str, device="cuda",
                 mesh: Optional[List[torch.device]] = None) -> None:
        self.cfg = cfg
        self.mesh = resolve_mesh(cfg, device, mesh)
        self.device = self.mesh[0]
        self._sums = _ShardSums()
        self.objective = make_objective(cfg, reduce=self._sums)
        self.model, self.pth = load_serving_state(cfg, pth_path,
                                                  mesh=self.mesh)
        self.replicas = replicate(self.model, self.mesh)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.mesh]

    def _shard(self, dev, stream, images, masks, valid):
        """One shard's rows, moved to ``dev`` and run there under
        ``stream``: ``(out, masks, valid, hists, shard)``, the objective's
        partial sums collected."""
        obj = self.objective
        model = self.replicas[dev]
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            images, masks, valid = (t.to(dev, non_blocking=True)
                                    for t in (images, masks, valid))
            imgs, msks = eval_transform(images, masks, self.cfg.img_size,
                                        model.compute_dtype, self.cfg.stain)
            out = model(imgs)
            preds = obj.predict_fn(out)
            if obj.num_classes == 1:
                # the tumor probability exactly as predict_fn thresholds it
                hists = prob_histograms(torch.sigmoid(out[:, 0].float()),
                                        msks, valid)
            else:
                hists = torch.zeros((2, SWEEP_BINS + 1), dtype=torch.int64,
                                    device=out.device)
            self._sums.collect()
            obj.loss_fn(out, msks, valid)
            obj.score_fn(out, msks, valid)
            return out, msks, valid, hists, _Shard(
                stream, preds, msks, denormalize(imgs.float()),
                per_sample_confusion(preds, msks, valid, obj.num_classes))

    @torch.inference_mode()
    def _step(self, images, masks, valid):
        """``(loss, score, shards, hists)`` of one batch on the home device
        (``images``, ``masks``, ``valid`` lie there): its rows split into
        ``len(mesh)`` contiguous shards in mesh order, each run on its
        device and stream (:class:`_Shard`); the loss, the score and the
        histograms are the whole batch's, on the home device's current
        stream."""
        # no record_stream: run's fetch waits on every stream before a
        # batch's tensors are dropped
        home, n = self.device, images.shape[0] // len(self.mesh)
        self._sums.start()
        runs = []
        for i, (dev, stream) in enumerate(zip(self.mesh, self.streams)):
            if stream is not None:
                # after the batch's upload to the home card
                stream.wait_stream(torch.cuda.current_stream(home))
            rows = slice(i * n, (i + 1) * n)
            runs.append(self._shard(dev, stream, images[rows], masks[rows],
                                    valid[rows]))
        for stream in self.streams:
            if stream is not None:
                torch.cuda.current_stream(home).wait_stream(stream)
        self._sums.total(home)
        out, msks, valid0 = runs[0][:3]  # shard 0 lies on the home device
        loss = self.objective.loss_fn(out, msks, valid0)
        score = self.objective.score_fn(out, msks, valid0)
        hists = functools.reduce(torch.add, [r[3].to(home) for r in runs])
        return loss, score, [r[4] for r in runs], hists

    def run(self, test_set: PatchDataset, figure_path: Optional[str] = None,
            max_figures: Optional[int] = None,
            metrics_csv: Optional[str] = None,
            sweep_csv: Optional[str] = None, verbose: bool = True) -> dict:
        """Evaluate ``test_set``; write figures to ``figure_path`` (at most
        ``max_figures``), per-sample metrics (then ``macro`` and ``micro``
        rows; a column per metric and class for a multi-class model) to
        ``metrics_csv`` and, for a binary model, the 257-threshold sweep to
        ``sweep_csv``.  Returns ``test_score``, ``test_loss``, the pooled
        metrics (averaged over the classes), and for a binary model
        ``best_threshold``, ``best_dice`` and ``dice_at_0.5``.  A
        ``batch_size`` that the mesh does not divide raises ``ValueError``
        (as the JAX loader's batch-sharded ``device_put`` does)."""
        cfg = self.cfg
        if cfg.batch_size % len(self.mesh):
            raise ValueError(f"batch_size {cfg.batch_size} must divide by "
                             f"the mesh's {len(self.mesh)} devices")
        # one process evaluates the whole split, in a process group too
        loader = PatchLoader(test_set, cfg.batch_size, shuffle=False,
                             device=self.device, num_workers=cfg.num_worker,
                             split=False)
        if figure_path:
            os.makedirs(figure_path, exist_ok=True)
        loss_meter, score_meter = AverageMeter(), AverageMeter()
        count = 0
        all_counts = []  # per-sample confusion rows, in dataset order
        hist_total = np.zeros((2, SWEEP_BINS + 1), np.int64)
        for batch in loader.epoch(0):
            loss, score, shards, hists = self._step(batch.image, batch.mask,
                                                    batch.valid)
            figures = bool(figure_path) and (max_figures is None
                                             or count < max_figures)
            fields = ["counts"] + (["preds", "masks", "originals"]
                                   if figures else [])
            # one fetch: the batch's numbers, then each shard's rows
            fetched = device_to_host(
                [loss, score, hists, batch.valid]
                + [getattr(s, f) for s in shards for f in fields],
                [None] * 4 + [s.stream for s in shards for _ in fields])
            loss_h, score_h, hists_h, valid_h = fetched[:4]
            # each field's shards, concatenated in mesh order
            rows = {f: np.concatenate(fetched[4 + k::len(fields)])
                    for k, f in enumerate(fields)}
            hist_total += hists_h
            loss_meter.update(float(loss_h))
            score_meter.update(float(score_h))
            all_counts.append(rows["counts"][valid_h])
            if figures:
                for i in np.flatnonzero(valid_h):
                    if max_figures is not None and count >= max_figures:
                        break
                    count += 1
                    save_triptych(figure_path, count,
                                  rows["originals"][i].transpose(1, 2, 0),
                                  rows["masks"][i], rows["preds"][i])
        counts_all = (np.concatenate(all_counts, axis=0) if all_counts
                      else np.zeros((0, 1, 4), np.float32))
        per_sample = derive_metrics(counts_all)  # each (N, C)
        micro = derive_metrics(counts_all.sum(axis=0))  # each (C,)
        result = {
            "test_score": score_meter.avg,
            "test_loss": loss_meter.avg,
            "n_figures": count,
            "n_samples": int(counts_all.shape[0]),
            "metrics": {k: float(np.mean(v)) for k, v in micro.items()},
        }
        if metrics_csv:
            _write_metrics_csv(metrics_csv, test_set, counts_all, per_sample,
                               micro)
            result["metrics_csv"] = metrics_csv
        if hist_total.sum() > 0:
            sweep = threshold_sweep(hist_total)
            best = int(np.argmax(sweep["dice"]))
            result["best_threshold"] = float(sweep["threshold"][best])
            result["best_dice"] = float(sweep["dice"][best])
            # bucket bins/2 is exactly the reference's prob >= 0.5 rule
            result["dice_at_0.5"] = float(sweep["dice"][SWEEP_BINS // 2])
            if sweep_csv:
                _write_sweep_csv(sweep_csv, sweep)
                result["sweep_csv"] = sweep_csv
        if verbose:
            print(f"Test Score: {result['test_score']} "
                  f"Test Loss: {result['test_loss']}")
        return result


def _write_sweep_csv(path: str, sweep: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = ("threshold",) + METRIC_NAMES
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(len(sweep["threshold"])):
            f.write(",".join(f"{float(sweep[c][i]):.6f}" for c in cols)
                    + "\n")


def _write_metrics_csv(path: str, test_set, counts_all, per_sample,
                       micro) -> None:
    n, c = counts_all.shape[:2]
    # metric-major, class-minor columns; binary drops the class suffix
    header = ["sample", "path"] + [m if c == 1 else f"{m}_c{ci}"
                                   for m in METRIC_NAMES for ci in range(c)]
    img_paths = list(getattr(test_set, "img_paths", [])) or [""] * n
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for i in range(n):
            vals = [f"{per_sample[m][i, ci]:.6f}"
                    for m in METRIC_NAMES for ci in range(c)]
            base = (os.path.basename(str(img_paths[i]))
                    if i < len(img_paths) else "")
            f.write(",".join([str(i), base] + vals) + "\n")
        macro = [f"{float(np.mean(per_sample[m][:, ci])):.6f}" if n else "nan"
                 for m in METRIC_NAMES for ci in range(c)]
        f.write(",".join(["macro", ""] + macro) + "\n")
        mic = [f"{float(micro[m][ci]):.6f}"
               for m in METRIC_NAMES for ci in range(c)]
        f.write(",".join(["micro", ""] + mic) + "\n")

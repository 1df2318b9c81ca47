"""Per-patch evaluation (the JAX package's ``infer/evaluate.py``; the
reference's ``test.py:137-191``).

One device step per batch, in eval mode: the loss and hard Dice score of
the batch, hard predictions, the masks, the denormalized inputs, per-sample
confusion counts (one-vs-rest per class for a multi-class model) and, for
a binary model, the probability histograms of the threshold sweep.
The host fetches once per batch.  As in the reference, the meters average
per batch (n = 1 per batch, ``test.py:149-150``), not per sample; the
wrap-padded samples of the last partial batch are masked out by ``valid``.
"""

from __future__ import annotations

import os
from typing import Optional

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


def load_serving_state(cfg: Config, pth_path: str, device="cuda"):
    """``(model, path)``: ``cfg``'s model with the weights of the
    checkpoint ``pth_path`` resolves to (:func:`resolve_pth`), in eval mode
    on ``device`` (default ``"cuda"``, which raises without a card)."""
    dev = resolve_device(device)
    path = resolve_pth(pth_path)
    model = build_model(cfg)
    model.load_state_dict(
        drop_unbuilt_keys(model, load_reference_state_dict(path)),
        strict=True)
    return model.to(dev).eval(), path


class Evaluator:
    """The test harness: ``Evaluator(cfg, pth_path, device).run(test_set)``."""

    def __init__(self, cfg: Config, pth_path: str, device="cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.objective = make_objective(cfg)
        self.model, self.pth = load_serving_state(cfg, pth_path, self.device)

    @torch.inference_mode()
    def _step(self, images, masks, valid):
        """``(loss, score, preds, masks, originals, counts, hists)`` of one
        batch, all on the device."""
        obj, model = self.objective, self.model
        imgs, msks = eval_transform(images, masks, self.cfg.img_size,
                                    model.compute_dtype, self.cfg.stain)
        out = model(imgs)
        preds = obj.predict_fn(out)
        if obj.num_classes == 1:
            # the tumor probability exactly as predict_fn thresholds it
            hists = prob_histograms(torch.sigmoid(out[:, 0].float()), msks,
                                    valid)
        else:
            hists = torch.zeros((2, SWEEP_BINS + 1), dtype=torch.int64,
                                device=out.device)
        return (obj.loss_fn(out, msks, valid), obj.score_fn(out, msks, valid),
                preds, msks, denormalize(imgs.float()),
                per_sample_confusion(preds, msks, valid, obj.num_classes),
                hists)

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
        ``best_threshold``, ``best_dice`` and ``dice_at_0.5``."""
        cfg = self.cfg
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
            loss, score, preds, msks, originals, counts, hists = self._step(
                batch.image, batch.mask, batch.valid)
            figures = bool(figure_path) and (max_figures is None
                                             or count < max_figures)
            fetched = device_to_host(
                [loss, score, counts, hists, batch.valid]
                + ([preds, msks, originals] if figures else []))
            loss_h, score_h, counts_h, hists_h, valid_h = fetched[:5]
            hist_total += hists_h
            loss_meter.update(float(loss_h))
            score_meter.update(float(score_h))
            all_counts.append(counts_h[valid_h])
            if figures:
                preds_h, msks_h, orig_h = fetched[5:]
                for i in np.flatnonzero(valid_h):
                    if max_figures is not None and count >= max_figures:
                        break
                    count += 1
                    save_triptych(figure_path, count,
                                  orig_h[i].transpose(1, 2, 0), msks_h[i],
                                  preds_h[i])
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

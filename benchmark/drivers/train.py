"""Training: the program's train step (``train/steps.py::make_train_step``:
the fused augmentation, the forward, the Dice, the backward and Adam) at
the configuration's batch, fed shuffled batches of a patch set made on
the card from the seed, as the loader would feed it.

Set-up builds the step once, with the seed's weights and a fresh Adam,
and drives its first ``check_steps`` steps (the window's own feed and
call, on rows that all differ), keeping their losses, the first gradient
as Adam holds it after one step (its first moment over 1 − β1) and the
parameters' change over those steps.  The window goes on with the same
step.  After it, the plain reference (``reference/train.py``) runs the
same steps from the same weights, batches and generator seeds in float32.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from benchmark import harness
from benchmark.reference import train as ref_train
from benchmark.trace import Trace, span

TINT = (120.0, 60.0, 160.0)  # hematoxylin purple of a tumor blob
BASE = (230.0, 180.0, 200.0)  # eosin pink


def make_patches(tr: dict, seed: int, dev) -> tuple:
    """``(images (P, S, S, 3) uint8, masks (P, S, S) uint8)`` on ``dev``:
    H&E-like pink with smooth and fine noise; with p = ``tumor_fraction``
    a purple disc, which is the mask.  Made in chunks from one device
    generator."""
    n, size, chunk = tr["patches"], tr["tile"], tr["make_chunk"]
    g = torch.Generator(device=dev).manual_seed(harness.sub_seed(seed, 3))
    images = torch.empty((n, size, size, 3), dtype=torch.uint8, device=dev)
    masks = torch.empty((n, size, size), dtype=torch.uint8, device=dev)
    yy = torch.arange(size, device=dev).view(1, size, 1)
    xx = torch.arange(size, device=dev).view(1, 1, size)
    base = torch.tensor(BASE, device=dev).view(1, 3, 1, 1)
    tint = torch.tensor(TINT, device=dev).view(1, 3, 1, 1)
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        coarse = torch.randn((m, 3, size // 32, size // 32), generator=g,
                             device=dev)
        img = base + 18.0 * F.interpolate(coarse, size=(size, size),
                                          mode="bilinear")
        img += 8.0 * torch.randn((m, 3, size, size), generator=g, device=dev)
        cy, cx = torch.randint(size // 4, 3 * size // 4, (2, m, 1, 1),
                               generator=g, device=dev)
        r = torch.randint(size // 8, size // 3, (m, 1, 1), generator=g,
                          device=dev)
        tumor = torch.rand((m, 1, 1), generator=g,
                           device=dev) < tr["tumor_fraction"]
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & tumor
        img = torch.where(blob[:, None], 0.5 * img + 0.5 * tint, img)
        images[c0:c0 + m] = img.clamp(0, 255).to(torch.uint8).permute(
            0, 2, 3, 1)
        masks[c0:c0 + m] = blob.to(torch.uint8)
    return images, masks


class Feed:
    """Shuffled batches of the patch set: each epoch a permutation from a
    device generator, cut into batches; each step's CPU generator seeded
    from the run's seed and the step's number."""

    def __init__(self, tr: dict, seed: int, dev, n: int) -> None:
        self.batch, self.n, self.seed, self.dev = tr["batch"], n, seed, dev
        self.gen = torch.Generator(device=dev).manual_seed(
            harness.sub_seed(seed, 4))
        self.perm, self.at, self.step = None, n, 0

    def next(self) -> tuple:
        """``(row indices on the device, generator seed)``."""
        if self.at + self.batch > self.n:
            self.perm = torch.randperm(self.n, generator=self.gen,
                                       device=self.dev)
            self.at = 0
        idx = self.perm[self.at:self.at + self.batch]
        self.at += self.batch
        self.step += 1
        return idx, harness.sub_seed(self.seed, 5, self.step)


def params_of(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def first_gradient(model, optimizer, beta1: float) -> dict:
    """The gradient Adam took at its first step: its first moment over
    ``1 − β1`` (zero where it holds no moment)."""
    out = {}
    for k, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        out[k] = (state["exp_avg"].detach() / (1.0 - beta1)
                  if "exp_avg" in state else torch.zeros_like(p))
    return out


def compare(program: dict, reference: dict) -> dict:
    """Numbers of a check, over the leaves that move
    (``reference/train.py::moving_leaves``): the loss gaps (the first
    step's, the worst step's), and for the first gradient and the change
    the worst leaf's and the median leaf's gap of norms
    (``reference/train.py::leaf_gaps``)."""
    keep = ref_train.moving_leaves(reference["grad1"])
    out = {"loss1_gap": abs(program["losses"][0] - reference["losses"][0]),
           "loss_gap": max(abs(a - b) for a, b in zip(program["losses"],
                                                      reference["losses"]))}
    for name in ("grad1", "change"):
        gaps = ref_train.leaf_gaps(program[name], reference[name], keep)
        ranked = sorted(gaps.values())
        worst = max(gaps, key=gaps.get)
        key = "grad" if name == "grad1" else name
        out[f"{key}_gap"] = gaps[worst]
        out[f"{key}_gap_median"] = ranked[len(ranked) // 2]
        out[f"{key}_worst_leaf"] = worst
    diffs = ref_train.leaf_differences(program["grad1"], reference["grad1"],
                                       keep)
    out["grad_diff"] = max(diffs.values())
    out["grad_diff_median"] = sorted(diffs.values())[len(diffs) // 2]
    return out


def build_step(cell, sd, dev):
    from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
        make_objective,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.state import (
        make_optimizer,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_train_step,
    )

    cfg = cell.config
    pcfg, model = harness.program_model(cfg, sd, dev)
    optimizer = make_optimizer(model, cfg["lr"])
    step = make_train_step(model, optimizer, cfg["img_size"],
                           make_objective(pcfg), augment=True,
                           fused_augment=True)
    return model, optimizer, step


def stepper(tr: dict, seed: int, dev, step, images, masks):
    """The window's call: ``one() → (row indices, generator seed, loss)``,
    one step of ``step`` on the feed's next batch of the patch set."""
    feed = Feed(tr, seed, dev, images.shape[0])
    valid = torch.ones(tr["batch"], dtype=torch.bool, device=dev)

    def one():
        with span("train.feed"):
            idx, gen_seed = feed.next()
            batch = (images.index_select(0, idx), masks.index_select(0, idx))
            g = torch.Generator().manual_seed(gen_seed)
        with span("train.step"):
            loss, _ = step(*batch, valid, g)
        return idx, gen_seed, loss

    return one


def checked_steps(tr: dict, cfg: dict, model, optimizer, one) -> tuple:
    """The first ``check_steps`` steps through ``one``: ``(program,
    checked)``, ``program`` the losses, the first gradient as Adam holds
    it and the parameters' change over the steps, ``checked`` each step's
    ``(row indices, generator seed)``."""
    start = params_of(model)
    checked, losses = [], []
    for i in range(tr["check_steps"]):
        idx, gen_seed, loss = one()
        checked.append((idx.clone(), gen_seed))
        losses.append(loss)
        if i == 0:
            grad1 = first_gradient(model, optimizer, cfg["adam_betas"][0])
    after = params_of(model)
    return ({"losses": [float(v) for v in losses], "grad1": grad1,
             "change": {k: after[k] - start[k] for k in start}}, checked)


def checked_batches(images, masks, checked) -> list:
    """The reference's batches ``[(images, masks, generator seed)]`` of the
    checked steps."""
    return [(images.index_select(0, idx), masks.index_select(0, idx),
             gen_seed) for idx, gen_seed in checked]


def run(cell) -> harness.Outcome:
    tr, cfg, dev = cell.traffic, cell.config, torch.device(cell.device)
    harness.log(cell, "set-up starts")
    sd = harness.weights(cfg, cell.seed, dev)
    model, optimizer, step = build_step(cell, sd, dev)
    images, masks = make_patches(tr, cell.seed, dev)
    harness.log(cell, "weights and patches made, step built")
    one = stepper(tr, cell.seed, dev, step, images, masks)
    program, checked = checked_steps(tr, cfg, model, optimizer, one)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    harness.log(cell, f"{tr['check_steps']} checked steps; the window starts")

    steps = 0
    with Trace(cell.trace) as trace:
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        while True:
            one()
            steps += 1
            if cell.trace:
                if steps >= tr["trace_steps"]:
                    break
            elif time.perf_counter() - t0 >= cell.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = trace.summary() if cell.trace else None

    batches = checked_batches(images, masks, checked)
    del model, optimizer, step, images, masks, one
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    harness.log(cell, f"window closed: {steps} steps in {window:.3f} s")
    ref = harness.reference_model(cfg, sd, dev)
    checks, failed = harness.judge(
        cell.limits, [compare(program, ref_train.run_steps(ref, cfg,
                                                           batches))])
    harness.log(cell, "reference compared")
    rows = steps * tr["batch"]
    return harness.Outcome(
        attempted=steps, failed=failed,
        e2e={"train_patches_per_s": rows / window, "setup_s": setup_s},
        work={"patches": rows, "steps": steps, "window_s": window},
        checks=checks,
        peak_bytes=peak, trace=summary)

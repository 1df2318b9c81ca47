"""How far f32 rounding moves the gradients of one FPN/resnet18 train step,
on one rank and on two, against the same step in float64, on the CPU.

    python3 scripts/torch_dp_rounding.py [--size 256] [--batch 8]

One step (augmentation and dropout on) on ``chip_smoke.py``'s smooth,
tissue-like tiles and circle masks, from the smoke's seeded weights, in
five runs: float64 on one rank (the reference); float32 on one rank
(``nn.BatchNorm2d``); float32 on two gloo ranks (``GlobalBatchNorm2d``:
the variance as E[x²] − E[x]²); float32 on two ranks with a two-pass
variance (E[(x − mean)²], one more all_reduce); float64 on two ranks.  The
objective sums in float32 in every run, as the step does, so the float64
runs agree to some 1e-7, not to float64's rounding.
Prints, for each run, the loss and the worst gradient's distance from the
reference relative to its norm, and the two-rank runs' worst distance from
the one-rank float32 run.  If the two-rank gap stays at the size of the
one-rank run's own rounding and the two-pass variance does not shrink it,
the gap is the step's f32 rounding and not the data-parallel path's.
Ranks rendezvous by a ``file://`` store in a temporary directory; each
uses ``--threads`` torch threads.  Needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RUNS = {  # name: (ranks, float64, two-pass variance)
    "f64, 1 rank": (1, True, False),
    "f32, 1 rank": (1, False, False),
    "f32, 2 ranks": (2, False, False),
    "f32, 2 ranks, two-pass variance": (2, False, True),
    "f64, 2 ranks": (2, True, False),
}


def _two_pass_forward(ctx, x, weight, bias, running_mean, running_var,
                      momentum, eps):
    """``GlobalBatchNormFunction.forward`` with the variance taken around
    the global mean: one all_reduce for the sums and the count, a second
    for the squared deviations."""
    from pdac_pathological_image_segmentation_tpu_torch.parallel import (
        batchnorm as bn,
    )

    acc = bn._acc_dtype(x)
    c = x.shape[1]
    xf = x.to(acc)
    stats = torch.cat([xf.sum((0, 2, 3)),
                       torch.full((1,), float(x.numel() // c), dtype=acc)])
    bn.all_reduce(stats)
    n = stats[c]
    mean = stats[:c] / n
    dev = xf - mean.view(1, c, 1, 1)
    var = bn.all_reduce((dev * dev).sum((0, 2, 3))) / n
    invstd = torch.rsqrt(var + eps)
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(
            momentum * mean.to(running_mean.dtype))
        running_var.mul_(1 - momentum).add_(
            momentum * (var * n / (n - 1)).to(running_var.dtype))
    y = dev * invstd.view(1, c, 1, 1) * weight.to(acc).view(1, c, 1, 1) \
        + bias.to(acc).view(1, c, 1, 1)
    ctx.save_for_backward(x, weight, mean, invstd, n)
    return y.to(x.dtype)


def _step(size: int, batch: int, float64: bool, two_pass: bool) -> dict:
    """This rank's gradients (float64, on the host) and the loss of one
    train step on its rows of the global batch."""
    import chip_smoke as smoke
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
    from pdac_pathological_image_segmentation_tpu_torch.parallel import (
        batchnorm as bn,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
        make_objective,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.state import (
        make_optimizer,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_train_step,
        step_generator,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    if two_pass:
        bn.GlobalBatchNormFunction.forward = staticmethod(_two_pass_forward)
    world, rank = mesh.world_size(), mesh.rank()
    cfg = Config(model="fpn", img_size=size, compute_dtype="float32",
                 lr=1e-4)
    model = build_model(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=7), strict=True)
    if float64:
        model.double()
        model.compute_dtype = torch.float64
    if world > 1:
        bn.convert_batchnorm(model)
    step = make_train_step(
        model, make_optimizer(model, cfg.lr), size,
        make_objective(cfg, reduce=mesh.global_sum if world > 1 else None))
    n = batch // world
    rows = slice(rank * n, (rank + 1) * n)
    images = torch.from_numpy(smoke._tiles(batch, seed=8, size=size)[rows])
    masks = torch.from_numpy(smoke._masks(batch, seed=9, size=size)[rows])
    loss, _ = step(images, masks, torch.ones(n, dtype=torch.bool),
                   step_generator(0, 0, 0))
    return {"loss": float(loss),
            "grads": {k: p.grad.double().clone()
                      for k, p in model.named_parameters()
                      if p.grad is not None}}


def _rank(rank: int, world: int, store: str, out: str, threads: int,
          args: tuple) -> None:
    torch.set_num_threads(threads)
    import torch.distributed as dist

    from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh

    mesh.initialize_distributed(backend="gloo", init_method=store,
                                rank=rank, world_size=world, device="cpu")
    try:
        res = _step(*args)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def run(world: int, args: tuple, threads: int) -> dict:
    """Rank 0's result of ``world`` spawned gloo ranks."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        procs = [ctx.Process(target=_rank, args=(
            r, world, f"file://{tmp}/store", out, threads, args))
            for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        if any(p.exitcode for p in procs):
            raise RuntimeError(f"ranks exited {[p.exitcode for p in procs]}")
        return torch.load(out, weights_only=False)


def worst(got: dict, want: dict) -> tuple:
    """The gradient farthest from ``want`` relative to its norm."""
    errs = {k: float((got[k] - g).norm()) / max(float(g.norm()), 1e-30)
            for k, g in want.items()}
    k = max(errs, key=errs.get)
    return errs[k], k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--threads", type=int, default=2)
    a = ap.parse_args()
    res = {name: run(world, (a.size, a.batch, f64, two_pass), a.threads)
           for name, (world, f64, two_pass) in RUNS.items()}
    ref = res["f64, 1 rank"]["grads"]
    print(f"FPN/resnet18, one train step at {a.batch}x{a.size}², the smoke's "
          "tiles, on the CPU")
    for name, r in res.items():
        e, k = worst(r["grads"], ref)
        print(f"{name}: loss {r['loss']:.9f}; worst gradient against f64, "
              f"1 rank: {e:.3g} of its norm ({k})")
    for name in ("f32, 2 ranks", "f32, 2 ranks, two-pass variance"):
        e, k = worst(res[name]["grads"], res["f32, 1 rank"]["grads"])
        print(f"{name} against f32, 1 rank: {e:.3g} of its norm ({k})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Rank processes for the multi-rank tests of the PyTorch port (not a test
module itself): ``tests/test_torch_distributed.py``,
``test_torch_gns.py``.

:func:`run_ranks` spawns ``world`` processes that join a gloo group by a
``file://`` rendezvous under the caller's temporary directory (so that test
workers never compete for a port), each on one torch thread; each runs a
list of cases (functions of this module, by name) and the parent gets every
rank's results in rank order.  The rank processes import torch and the
port only, never jax.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch

SIZE = 64
LR = 1e-3


def _child(rank: int, world: int, tmp: str, cases: list) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh

    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        mesh.initialize_distributed(
            backend="gloo", init_method=f"file://{tmp}/rendezvous",
            rank=rank, world_size=world, device="cpu")
        results = [globals()[name](**kw) for name, kw in cases]
        torch.save(results, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, tmp, cases: list, timeout: float = 300.0) -> list:
    """Each rank's list of case results (rank order); a rank that fails
    raises with its traceback."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world, tmp, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"rank{r}.pt.err")
        if os.path.exists(err):
            raise RuntimeError(f"rank {r} failed:\n" + open(err).read())
        if p.exitcode != 0:
            raise RuntimeError(f"rank {r} exited with {p.exitcode}")
        results.append(torch.load(os.path.join(tmp, f"rank{r}.pt"),
                                  weights_only=False))
    return results


# -- cases --------------------------------------------------------------------

def bn_data(rows: list, seed: int = 0):
    """The global batch (x, dy) of the BatchNorm cases in float64: C = 5,
    8×7 maps, ``sum(rows)`` samples, mean far from 0."""
    rng = np.random.default_rng(seed)
    n = sum(rows)
    x = rng.normal(3.0, 2.0, (n, 5, 8, 7))
    dy = rng.normal(0.0, 1.0, (n, 5, 8, 7))
    return torch.from_numpy(x), torch.from_numpy(dy)


def bn_case(rows: list, seed: int = 0) -> dict:
    """This rank's rows ``rows[rank]`` of the global batch through
    :class:`GlobalBatchNorm2d` (train mode, momentum 0.1): its output, its
    input gradient, its parameter gradients and the running statistics."""
    from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
    from pdac_pathological_image_segmentation_tpu_torch.parallel.batchnorm import (
        convert_batchnorm,
    )

    r = mesh.rank()
    x, dy = bn_data(rows, seed)
    start = sum(rows[:r])
    part = slice(start, start + rows[r])
    bn = torch.nn.Sequential(torch.nn.BatchNorm2d(5)).double()
    with torch.no_grad():
        bn[0].weight.copy_(torch.linspace(0.5, 1.5, 5))
        bn[0].bias.copy_(torch.linspace(-1.0, 1.0, 5))
    convert_batchnorm(bn)
    xr = x[part].clone().requires_grad_(True)
    y = bn(xr)
    y.backward(dy[part])
    b = bn[0]
    return {"y": y.detach(), "dx": xr.grad, "dw": b.weight.grad,
            "db": b.bias.grad, "running_mean": b.running_mean,
            "running_var": b.running_var,
            "tracked": int(b.num_batches_tracked)}


def step_batch(n: int = 4, seed: int = 0):
    """The global batch of the step cases: images, binary masks and
    ``valid`` with the last sample wrap-padding."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    masks = (rng.random((n, SIZE, SIZE)) < 0.4).astype(np.uint8)
    valid = np.array([True] * (n - 1) + [False])
    return images, masks, valid


def fpn_sd(seed: int = 3) -> dict:
    from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    return seeded_state_dict(FPN(output_size=SIZE), seed=seed)


def step_case(dropout: float = 0.2, augment: bool = True,
              float64: bool = True, step_kw: dict | None = None,
              n: int = 4) -> dict:
    """One FPN/resnet18 train step at 64² on this rank's rows of the global
    batch of :func:`step_batch` (rank r: rows ``[r·n/N, (r+1)·n/N)``), the
    data-parallel step of ``train/steps.py``; in one process, the
    one-device step.  Returns the loss, the score, the gradients and the
    ``state_dict`` after Adam."""
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN
    from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
    from pdac_pathological_image_segmentation_tpu_torch.parallel.batchnorm import (
        convert_batchnorm,
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

    world, r = mesh.world_size(), mesh.rank()
    model = FPN(output_size=SIZE, dropout=dropout)
    model.load_state_dict(fpn_sd(), strict=True)
    if float64:
        model.double()
        model.compute_dtype = torch.float64
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="float32", lr=LR)
    parallel = world > 1
    if parallel:
        convert_batchnorm(model)
    opt = make_optimizer(model, LR)
    step = make_train_step(
        model, opt, SIZE,
        make_objective(cfg, reduce=mesh.global_sum if parallel else None),
        augment=augment, **(step_kw or {}))
    images, masks, valid = step_batch(n)
    part = slice(r * n // world, (r + 1) * n // world)
    loss, score = step(torch.from_numpy(images[part]),
                       torch.from_numpy(masks[part]),
                       torch.from_numpy(valid[part]), step_generator(0, 0, 0))
    return {"loss": float(loss), "score": float(score),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def train_case(config: str, save_path: str, argv: tuple = ()) -> dict:
    """``cli.train.main`` in this rank's process group (the launcher path):
    its result, whether this rank held the scalar writer and the saver, and
    what it printed is not collected."""
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        train as cli_train,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train import loop

    held = []
    real = loop.Trainer.train

    def train(self):
        try:
            return real(self)
        finally:
            held.append((self.writer is not None, self.saver is not None))

    loop.Trainer.train = train
    try:
        result = cli_train.main(["--config", config, "--save_path",
                                 save_path, "--device", "cpu", *argv])
    finally:
        loop.Trainer.train = real
    return {"history": result["history"], "last_epoch": result["last_epoch"],
            "held": held}


def gns_case(x: np.ndarray, y: np.ndarray, w0: np.ndarray,
             scale: float | None = None) -> dict:
    """``make_gns_stats`` of the mean-squared-error gradient of a linear
    model (``scale·x·w``, scale a replicated argument when given) on this
    rank's rows of ``(x, y)``."""
    from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
    from pdac_pathological_image_segmentation_tpu_torch.train.gns import (
        make_gns_stats,
    )

    world, r = mesh.world_size(), mesh.rank()
    n = len(x)
    part = slice(r * n // world, (r + 1) * n // world)
    w = torch.tensor(w0, dtype=torch.float32, requires_grad=True)

    def grad_fn(*args):
        *s, xb, yb = args
        pred = xb @ w
        if s:
            pred = s[0] * pred
        return {"w": torch.autograd.grad(((pred - yb) ** 2).mean(), w)[0]}

    args = (torch.from_numpy(x[part]), torch.from_numpy(y[part]))
    n_repl = 0
    if scale is not None:
        args, n_repl = (torch.tensor(scale),) + args, 1
    stats = make_gns_stats(grad_fn, n, n_repl_args=n_repl)(*args)
    return {k: float(v) for k, v in stats._asdict().items()}

"""Training CLI, the reference's interface (``train_main.py:15-19``) plus a
device:

    python -m pdac_pathological_image_segmentation_tpu_torch.cli.train \\
        --config configs/train_config.yaml --save_path runs/fpn [--device cpu]

Checkpoints go to ``<save_path>/pth/{latest,best}.pth``, the scalar log to
``<save_path>/log_dir/scalars.csv``; an existing ``latest.pth`` is resumed.
It raises when there is no card unless ``--device cpu`` is passed.

How many ranks train:

* **Under a launcher, or in an existing process group** (``torchrun
  --nproc_per_node N -m …cli.train``, or a caller that ran
  ``parallel.mesh.initialize_distributed``): this process is one rank, on
  ``--device`` (``cuda:LOCAL_RANK`` by default).  The config's
  ``num_devices``, if set, must equal the world size.
* **Otherwise** ``num_devices`` ranks (None: every visible card, as the
  reference's ``mp.spawn`` over the local GPU count,
  ``train_main.py:103-110``): with N > 1 this process spawns N ranks on
  ``cuda:0..N-1`` over NCCL, or N gloo ranks under ``--device cpu``, and
  returns rank 0's result.  With one, it trains here.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

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
from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
from pdac_pathological_image_segmentation_tpu_torch.train.loop import Trainer


def _train(cfg, save_path: str, device) -> dict:
    train_set = PatchDataset(*discover_split(cfg.train_path), cfg)
    val_set = PatchDataset(*discover_split(cfg.val_path), cfg)
    return Trainer(cfg, save_path, train_set, val_set, device=device).train()


def _spawned_rank(r: int, world: int, init_file: str, config: str,
                  save_path: str, kind: str, result_path: str,
                  threads: int) -> None:
    """One rank of a run this CLI spawned (a spawned process's entry); CPU
    ranks share the caller's intra-op threads."""
    device = torch.device("cuda", r) if kind == "cuda" else "cpu"
    if kind == "cpu":
        torch.set_num_threads(threads)
    mesh.initialize_distributed(init_method=f"file://{init_file}", rank=r,
                                world_size=world, device=device)
    try:
        result = _train(load_config(config), save_path, device)
        if r == 0:
            torch.save(result, result_path)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(world: int, config: str, save_path: str, kind: str) -> dict:
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pdac_ranks_") as tmp:
        result_path = os.path.join(tmp, "rank0.pt")
        procs = [ctx.Process(target=_spawned_rank,
                             args=(r, world, os.path.join(tmp, "rendezvous"),
                                   config, save_path, kind, result_path,
                                   max(1, torch.get_num_threads() // world)))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"training rank(s) {failed} of {world} "
                               "failed (their tracebacks are above)")
        return torch.load(result_path, weights_only=False)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="pathology_project")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--device", default=None,
                        help="cuda (default; cuda:LOCAL_RANK under a "
                        "launcher) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if mesh.launched():
        device = resolve_device(args.device
                                or f"cuda:{mesh.local_rank()}")
        mesh.initialize_distributed(device=device)
        if cfg.num_devices is not None \
                and cfg.num_devices != mesh.world_size():
            raise ValueError(
                f"num_devices={cfg.num_devices} but the launcher's world "
                f"size is {mesh.world_size()}")
        return _train(cfg, args.save_path, device)
    device = resolve_device(args.device or "cuda")
    if cfg.num_devices is not None:
        world = cfg.num_devices
    else:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world > 1:
        if device.type == "cuda":
            mesh.create_mesh(world)  # raises when there are fewer cards
        return _spawn(world, args.config, args.save_path, device.type)
    return _train(cfg, args.save_path, device)


if __name__ == "__main__":
    main()

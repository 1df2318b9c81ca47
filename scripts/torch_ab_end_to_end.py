"""Time the port's end-to-end metrics for two checkouts on one card, in
turns, so that a change is compared with its parent on the same card.

    python3 scripts/torch_ab_end_to_end.py PARENT_DIR CHANGE_DIR [--rounds 2]

Each turn runs in a fresh process from the checkout's own directory and
uses that checkout's ``chip_smoke.py``: ``phase_timed_step`` (one train
step of ``configs/train_config.yaml``, batch 128, 512², bf16, ms/step by
CUDA events) and the bucket-32 bf16 forward of FPN/resnet18 with the input
on the card (the median of five windows of ten calls, by CUDA events),
with the profiler's device time of the GN and augmentation kernels in one
step.  The order is parent, change, change, parent, repeated ``--rounds``
times; it prints one JSON line per turn and the medians per checkout.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as s
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)
card = s.phase_environment()
s.phase_build()
step = s.phase_timed_step(card)
cfg = Config(model="fpn", backbone="resnet18", img_size=s.TILE,
             compute_dtype="bfloat16")
infer = s._model(seeded_state_dict(build_model(cfg), seed=0), "bfloat16",
                 "cuda")
x = torch.from_numpy(s._tiles(32, seed=3)).cuda()
for _ in range(3):
    infer(x)
times = []
for _ in range(5):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(10):
        infer(x)
    b.record()
    torch.cuda.synchronize()
    times.append(a.elapsed_time(b) / 10)
fwd = sorted(times)[2]
print("RESULT " + json.dumps({"ms_per_step": step["ms_per_step"],
                              "gn_forward_ms": step["shares_ms"]["gn_forward"],
                              "gn_backward_ms": step["shares_ms"]["gn_backward"],
                              "augment_ms": step["shares_ms"]["augment"],
                              "forward32_ms": fwd, "card": card}))
"""


def turn(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            res = turn(trees[name])
            runs[name].append(res)
            print(json.dumps({"turn": name, **res}), flush=True)
    for name, rs in runs.items():
        med = {k: float(np.median([r[k] for r in rs]))
               for k in ("ms_per_step", "forward32_ms", "gn_forward_ms",
                         "gn_backward_ms", "augment_ms")}
        print(json.dumps({"median": name, "turns": len(rs), **med}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the port's fused augmentation kernel (``csrc/fused_augment.cu``) at
128×512² under four table sets, for one checkout or two in turns.

    python3 scripts/torch_augment_sweep.py [TREE ...] [--rounds 1]

With no TREE it times this checkout.  With two (PARENT CHANGE) each round
runs parent, change, change, parent.  Each turn is a fresh process in the
checkout's own directory, with that checkout's package and its
``chip_smoke.py`` tiles and masks, so both see the same inputs.  The table
sets take the kernel's costs apart:

* ``identity``: no jitter, no geometry (loads, an un-jittered sample's
  per-pixel work, row stores);
* ``transposed``: no jitter, every sample rot90 k=1 (the transposed store);
* ``jittered``: every sample jittered, no geometry (the four statistics
  passes and the per-pixel jitter);
* ``trainer``: the train step's own draws (``draw_augment_scalars`` on a
  seeded generator: about half jittered, 5% transposed).

Each turn first holds the kernel against its plain version on every set
(masks bitwise, at least 99.9% of the image bit-identical); then per set it
prints ``ms`` (median of five windows of 20 back-to-back calls, CUDA
events), ``device_ms`` (the profiler's kernel time per call) and
``launch_ms`` (the same, per launch in launch order: the four statistics
passes, then the output pass), beside ``copy_ms`` (the same bytes moved
with no arithmetic) and the bytes bound.  Needs a
card: without one it exits 2.
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
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as s
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    draw_augment_scalars, make_augment_tables)
from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
    fused_train_transform, fused_train_transform_reference)

N, S = 128, 512

# (kernel time per call, per launch in launch order), or Nones where the
# profiler did not see every launch
def device_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    launches = len(ev) // iters
    if len(ev) != launches * iters or not launches:
        return None, None
    per = [sum(ev[k + launches * j].time_range.elapsed_us()
               for j in range(iters)) / 1e3 / iters for k in range(launches)]
    return sum(per), per

def tables(which):
    if which == "trainer":
        return make_augment_tables(*draw_augment_scalars(
            N, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    facs = np.concatenate([rng.uniform(0.7, 1.3, (N, 3)),
                           rng.uniform(-0.3, 0.3, (N, 1))], 1)
    ints = np.zeros((N, 8), np.int32)
    for i in range(N):
        ints[i, :4] = rng.permutation(4)
    ints[:, 4] = which == "jittered"
    if which == "transposed":
        ints[:, 5:8] = (1, 1, 1)
    return make_augment_tables(torch.from_numpy(facs.astype(np.float32)),
                               torch.from_numpy(ints))

card = s.phase_environment()
s.phase_build()
s.warm_card()
images = torch.from_numpy(s._tiles(N, seed=148)).cuda()
masks = torch.from_numpy(s._masks(N, seed=128)).cuda()
out = torch.empty((N, 3, S, S), dtype=torch.bfloat16, device="cuda")
mout = torch.empty((N, S, S), dtype=torch.float32, device="cuda")
copy_ms = s.cuda_ms(lambda: (out.copy_(images.permute(0, 3, 1, 2)),
                           mout.copy_(masks)))
bound_ms = N * S * S * (3 + 1 + 3 * 2 + 4) / s.HBM_BYTES_PER_S * 1e3
rows = {}
for which in ("identity", "transposed", "jittered", "trainer"):
    tb = tables(which).to("cuda")
    got, gmask = fused_train_transform(images, masks, tb)
    ref, rmask = fused_train_transform_reference(images, masks, tb)
    same = float((got == ref).float().mean())
    if not torch.equal(gmask, rmask) or same < 0.999:
        raise SystemExit(f"{which}: masks equal {torch.equal(gmask, rmask)}, "
                         f"bit-identical {same}")
    call = lambda: fused_train_transform(images, masks, tb)
    dev, per_launch = device_ms(call)
    rows[which] = {"ms": s.cuda_ms(call), "device_ms": dev,
                   "launch_ms": per_launch,
                   "jittered": int(tb.ints[:, 4].sum()),
                   "transposed": int(tb.geom[:, 0].sum()),
                   "bit_identical": same}
    del got, gmask, ref, rmask
print("RESULT " + json.dumps({"card": card, "copy_ms": copy_ms,
                              "bound_ms": bound_ms, "rows": rows}))
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
    ap.add_argument("trees", type=Path, nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if len(args.trees) > 2:
        ap.error("one checkout, or two (parent, change)")
    trees = [t.resolve() for t in args.trees] \
        or [Path(__file__).resolve().parents[1]]
    names = ["parent", "change"] if len(trees) == 2 else ["tree"]
    order = ["parent", "change", "change", "parent"] \
        if len(trees) == 2 else ["tree"]
    where = dict(zip(names, trees))
    runs = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in order:
            res = turn(where[name])
            runs[name].append(res)
            print(json.dumps({"turn": name, "tree": str(where[name]), **res}),
                  flush=True)
    for name, rs in runs.items():
        med = {which: {k: float(np.median([r["rows"][which][k] for r in rs
                                           if r["rows"][which][k] is not None]
                                          or [float("nan")]))
                       for k in ("ms", "device_ms")}
               for which in rs[0]["rows"]}
        print(json.dumps({"median": name, "turns": len(rs),
                          "copy_ms": float(np.median([r["copy_ms"]
                                                      for r in rs])),
                          "bound_ms": rs[0]["bound_ms"], "rows": med}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of a cell's check are set from, in one process.

    python3 benchmark/tools/limits.py --workload <name> --seeds 1 2 3 ... \\
        [--out readings.jsonl]

For each seed it computes what a run's check computes, at the cell's own
sizes: the program's readings against the plain reference, and the
control's, which is the reference put in the program's place in the next
precision below the configuration's (fp8 below bf16; int4 below int8, at
the int8 reference's calibration, which is the program's windows).  Train
cells also read a fault planted in the reference put in the program's
place: the loss taken over half of each batch.  No window is timed: a
slide cell runs one whole slide a seed through the program's runner, a
train cell its checked steps.  One JSON line a seed and side.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import models, quant  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402


def slide_readings(cell, seed: int) -> list:
    drv = harness.driver(cell.traffic)
    tr, cfg, dev = cell.traffic, cell.config, torch.device(cell.device)
    sd = harness.weights(cfg, seed, dev)
    fseed = drv.field_seed(seed, 0)
    runner, owned = drv.build_runner(cell, sd, dev, drv.source(tr, fseed, dev))
    blocks = drv.check_blocks(tr, seed, 0)
    t0 = time.perf_counter()
    got = drv.crop(*runner.run(drv.source(tr, fseed, dev)), blocks)
    slide_s = time.perf_counter() - t0
    del runner, owned
    torch.cuda.empty_cache()
    slides = [(got, fseed, blocks)]
    program = drv.reference_readings(cell, sd, dev, slides, 0.0)[0]
    control = drv.reference_readings(cell, sd, dev, slides, 0.0, True)[0]
    return [dict(side="program", slide_s=slide_s, **program),
            dict(side="control_fp8" if tr["precision"] == "bf16"
                 else "control_int4", **control)]


def train_readings(cell, seed: int) -> list:
    drv = harness.driver(cell.traffic)
    tr, cfg, dev = cell.traffic, cell.config, torch.device(cell.device)
    sd = harness.weights(cfg, seed, dev)
    model, optimizer, step = drv.build_step(cell, sd, dev)
    images, masks = drv.make_patches(tr, seed, dev)
    one = drv.stepper(tr, seed, dev, step, images, masks)
    program, checked = drv.checked_steps(tr, cfg, model, optimizer, one)
    batches = drv.checked_batches(images, masks, checked)
    del model, optimizer, step, images, masks, one
    torch.cuda.empty_cache()
    reference = ref_train.run_steps(harness.reference_model(cfg, sd, dev),
                                    cfg, batches)
    out = [dict(side="program", **drv.compare(program, reference))]

    for side, q, outputs in (("control_fp8", quant.fp8_step, True),
                             ("fp8_operands", quant.fp8, False),
                             ("witness_bf16", quant.bf16_step, True)):
        low = harness.reference_model(cfg, sd, dev)
        models.set_quantizer(low, q, outputs)
        out.append(dict(side=side, **drv.compare(
            ref_train.run_steps(low, cfg, batches), reference)))

    whole = ref_train.dice_loss
    half = tr["batch"] // 2
    ref_train.dice_loss = lambda logits, m: whole(logits[:half], m[:half])
    try:
        faulty = ref_train.run_steps(harness.reference_model(cfg, sd, dev),
                                     cfg, batches)
    finally:
        ref_train.dice_loss = whole
    out.append(dict(side="fault_half_batch",
                    **drv.compare(faulty, reference)))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args()
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload, 0, 0.0, False)
    readings = (slide_readings if cell.traffic["driver"] == "slide"
                else train_readings)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            for row in readings(cell, seed):
                line = json.dumps(dict(workload=args.workload, seed=seed,
                                       **row))
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

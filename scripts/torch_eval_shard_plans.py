"""What an evaluation shard's batch does to cuDNN's plans: the FPN/resnet18
forward at 512² with seeded weights, at 8 rows (``cli.test``'s batch in
``chip_smoke.py``) and at 4 (a shard of it over two devices), on the
card.

    python3 scripts/torch_eval_shard_plans.py

For float32 with TF32 off and for bfloat16: the forward's ms by CUDA
events on the default stream and on a side stream (the ``Evaluator``
runs each shard on its own), with ``cudnn.benchmark`` off and on; then,
for float32, the profiler's top kernels of one forward at 4 and at 8
rows.  Prints the card's name and power limit first.  Needs a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def forward_ms(fn, stream: torch.cuda.Stream, iters: int = 5) -> float:
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    smoke.phase_environment()
    smoke.phase_build()
    smoke.set_tf32(False)
    streams = {"default": torch.cuda.current_stream(),
               "side": torch.cuda.Stream()}
    for dtype in ("float32", "bfloat16"):
        model = build_model(Config(model="fpn", img_size=smoke.TILE,
                                   compute_dtype=dtype))
        model.load_state_dict(seeded_state_dict(model, seed=5), strict=True)
        model = model.cuda().eval()
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            for n in (8, 4):
                x = torch.randn(n, 3, smoke.TILE, smoke.TILE, device="cuda")
                with torch.inference_mode():
                    got = {k: forward_ms(lambda: model(x), s)
                           for k, s in streams.items()}
                print(f"{dtype} cudnn.benchmark={bench} rows {n}: "
                      + ", ".join(f"{k} stream {v:.3f} ms"
                                  for k, v in got.items()), flush=True)
        torch.backends.cudnn.benchmark = False
        if dtype != "float32":
            continue
        for n in (4, 8):
            x = torch.randn(n, 3, smoke.TILE, smoke.TILE, device="cuda")
            with torch.inference_mode():
                model(x)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    model(x)
                    torch.cuda.synchronize()
            print(f"float32 rows {n}, top kernels:")
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=6,
                                            max_name_column_width=90))
    return 0


if __name__ == "__main__":
    sys.exit(main())

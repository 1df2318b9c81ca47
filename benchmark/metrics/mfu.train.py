"""Model FLOPs (forward and backward) of the patches stepped in the traced
train window over its wall time, as a share of the card's bf16 dense
peak (989 TFLOP/s)."""

from benchmark.counts.flops import train_flops
from benchmark.peaks import DENSE_OPS_PER_S


def read(summary):
    work, cfg = summary["work"], summary["config"]
    if not work.get("patches") or not summary.get("window_s"):
        return None
    flops = work["patches"] * train_flops(cfg, cfg["img_size"])
    return 100.0 * flops / summary["window_s"] / DENSE_OPS_PER_S["bf16"]

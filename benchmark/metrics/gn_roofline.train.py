"""The GroupNorm kernels' (``csrc/group_norm_relu.cu``, forward and
backward) share of their roofline in the traced train steps: the least
time of every FPN GroupNorm site's forward and backward over the patches
stepped (bf16 bytes at 3.35 TB/s) over the device time of the kernels
whose names these patterns match."""

from benchmark.counts.bytes import gn_backward_seconds, gn_forward_seconds
from benchmark.trace import kernel_seconds

KERNELS = ("gn_fwd_cluster_kernel", "gn_stats_kernel", "gn_apply_kernel",
           "gn_bwd_")


def read(summary):
    work, cfg = summary["work"], summary["config"]
    spent = kernel_seconds(summary, KERNELS)
    if cfg["model"] != "fpn" or not work.get("patches") or spent <= 0:
        return None
    tile, rows, steps = cfg["img_size"], work["patches"], work["steps"]
    least = (gn_forward_seconds(cfg, tile, rows, steps, 2)
             + gn_backward_seconds(cfg, tile, rows, steps, 2))
    return 100.0 * least / spent

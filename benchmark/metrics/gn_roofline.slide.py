"""The GroupNorm forward kernels' (``csrc/group_norm_relu.cu``) share of
their roofline in the traced slide window: the least time of every FPN
GroupNorm site the stitched windows need (bytes at 3.35 TB/s; bf16 in the
bf16 path, float32 in the int8 path) over the device time of the kernels
whose names these patterns match."""

from benchmark.counts.bytes import gn_forward_seconds
from benchmark.trace import kernel_seconds

FORWARD = ("gn_fwd_cluster_kernel", "gn_stats_kernel", "gn_apply_kernel")


def read(summary):
    work, tr, cfg = summary["work"], summary["traffic"], summary["config"]
    spent = kernel_seconds(summary, FORWARD)
    if cfg["model"] != "fpn" or not work.get("windows") or spent <= 0:
        return None
    itemsize = 2 if tr["precision"] == "bf16" else 4
    least = gn_forward_seconds(cfg, tr["tile"], work["windows"],
                               work["batches"], itemsize)
    return 100.0 * least / spent

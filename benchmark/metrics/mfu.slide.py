"""Model FLOPs of the windows stitched in the traced slide window (padding
windows not counted) over its wall time, as a share of the card's dense
peak in the cell's precision (bf16 989 TFLOP/s, int8 1,979 TOP/s)."""

from benchmark.counts.flops import forward_flops
from benchmark.peaks import DENSE_OPS_PER_S


def read(summary):
    work, tr = summary["work"], summary["traffic"]
    if not work.get("windows") or not summary.get("window_s"):
        return None
    flops = work["windows"] * forward_flops(summary["config"], tr["tile"])
    peak = DENSE_OPS_PER_S[tr["precision"]]
    return 100.0 * flops / summary["window_s"] / peak

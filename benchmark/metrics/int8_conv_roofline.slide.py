"""The int8 convolution kernels' (``csrc/int8_conv.cu``, with the
activation quantize of ``csrc/quantize.cu``) share of their roofline in the
traced int8 slide window.  The work: every convolution of the forward but
the head (the int8 path's quantized sites) for each stitched window; a
site's least time is the larger of its operations (2 a multiply-add) at
1,979 TOP/s and its bytes at 3.35 TB/s, counting its input and output at
one byte an element and its int8 weights once a batch.  That is the least
any int8 site can move, so the share reads low where a site stores bf16
or float32."""

from benchmark.counts.flops import conv_sites
from benchmark.peaks import DENSE_OPS_PER_S, HBM_BYTES_PER_S
from benchmark.trace import kernel_seconds

KERNELS = ("int8_conv_kernel", "quantize_nhwc_kernel",
           "quantize_strided_kernel", "quantize_s2d_kernel")


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def read(summary):
    work, tr, cfg = summary["work"], summary["traffic"], summary["config"]
    spent = kernel_seconds(summary, KERNELS)
    if tr.get("precision") != "int8" or not work.get("windows") \
            or spent <= 0:
        return None
    sites = conv_sites(cfg, tr["tile"])[:-1]  # the head stays float
    least = 0.0
    for _, x, w, y in sites:
        macs = _numel(y) * _numel(w[1:])
        ops = 2 * macs * work["windows"]
        moved = (_numel(x) + _numel(y)) * work["windows"] \
            + _numel(w) * work["batches"]
        least += max(ops / DENSE_OPS_PER_S["int8"], moved / HBM_BYTES_PER_S)
    return 100.0 * least / spent

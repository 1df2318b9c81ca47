"""The depthwise convolution kernels' share of their roofline in the
traced train steps: the least time of every depthwise site's forward,
input gradient and weight gradient over the patches stepped, over the
device time of the kernels that run those sites.

The sites are the convolutions of ``counts.flops.conv_sites`` whose
weight has one input channel.  Each pass reads one bf16 map of the site's
size and reads or writes one more (forward: x in, y out; input gradient:
dy in, dx out; weight gradient: x and dy in), 12 bytes an element over
the three, at 3.35 TB/s; the operations, 2 a multiply-add over the 3×3
taps in each pass, at the float32 peak, never bind.  PyTorch runs these
sites in bf16 with dilation through its native ``conv_depthwise2d``
kernels, which no other convolution of the step uses."""

from math import prod

from benchmark.counts.bytes import least_seconds
from benchmark.counts.flops import conv_sites
from benchmark.trace import kernel_seconds

KERNELS = ("conv_depthwise2d_",)
BYTES_PER_ELEMENT = 12  # three passes, each 2 bf16 maps of 2 bytes
OPS_PER_TAP = 6  # three passes, each a multiply-add


def read(summary):
    work, cfg = summary["work"], summary["config"]
    sites = [s for s in conv_sites(cfg, cfg["img_size"]) if s[2][1] == 1]
    spent = kernel_seconds(summary, KERNELS)
    if not sites or not work.get("patches") or spent <= 0:
        return None
    least = 0.0
    for _, _, w, y in sites:
        elems = prod(y) * work["patches"]
        least += least_seconds(BYTES_PER_ELEMENT * elems,
                               OPS_PER_TAP * prod(w[2:]) * elems)
    return 100.0 * least / spent

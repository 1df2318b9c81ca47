"""The fused augmentation kernels' (``csrc/fused_augment.cu``) share of
their roofline in the traced train steps: each batch's uint8 image and
mask read once and its bf16 image and float32 mask written once, at
3.35 TB/s, over those kernels' device time."""

from benchmark.counts.bytes import augment_seconds
from benchmark.trace import kernel_seconds

KERNELS = ("augment_stats_kernel", "augment_out_kernel")


def read(summary):
    work, cfg = summary["work"], summary["config"]
    spent = kernel_seconds(summary, KERNELS)
    if not work.get("patches") or spent <= 0:
        return None
    return 100.0 * augment_seconds(cfg["img_size"], work["patches"]) / spent

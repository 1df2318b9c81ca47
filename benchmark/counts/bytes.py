"""Least bytes and operations of the program's hand-written kernels'
work, from the configuration's shapes: each input byte read once, each
output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

from benchmark.peaks import DENSE_OPS_PER_S, HBM_BYTES_PER_S

F32_OPS_PER_S = DENSE_OPS_PER_S["fp32"]  # outside the tensor cores
GN_OPS_PER_ELEMENT = 8  # the forward: two sums, normalize, affine, ReLU
GN_BWD_OPS_PER_ELEMENT = 14  # mask, x-hat, two products and sums, apply


def least_seconds(nbytes: float, ops: float = 0.0,
                  ops_per_s: float = F32_OPS_PER_S) -> float:
    """The larger of the bytes' time at the HBM rate and the operations'
    time at ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def fpn_gn_sites(cfg: dict, tile: int) -> list:
    """``(channels, side)`` of each GroupNorm of one FPN forward: the
    segmentation block of pyramid level k (strides 32, 16, 8, 4) has
    3, 2, 1, 1 convolutions, each followed by a GroupNorm at the side it
    has reached (nearest 2× after each, up to stride 4)."""
    c = cfg["segmentation_channels"]
    sites = []
    for stride, n_up in ((32, 3), (16, 2), (8, 1), (4, 0)):
        side = tile // stride
        for _ in range(max(n_up, 1)):
            sites.append((c, side))
            side *= 2
    return sites


def gn_forward_seconds(cfg: dict, tile: int, rows: int, launches: int,
                       itemsize: int) -> float:
    """Least time of the GN forwards of ``rows`` tiles in ``launches``
    batches: x read and y written once per element, γ and β read once a
    launch, float32 arithmetic."""
    total = 0.0
    for c, side in fpn_gn_sites(cfg, tile):
        elems = rows * c * side * side
        total += least_seconds(2 * elems * itemsize + launches * 2 * c * 4,
                               GN_OPS_PER_ELEMENT * elems)
    return total


def gn_backward_seconds(cfg: dict, tile: int, rows: int, launches: int,
                        itemsize: int) -> float:
    """Least time of the GN backwards: dy, x and y read and dx written once
    per element; γ read and dγ, dβ written once a launch."""
    total = 0.0
    for c, side in fpn_gn_sites(cfg, tile):
        elems = rows * c * side * side
        total += least_seconds(4 * elems * itemsize + launches * 3 * c * 4,
                               GN_BWD_OPS_PER_ELEMENT * elems)
    return total


def augment_seconds(tile: int, rows: int) -> float:
    """Least time of the fused augmentation of ``rows`` tiles: the uint8
    image (3 bytes a pixel) and mask (1) read once, the bfloat16 image (6)
    and float32 mask (4) written once."""
    return (rows * tile * tile * (3 + 1 + 6 + 4)) / HBM_BYTES_PER_S

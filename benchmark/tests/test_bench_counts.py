"""The benchmark's counts of FLOPs and bytes against hand counts."""

from __future__ import annotations

import pytest

from benchmark.counts import bytes as nbytes
from benchmark.counts import flops
from benchmark.tests.conftest import configs


def conv(cin, cout, k, side_out):
    return 2 * cin * cout * k * k * side_out * side_out


def resnet18_flops(tile):
    """The encoder by hand: the 7×7/2 stem, then per stage two basic
    blocks of two 3×3 convolutions (and a 1×1/2 downsample from stage 2)."""
    total = conv(3, 64, 7, tile // 2)
    cin = 64
    for i, c in enumerate((64, 128, 256, 512)):
        side = tile // (4 * 2 ** i)
        total += conv(cin, c, 3, side) + 3 * conv(c, c, 3, side)
        if cin != c:
            total += conv(cin, c, 1, side)
        cin = c
    return total


def fpn_decoder_flops(tile):
    s = [tile // 32, tile // 16, tile // 8, tile // 4]  # p5..p2 sides
    total = conv(512, 256, 1, s[0]) + conv(256, 256, 1, s[1]) \
        + conv(128, 256, 1, s[2]) + conv(64, 256, 1, s[3])
    for side, n_up in zip(s, (3, 2, 1, 0)):
        total += conv(256, 128, 3, side)
        for j in range(1, n_up):
            total += conv(128, 128, 3, side * 2 ** j)
    return total + conv(128, 1, 1, tile // 4)


def resunet_decoder_flops(tile):
    total = 0
    for cin, c, skip, side in ((512, 256, 256, tile // 16),
                               (256, 128, 128, tile // 8),
                               (128, 64, 64, tile // 4)):
        # 2×2/2 transposed conv: one multiply-add a weight a input pixel
        total += 2 * cin * c * 4 * (side // 2) ** 2
        total += conv(c + skip, c, 3, side)
    return total + conv(64, 1, 1, tile // 4)


@pytest.mark.parametrize("name,decoder", [("fpn_r18", fpn_decoder_flops),
                                          ("resunet_r18",
                                           resunet_decoder_flops)])
@pytest.mark.parametrize("tile", [64, 512])
def test_forward_flops_are_the_hand_count(name, decoder, tile):
    cfg = configs()[name]
    assert flops.forward_flops(cfg, tile) == resnet18_flops(tile) \
        + decoder(tile)


def test_published_sizes_and_backward():
    """35.5 and 27.0 GFLOP a 512² tile; the backward counts both gradients
    of every convolution but the stem's input gradient."""
    fpn, unet = configs()["fpn_r18"], configs()["resunet_r18"]
    assert round(flops.forward_flops(fpn, 512) / 1e9, 1) == 35.5
    assert round(flops.forward_flops(unet, 512) / 1e9, 1) == 27.0
    stem = conv(3, 64, 7, 256)
    for cfg in (fpn, unet):
        fwd = flops.forward_flops(cfg, 512)
        assert flops.train_flops(cfg, 512) == 3 * fwd - stem


def test_gn_sites_and_bounds():
    """FPN's seven GroupNorm sites at a 512² tile, and the bounds of the
    kernel table: 128×128×64² bf16 = 0.0801 ms at 3.35 TB/s (x read and y
    written), and seven sites at 128 rows = 0.606 ms."""
    cfg = configs()["fpn_r18"]
    assert sorted(nbytes.fpn_gn_sites(cfg, 512)) == sorted(
        [(128, 16), (128, 32), (128, 32), (128, 64), (128, 64), (128, 64),
         (128, 128)])
    one = nbytes.least_seconds(2 * 128 * 128 * 64 * 64 * 2 + 2 * 128 * 4,
                               8 * 128 * 128 * 64 * 64)
    assert round(one * 1e3, 4) == 0.0801
    assert round(nbytes.gn_forward_seconds(cfg, 512, 128, 1, 2) * 1e3,
                 3) == 0.606
    # the backward: 4 tensors an element; 32×128×128² bf16 = 0.1603 ms
    bwd = nbytes.least_seconds(4 * 32 * 128 * 128 * 128 * 2 + 3 * 128 * 4)
    assert round(bwd * 1e3, 4) == 0.1603


def test_augment_bound():
    """32 rows of 512²: 3 + 1 bytes read and 6 + 4 written a pixel,
    0.0351 ms at 3.35 TB/s."""
    assert round(nbytes.augment_seconds(512, 32) * 1e3, 4) == 0.0351

"""The port's ``generate_synthetic_patches`` against the JAX package's: the
same file names and the same pixels (the PNGs decoded; the port encodes
them on a thread pool) for binary and 3-class fixtures, at 64² and at an
odd size, and the same return value."""

import os

import numpy as np
import pytest
from PIL import Image

from pdac_pathological_image_segmentation_tpu.data.synthetic import (
    generate_synthetic_patches as jax_generate,
)
from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
    generate_synthetic_patches,
)


@pytest.mark.parametrize("size", [64, 45])
@pytest.mark.parametrize("num_classes,tumor_fraction,seed",
                         [(1, 0.8, 0), (1, 0.4, 5), (3, 0.8, 3)])
def test_patches_equal_jax(tmp_path, size, num_classes, tumor_fraction,
                           seed):
    kw = dict(n=7, size=size, seed=seed, tumor_fraction=tumor_fraction,
              num_classes=num_classes)
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert generate_synthetic_patches(str(ours), **kw) == (7, 7)
    assert jax_generate(str(ref), **kw) == (7, 7)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and len(names) == 14
    labels = set()
    for name in names:
        a = np.asarray(Image.open(ours / name))
        b = np.asarray(Image.open(ref / name))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        if name.endswith("-labelled.png"):
            assert a.shape == (size, size)
            labels |= set(np.unique(a).tolist())
        else:
            assert a.shape == (size, size, 3)
    # the fixture's labels: 0/1, or 0..num_classes-1
    assert labels <= set(range(max(2, num_classes)))
    assert max(labels) == max(1, num_classes - 1)


def test_same_seed_repeats_and_another_differs(tmp_path):
    generate_synthetic_patches(str(tmp_path / "a"), n=2, size=32, seed=1)
    generate_synthetic_patches(str(tmp_path / "b"), n=2, size=32, seed=1)
    generate_synthetic_patches(str(tmp_path / "c"), n=2, size=32, seed=2)
    name = "patch_0001.png"
    a, b, c = (np.asarray(Image.open(tmp_path / d / name)) for d in "abc")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)

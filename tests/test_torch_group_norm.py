"""GroupNorm+ReLU of the PyTorch port (``ops/group_norm.py``) against the
JAX package's Pallas kernels, run in interpret mode, and its plain XLA
reference.

The port's CUDA kernel runs only on the card (``chip_smoke.py`` holds it
against the plain version there); here the CPU path, which is the plain
version, is held against both Pallas branches — the VMEM-resident
``_gn_relu_kernel`` and the DMA-ring ``_gn_relu_dma_kernel`` (blocks over
15 MiB) — and the kernel's launch plan and split-merge arithmetic are
checked on the host.

Bounds: f32 ``rtol=atol=1e-5`` (the Pallas-vs-reference bound of
``tests/test_pallas_ops.py``); bf16, compared in f32, ``rtol=2**-7,
atol=1e-5`` (one bf16 ulp) with at least 99.9% of elements bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.ops.pallas.group_norm import (
    group_norm_relu as pallas_group_norm_relu,
    xla_group_norm_relu,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
    group_norm_relu,
    group_norm_relu_reference,
    launch_plan,
)

# (NHWC shape, groups, relu, dtype); the last two take the Pallas DMA branch
CASES = {
    "vmem_f32": ((2, 16, 16, 128), 32, True, "float32"),
    "vmem_bf16": ((2, 16, 16, 128), 32, True, "bfloat16"),
    "no_relu": ((1, 8, 8, 64), 16, False, "float32"),
    "dma_f32": ((1, 64, 64, 256), 32, True, "float32"),
    "dma_bf16": ((2, 128, 128, 128), 32, True, "bfloat16"),
}
EPS = 1e-6  # the Pallas kernel's default, passed explicitly to both sides


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        # round once through bf16 so both frameworks see identical inputs
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x, gamma, beta


def _port(x, gamma, beta, groups, relu, dtype):
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    xt = xt.to(getattr(torch, dtype))
    out = group_norm_relu(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                          num_groups=groups, eps=EPS, relu=relu)
    assert out.dtype == xt.dtype
    return out.float().numpy().transpose(0, 2, 3, 1)


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)
    same = np.mean(got == want)
    assert same >= 0.999, f"only {same:.5f} of bf16 elements bit-identical"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    shape, groups, relu, dtype = CASES[case]
    x, gamma, beta = _inputs(shape, dtype, seed=len(case))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = pallas_group_norm_relu(jnp.asarray(x, jdt), jnp.asarray(gamma),
                                 jnp.asarray(beta), num_groups=groups,
                                 eps=EPS, relu=relu, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    _assert_close(_port(x, gamma, beta, groups, relu, dtype), ref, dtype)
    if not relu:
        assert ref.min() < 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_reference(case):
    shape, groups, relu, dtype = CASES[case]
    x, gamma, beta = _inputs(shape, dtype, seed=7 + len(case))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = xla_group_norm_relu(jnp.asarray(x, jdt), jnp.asarray(gamma),
                              jnp.asarray(beta), num_groups=groups, eps=EPS,
                              relu=relu)
    ref = np.asarray(ref.astype(jnp.float32))
    _assert_close(_port(x, gamma, beta, groups, relu, dtype), ref, dtype)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    x, gamma, beta = _inputs((2, 8, 8, 64), "float32", seed=3)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    before = group_norm_relu.launches
    by_shape = dict(group_norm_relu.launches_by_shape)
    out = group_norm_relu(xt, g, b, num_groups=16, eps=1e-5)
    assert group_norm_relu.launches == before
    assert group_norm_relu.launches_by_shape == by_shape
    assert torch.equal(out, group_norm_relu_reference(xt, g, b, 16, 1e-5))


def test_rejects_bad_shapes():
    x = torch.zeros(1, 48, 4, 4)
    with pytest.raises(ValueError, match="multiple of num_groups"):
        group_norm_relu(x, torch.ones(48), torch.zeros(48), num_groups=32)
    with pytest.raises(ValueError, match="NCHW"):
        group_norm_relu(torch.zeros(4, 4), torch.ones(4), torch.zeros(4))


# the FPN@512 sites at the served buckets, plus ragged and unaligned shapes
PLAN_SHAPES = [(n, 128, hw, 32) for n in (1, 8, 32)
               for hw in (16 ** 2, 32 ** 2, 64 ** 2, 128 ** 2)]
PLAN_SHAPES += [(3, 64, 7 * 7, 16), (2, 96, 10 * 10, 32)]


@pytest.mark.parametrize("itemsize", [4, 2])
def test_launch_plan_covers_every_span(itemsize):
    for n, c, hw, g in PLAN_SHAPES:
        for aligned in (True, False):
            vec, splits, chunk = launch_plan(n, c, hw, g, itemsize, aligned,
                                             sm_count=132)
            span = (c // g) * hw
            assert vec in (1, 16 // itemsize)
            if vec > 1:
                assert aligned and hw % vec == 0 and chunk % vec == 0
            assert 1 <= splits <= 65535
            # the splits tile the span exactly, none empty
            assert (splits - 1) * chunk < span <= splits * chunk


def test_split_merge_matches_centred_variance():
    """The kernel's statistics, emulated on the host: per-split (count,
    mean, M2) partials merged in order with Chan's formula equal the
    centred mean/variance of the span."""
    rng = np.random.default_rng(11)
    n, c, hw, g = 1, 128, 128 * 128, 32
    _, splits, chunk = launch_plan(n, c, hw, g, 2, True, sm_count=132)
    assert splits > 1
    span = rng.normal(3.0, 2.0, size=(c // g) * hw).astype(np.float32)
    acc = (0.0, 0.0, 0.0)
    for s in range(splits):
        part = span[s * chunk:(s + 1) * chunk].astype(np.float64)
        b = (float(part.size), part.mean(), ((part - part.mean()) ** 2).sum())
        tot = acc[0] + b[0]
        wb = b[0] / tot
        d = b[1] - acc[1]
        acc = (tot, acc[1] + d * wb, acc[2] + b[2] + d * d * acc[0] * wb)
    np.testing.assert_allclose(acc[1], span.mean(dtype=np.float64),
                               rtol=1e-12)
    np.testing.assert_allclose(acc[2] / acc[0], span.var(dtype=np.float64),
                               rtol=1e-12)

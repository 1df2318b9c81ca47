"""GroupNorm+ReLU of the PyTorch port (``ops/group_norm.py``) against the
JAX package's Pallas kernels, run in interpret mode, and its plain XLA
reference.

The port's CUDA kernels run only on the card (``chip_smoke.py`` holds
both designs against the plain version there); here the CPU path, which is
the plain version, is held against both Pallas branches — the
VMEM-resident ``_gn_relu_kernel`` and the DMA-ring ``_gn_relu_dma_kernel``
(blocks over 15 MiB) — and the kernels' launch plans and merge arithmetic
are checked on the host: the streaming design's split plan and Chan merge,
the cluster design's plan and, emulated on the host, its statistics
(per-share sums and centred sums of squares, added in rank order) and its
backward (per-channel partials of each share, added in rank order, also
where a channel's plane spans several blocks).  The backward,
``GroupNormReLUFunction``, is held against ``jax.grad`` through the
Pallas custom VJP and through the plain XLA reference.

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
    group_norm_relu_trainable as group_norm_relu_trainable_jax,
    xla_group_norm_relu,
)
from pdac_pathological_image_segmentation_tpu_torch.ops import (
    group_norm as gn,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
    CLUSTER_SIZES,
    SMEM_BUDGET,
    SMEM_LIMIT,
    GroupNormReLUFunction,
    cluster_plan,
    group_norm_plan,
    group_norm_relu,
    group_norm_relu_backward_reference,
    group_norm_relu_reference,
    group_norm_relu_trainable,
    group_stats_reference,
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


# -- the cluster design's plan -------------------------------------------------

# the FPN@512 sites at the served buckets and at the config's batch (128),
# plus ragged and unaligned-plane shapes
CLUSTER_SHAPES = PLAN_SHAPES + [(128, 128, hw, 32) for hw in
                                (16 ** 2, 32 ** 2, 64 ** 2, 128 ** 2)]


@pytest.mark.parametrize("tensors", [1, 2], ids=["fwd", "bwd"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_plan_tiles_each_span(shape, itemsize, tensors):
    """K is a portable cluster size; each block's share is a whole number
    of 16-byte vectors that fits the budget (once per kept input), the K
    shares tile the span exactly, the block's shared memory fits one
    block's limit; planes that are not whole vectors (7x7, 10x10 in bf16)
    take the streaming design."""
    n, c, hw, g = shape
    span = (c // g) * hw
    plan = cluster_plan(n, c, hw, g, itemsize, True, 132, tensors)
    if (hw * itemsize) % 16:
        assert plan is None
        got = group_norm_plan(n, c, hw, g, itemsize, True, 132, tensors)
        assert got.variant == "streaming"
        return
    k, threads, smem = plan
    assert k in CLUSTER_SIZES
    share = span // k
    assert share * k == span
    assert (share * itemsize) % 16 == 0
    assert tensors * share * itemsize <= SMEM_BUDGET
    assert smem <= SMEM_LIMIT and threads % 32 == 0 and 64 <= threads <= 256
    # the shares, in rank order, cover [0, span) once
    bounds = [(r * share, (r + 1) * share) for r in range(k)]
    assert bounds[0][0] == 0 and bounds[-1][1] == span
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # a larger K only where a smaller one leaves the card short of blocks
    if k > 1 and tensors * span * itemsize <= (k // 2) * SMEM_BUDGET:
        assert n * g * k <= 2 * 132


@pytest.mark.parametrize("shape,itemsize,tensors,want", [
    ((32, 128, 128 ** 2, 32), 2, 1, 2),  # 128 KiB span: 64 KiB shares
    ((32, 128, 128 ** 2, 32), 4, 1, 4),  # 256 KiB
    ((1, 128, 16 ** 2, 32), 2, 1, 8),  # 2 KiB span, 32 spans: 256 blocks
    ((32, 128, 128 ** 2, 32), 2, 2, 4),  # dy and x: 2 x 128 KiB
    ((128, 128, 128 ** 2, 32), 2, 2, 4),
    ((32, 128, 128 ** 2, 32), 4, 2, 8),  # f32: K > cg, planes split
], ids=["fwd_bf16_32x128", "fwd_f32_32x128", "fwd_bf16_1x16",
        "bwd_bf16_32x128", "bwd_bf16_128x128", "bwd_f32_32x128"])
def test_cluster_plan_worked_examples(shape, itemsize, tensors, want):
    assert cluster_plan(*shape, itemsize, True, 132, tensors)[0] == want


@pytest.mark.parametrize("tensors", [1, 2], ids=["fwd", "bwd"])
def test_streaming_plan_for_unaligned_and_oversized(tensors):
    """Unaligned tensors and spans over 8 budgets take the streaming
    design (``launch_plan``'s grid)."""
    for shape, aligned in (((32, 128, 64 ** 2, 32), False),
                           ((1, 128, 512 ** 2, 32), True)):
        plan = group_norm_plan(*shape, 2, aligned, 132, tensors)
        assert plan.variant == "streaming"
        assert (plan.vec, plan.splits, plan.chunk) == launch_plan(
            *shape, 2, aligned, 132)


def test_plan_cache_tells_aligned_from_unaligned(monkeypatch):
    monkeypatch.setattr(gn, "_sm_count", lambda device: 132)
    monkeypatch.setattr(gn, "_plans", {})
    x = torch.zeros(32, 128, 64, 64, dtype=torch.bfloat16)
    cached = gn._plan_for(x, 32, True, 1)
    assert cached.variant == "cluster" and cached.cluster == 1
    assert gn._plan_for(x, 32, False, 1).variant == "streaming"
    assert gn._plan_for(x, 32, True, 1) is cached
    assert gn._plan_for(x, 32, True, 2) != cached  # the backward's own
    assert len(gn._plans) == 3


def _cluster_forward_emulated(x, gamma, beta, groups, eps, relu, k):
    """The cluster forward's arithmetic on the host, in f32: per-share sums
    added in rank order into the mean, then per-share centred sums of
    squares added in rank order into M2; y = x*scale + shift."""
    n, c, h, w = x.shape
    xs = x.float().reshape(n * groups, k, -1)
    span = xs.shape[1] * xs.shape[2]
    total = torch.zeros(n * groups)
    for r in range(k):
        total = total + xs[:, r].sum(dim=1)
    mean = total / span
    m2 = torch.zeros(n * groups)
    for r in range(k):
        m2 = m2 + (xs[:, r] - mean[:, None]).square().sum(dim=1)
    rstd = torch.rsqrt(m2 / span + eps)
    scale = gamma.view(1, groups, -1) * rstd.view(n, groups, 1)
    shift = beta.view(1, groups, -1) - mean.view(n, groups, 1) * scale
    y = x.float() * scale.reshape(n, c, 1, 1) + shift.reshape(n, c, 1, 1)
    return (torch.relu(y) if relu else y).to(x.dtype)


@pytest.mark.parametrize("ref", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("case", ["vmem_f32", "vmem_bf16", "dma_f32",
                                  "dma_bf16"])
def test_cluster_statistics_emulated(case, ref):
    """The cluster statistics, at the K the plan gives the shape (always
    above 1 here), against the plain version and the Pallas kernel
    (interpret), at the bounds of the tests above."""
    shape, groups, relu, dtype = CASES[case]
    x, gamma, beta = _inputs(shape, dtype, seed=21 + len(case))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    xt = xt.to(getattr(torch, dtype))
    n, c, h, w = xt.shape
    k = cluster_plan(n, c, h * w, groups, xt.element_size(), True, 132)[0]
    assert k > 1
    got = _cluster_forward_emulated(xt, torch.from_numpy(gamma),
                                    torch.from_numpy(beta), groups, EPS,
                                    relu, k)
    got = got.float().numpy().transpose(0, 2, 3, 1)
    if ref == "reference":
        want = _port(x, gamma, beta, groups, relu, dtype)
    else:
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        want = np.asarray(pallas_group_norm_relu(
            jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta),
            num_groups=groups, eps=EPS, relu=relu,
            interpret=True).astype(jnp.float32))
    _assert_close(got, want, dtype)


def _cluster_backward_emulated(dy, x, gamma, out, stats, groups, k):
    """The cluster backward's arithmetic on the host, in f32: each block's
    share sums masked dy and dy*xhat per channel (a channel split across
    blocks where K > cg), the K shares' sums are added in rank order, then
    m1, m2 and dx; dgamma, dbeta add the per-(n, c) sums over n in order."""
    n, c, h, w = x.shape
    cg, hw = c // groups, h * w
    span = cg * hw
    share = span // k
    d = (dy.float() * (out > 0)).reshape(n * groups, span)
    mean = stats[..., 0].reshape(-1, 1)
    rstd = stats[..., 1].reshape(-1, 1)
    xhat = (x.float().reshape(n * groups, span) - mean) * rstd
    chan = torch.zeros(n * groups, cg, 2)
    for r in range(k):
        part = torch.zeros(n * groups, cg, 2)
        for ch in range(cg):
            lo, hi = max(r * share, ch * hw), min((r + 1) * share,
                                                  (ch + 1) * hw)
            if lo < hi:
                part[:, ch, 0] = d[:, lo:hi].sum(dim=1)
                part[:, ch, 1] = (d[:, lo:hi] * xhat[:, lo:hi]).sum(dim=1)
        chan = chan + part
    gam = gamma.float().reshape(groups, cg).repeat(n, 1)
    a1, a2 = torch.zeros(n * groups), torch.zeros(n * groups)
    for ch in range(cg):
        a1 = a1 + gam[:, ch] * chan[:, ch, 0]
        a2 = a2 + gam[:, ch] * chan[:, ch, 1]
    gc = gam.repeat_interleave(hw, dim=1)
    dx = (d * gc - (a1 / span)[:, None] - xhat * (a2 / span)[:, None]) * rstd
    sums = chan.reshape(n, c, 2)
    dgamma, dbeta = torch.zeros(c), torch.zeros(c)
    for i in range(n):
        dbeta = dbeta + sums[i, :, 0]
        dgamma = dgamma + sums[i, :, 1]
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


@pytest.mark.parametrize("ref", ["reference", "jax_grad_interpret"])
@pytest.mark.parametrize("shape", [(2, 64, 8, 8), (2, 128, 16, 16),
                                   (1, 64, 32, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_backward_emulated(shape, ref):
    """The cluster backward's per-channel merge, at the K the plan gives
    the shape (above cg, so planes split across blocks, in the first and
    last), against the plain backward and ``jax.grad`` through the Pallas
    custom VJP (interpret), f32, ``rtol=atol=1e-4``."""
    import jax

    n, c, h, w = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    xt, gt, bt = map(torch.from_numpy, (x, gamma, beta))
    k = cluster_plan(n, c, h * w, 32, 4, True, 132, tensors=2)[0]
    assert k > 1
    stats = group_stats_reference(xt, 32, 1e-5)
    out = group_norm_relu_reference(xt, gt, bt, 32, 1e-5)
    got = _cluster_backward_emulated(torch.from_numpy(dy), xt, gt, out, stats,
                                     32, k)
    if ref == "reference":
        want = group_norm_relu_backward_reference(torch.from_numpy(dy), xt,
                                                  gt, out, stats, 32)
        want = [t.numpy() for t in want]
    else:
        dy_nhwc = jnp.asarray(dy.transpose(0, 2, 3, 1))

        def loss(xv, g, b):
            return jnp.sum(group_norm_relu_trainable_jax(
                xv, g, b, 32, 1e-5, True, True) * dy_nhwc)

        gx, gg, gb = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(gamma),
            jnp.asarray(beta))
        want = [np.asarray(gx).transpose(0, 3, 1, 2), np.asarray(gg),
                np.asarray(gb)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)


def test_cluster_backward_splits_planes():
    """At least one plan above splits a channel's plane across blocks
    (K > cg), and one keeps several channels in a block (K < cg)."""
    k1 = cluster_plan(2, 64, 64, 32, 4, True, 132, tensors=2)[0]
    k2 = cluster_plan(32, 128, 64 ** 2, 32, 2, True, 132, tensors=2)[0]
    assert k1 > 64 // 32 and k2 < 128 // 32


# -- the backward (``GroupNormReLUFunction``) --------------------------------

def _grad_inputs(seed, dtype="float32"):
    """x (2, 64, 8, 8) NCHW, the shapes of ``tests/test_pallas_ops.py``'s
    trainable-grad test, and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 64, 8, 8)).astype(np.float32)
    gamma = (rng.normal(size=64) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=64) * 0.1).astype(np.float32)
    dy = rng.normal(size=(2, 64, 8, 8)).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
        dy = torch.from_numpy(dy).bfloat16().float().numpy()
    return x, gamma, beta, dy


def _port_grads(x, gamma, beta, dy, eps, dtype="float32", relu=True):
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    g = torch.from_numpy(gamma).requires_grad_()
    b = torch.from_numpy(beta).requires_grad_()
    out = GroupNormReLUFunction.apply(xt, g, b, 32, eps, relu)
    assert out.grad_fn is not None and out.dtype == xt.dtype
    out.backward(torch.from_numpy(dy).to(xt.dtype))
    return xt.grad, g.grad, b.grad


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_backward_matches_jax_grad(eps, ref):
    """``jax.grad`` through the Pallas custom VJP (interpret mode) or
    through the plain ``xla_group_norm_relu``, against the port's plain
    backward, at the bound of ``tests/test_pallas_ops.py``'s trainable-grad
    test, ``rtol=atol=1e-4``."""
    import jax

    x, gamma, beta, dy = _grad_inputs(seed=int(eps * 1e6))
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    dy_nhwc = jnp.asarray(dy.transpose(0, 2, 3, 1))

    def loss(xv, g, b):
        if ref == "xla":
            y = xla_group_norm_relu(xv, g, b, num_groups=32, eps=eps)
        else:
            y = group_norm_relu_trainable_jax(xv, g, b, 32, eps, True, True)
        return jnp.sum(y * dy_nhwc)

    want = jax.grad(loss, argnums=(0, 1, 2))(x_nhwc, jnp.asarray(gamma),
                                             jnp.asarray(beta))
    dx, dg, db = _port_grads(x, gamma, beta, dy, eps)
    assert dx.dtype == torch.float32 and dg.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dg.numpy(), np.asarray(want[1]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=1e-4,
                               atol=1e-4)


def test_backward_bf16_types_and_values():
    """bf16 in: dx comes back in bf16, dgamma and dbeta in f32.  Against
    the f32 backward on the same (bf16-representable) inputs: dgamma and
    dbeta within 2e-2 (f32 sums of the same products; the bf16 forward
    output moves the ReLU mask where it rounds to zero), dx within one bf16
    rounding of its value (rtol 2**-7, atol 1e-3) on at least 99.5% of the
    elements (the rest are where the mask moved)."""
    x, gamma, beta, dy = _grad_inputs(seed=4, dtype="bfloat16")
    dx, dg, db = _port_grads(x, gamma, beta, dy, 1e-5, dtype="bfloat16")
    assert dx.dtype == torch.bfloat16
    assert dg.dtype == db.dtype == torch.float32
    fx, fg, fb = _port_grads(x, gamma, beta, dy, 1e-5)
    close = np.isclose(dx.float().numpy(), fx.numpy(), rtol=2 ** -7,
                       atol=1e-3)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(db.numpy(), fb.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dg.numpy(), fg.numpy(), rtol=2e-2, atol=2e-2)


def test_backward_without_relu_and_reference_stats():
    """``relu=False`` differentiates plain GroupNorm: the backward
    reference from the forward's saved ``[mean, rstd]`` against autograd
    through ``group_norm_relu_reference``."""
    x, gamma, beta, dy = _grad_inputs(seed=9)
    dx, dg, db = _port_grads(x, gamma, beta, dy, 1e-5, relu=False)
    xt = torch.from_numpy(x).requires_grad_()
    g = torch.from_numpy(gamma).requires_grad_()
    b = torch.from_numpy(beta).requires_grad_()
    group_norm_relu_reference(xt, g, b, 32, 1e-5, relu=False).backward(
        torch.from_numpy(dy))
    for got, want in ((dx, xt.grad), (dg, g.grad), (db, b.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
    stats = torch.empty(2, 32, 2)
    group_norm_relu(torch.from_numpy(x), g.detach(), b.detach(), 32, 1e-5,
                    stats=stats)
    assert torch.equal(stats, group_stats_reference(torch.from_numpy(x), 32,
                                                    1e-5))


def test_gn_carries_a_grad_fn_only_when_a_gradient_is_wanted():
    """The repaired fault: a GroupNorm input that needs a gradient gives
    an output with a ``grad_fn`` (the kernel's output alone had none and
    cut the graph on the card); without one (serving) the forward runs
    alone."""
    x = torch.randn(2, 64, 4, 4, requires_grad=True)
    g, b = torch.ones(64), torch.zeros(64)
    assert group_norm_relu_trainable(x, g, b).grad_fn is not None
    with torch.no_grad():
        assert group_norm_relu_trainable(x, g, b).grad_fn is None
    assert group_norm_relu_trainable(x.detach(), g, b).grad_fn is None

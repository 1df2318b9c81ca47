"""Fused per-sample GroupNorm + ReLU on contiguous NCHW, and its backward.

The counterpart of the JAX package's ``ops/pallas/group_norm.py``.  On a
CUDA tensor :func:`group_norm_relu` launches a hand-written Hopper kernel
of ``csrc/group_norm_relu.cu`` (which replaces both Pallas kernels,
``_gn_relu_kernel`` and ``_gn_relu_dma_kernel``); on a CPU tensor it runs
:func:`group_norm_relu_reference`, the plain version with the centred f32
math of the JAX package's ``xla_group_norm_relu``.  There is no fallback:
on a CUDA tensor the kernel runs or the call raises.

The source holds two designs of each kernel, and :func:`group_norm_plan`
picks one from the shape alone (cached per shape, dtype, alignment and
device): the **cluster** design, one thread-block cluster of K blocks per
(n, group) span that reads each input from device memory once into shared
memory (:func:`cluster_plan` gives K), wherever a share fits the
shared-memory budget and is made of 16-byte vectors; else the
**streaming** design, two passes over device memory
(:func:`launch_plan`).  A launch the card refuses raises.

:class:`GroupNormReLUFunction` is the counterpart of the custom VJP
``group_norm_relu_trainable``: the forward above, and a backward with the
math of ``_gn_trainable_bwd`` (:func:`group_norm_relu_backward`, a second
kernel in the same source; plain version
:func:`group_norm_relu_backward_reference`).  The model's GroupNorm goes
through it, so that autograd follows the kernel.

Groups are contiguous: channel ``c`` belongs to group ``c // (C / G)``.
Statistics are taken in f32 and the result is stored in ``x``'s dtype.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_SOURCE = "group_norm_relu.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_THREADS = 256  # kThreads of the streaming kernels
# the cluster kernels (csrc/group_norm_relu.cu)
CLUSTER_SIZES = (1, 2, 4, 8)  # portable cluster sizes
SMEM_BUDGET = 64 * 1024  # input bytes a block keeps: three blocks fit an SM
SMEM_LIMIT = 232448  # 227 KB, the most dynamic shared memory of one block
_CHUNK_BYTES = 16384  # kChunkBytes: one bulk copy
_MAX_CHUNKS = 8  # kMaxChunks
_MAX_THREADS = 256  # kMaxThreads; a block has a thread per 8 vectors
_sm_counts: dict = {}
_plans: dict = {}
_fns = None


def group_norm_relu_reference(x: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, num_groups: int = 32,
                              eps: float = 1e-5,
                              relu: bool = True) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+ReLU): centred f32 statistics, cast back to
    ``x``'s dtype (the JAX package's ``xla_group_norm_relu`` in NCHW)."""
    n, c, h, w = x.shape
    xf = x.float().reshape(n, num_groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    y = y * gamma.float().view(1, c, 1, 1) + beta.float().view(1, c, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def group_stats_reference(x: torch.Tensor, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """(N, G, 2) float32 ``[mean, rstd]`` of each (n, group) span, as
    :func:`group_norm_relu_reference` takes them (centred f32 variance)."""
    n = x.shape[0]
    xf = x.float().reshape(n, num_groups, -1)
    mean = xf.mean(dim=2)
    var = (xf - mean[..., None]).square().mean(dim=2)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=2)


def group_norm_relu_backward_reference(dy: torch.Tensor, x: torch.Tensor,
                                       gamma: torch.Tensor, out: torch.Tensor,
                                       stats: torch.Tensor,
                                       num_groups: int = 32,
                                       relu: bool = True):
    """Plain PyTorch backward of GroupNorm(+ReLU): ``(dx, dgamma, dbeta)``
    from the forward's input, scale, output and (N, G, 2) ``[mean, rstd]``
    — the math of the JAX package's ``_gn_trainable_bwd`` in NCHW.  ``dx``
    is in ``x``'s dtype, ``dgamma``/``dbeta`` float32."""
    n, c, h, w = x.shape
    g, cg = num_groups, c // num_groups
    dyf = dy.float()
    if relu:
        # pre-ReLU zero crossings are measure-zero: mask on the saved output
        dyf = dyf * (out > 0)
    mean = stats[..., 0].reshape(n, g, 1, 1)
    rstd = stats[..., 1].reshape(n, g, 1, 1)
    xhat = (x.float().reshape(n, g, cg, h * w) - mean) * rstd
    dyr = dyf.reshape(n, g, cg, h * w)
    dgamma = (dyr * xhat).sum(dim=(0, 3)).reshape(c)
    dbeta = dyr.sum(dim=(0, 3)).reshape(c)
    dxhat = dyr * gamma.float().view(1, g, cg, 1)
    m1 = dxhat.mean(dim=(2, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(2, 3), keepdim=True)
    dx = ((dxhat - m1 - xhat * m2) * rstd).reshape(n, c, h, w)
    return dx.to(x.dtype), dgamma, dbeta


class _Fns(NamedTuple):
    fwd_streaming: object
    bwd_streaming: object
    fwd_cluster: object
    bwd_cluster: object
    occupancy: object


def _lib() -> _Fns:
    """The library's C functions, with their ``argtypes``, resolved once."""
    global _fns
    if _fns is None:
        from pdac_pathological_image_segmentation_tpu_torch.ops import _build

        lib = _build.load(_SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sigs = {
            "pdac_group_norm_relu": [p] * 6 + [i] * 6 + [f, i, i, i, p],
            "pdac_group_norm_relu_bwd": [p] * 9 + [i] * 9 + [p],
            "pdac_gn_fwd_cluster": [p] * 5 + [i] * 6 + [f, i, i, p],
            "pdac_gn_bwd_cluster": [p] * 9 + [i] * 8 + [p],
            "pdac_gn_cluster_occupancy": [i] * 8 + [ctypes.POINTER(i)],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _fns = _Fns(*(getattr(lib, name) for name in sigs))
    return _fns


def _check_param(name: str, t: torch.Tensor, x: torch.Tensor, c: int):
    if t.device != x.device or t.dtype != torch.float32 \
            or t.shape != (c,) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 ({c},) tensor on "
            f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_stats(stats: torch.Tensor, x: torch.Tensor, num_groups: int):
    want = (x.shape[0], num_groups, 2)
    if stats.device != x.device or stats.dtype != torch.float32 \
            or tuple(stats.shape) != want or not stats.is_contiguous():
        raise ValueError(
            f"stats must be a contiguous float32 {want} tensor on "
            f"{x.device}, got {stats.dtype} {tuple(stats.shape)} on "
            f"{stats.device}")


def _count(fn, x: torch.Tensor, relu: bool, variant: str) -> None:
    n, c, h, w = x.shape
    key = (n, c, h, w, _DTYPE_NAMES[x.dtype], bool(relu))
    fn.launches += 1
    fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1
    vkey = (variant, *key)
    fn.launches_by_variant[vkey] = fn.launches_by_variant.get(vkey, 0) + 1


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def launch_plan(n: int, c: int, hw: int, num_groups: int, itemsize: int,
                aligned: bool, sm_count: int):
    """(vec, splits, chunk) for the streaming kernels' (N*G, splits) grid.

    ``vec`` is 16 bytes' worth of elements when the tensor is 16-byte
    aligned and every channel plane is a whole number of vectors, else 1.
    Spans are split until about four blocks per SM are in flight, but no
    block gets fewer than four vector loads per thread."""
    span = (c // num_groups) * hw
    vec = 16 // itemsize
    if not aligned or hw % vec:
        vec = 1
    rows = n * num_groups
    per_block = _THREADS * vec * 4
    want = -(-4 * sm_count // rows)
    splits = max(1, min(want, span // per_block, 65535))
    chunk = -(-span // splits)
    chunk = -(-chunk // vec) * vec
    splits = -(-span // chunk)
    return vec, splits, chunk


def cluster_smem(share_bytes: int, cg: int, threads: int,
                 tensors: int) -> int:
    """Dynamic shared memory of a cluster block (``cluster_shape`` in the
    source): the shares of ``tensors`` inputs, then the forward's per-
    channel scale and shift, or the backward's per-thread channel partials
    and two per-channel sums."""
    if tensors == 1:
        return share_bytes + 8 * cg
    return 2 * share_bytes + 8 * cg * threads + 16 * cg


def cluster_plan(n: int, c: int, hw: int, num_groups: int, itemsize: int,
                 aligned: bool, sm_count: int, tensors: int = 1):
    """``(cluster, threads, smem)`` of the cluster kernel for this shape,
    or None where the shape needs the streaming design.

    ``tensors`` is how many inputs a block keeps in shared memory: 1 for
    the forward (x), 2 for the backward (masked dy and x).  K is the
    smallest portable cluster size whose share (span/K elements of each
    kept input) fits :data:`SMEM_BUDGET`; it then doubles, up to 8, while
    the launch stays within about two blocks per SM, so that a few spans
    (N=1: 32) still fill the card.  A share is a whole number of 16-byte
    vectors; so is each channel plane (``hw * itemsize``), and the tensors
    are 16-byte aligned: planes such as 7x7, unaligned tensors and spans
    over 8 budgets go to the streaming design."""
    cg = c // num_groups
    span_bytes = cg * hw * itemsize
    if not aligned or (hw * itemsize) % 16:
        return None

    def fits(k):
        return span_bytes % (16 * k) == 0 \
            and tensors * span_bytes // k <= SMEM_BUDGET

    k = next((k for k in CLUSTER_SIZES if fits(k)), None)
    if k is None:
        return None
    spans = n * num_groups
    while 2 * k <= CLUSTER_SIZES[-1] and 2 * k * spans <= 2 * sm_count \
            and span_bytes % (32 * k) == 0:
        k *= 2
    share_bytes = span_bytes // k
    vecs = share_bytes // 16
    threads = min(_MAX_THREADS, max(64, -(-vecs // 256) * 32))
    smem = cluster_smem(share_bytes, cg, threads, tensors)
    if -(-share_bytes // _CHUNK_BYTES) > _MAX_CHUNKS or smem > SMEM_LIMIT:
        return None
    return k, threads, smem


class GNPlan(NamedTuple):
    """How a call launches: ``variant`` "cluster" (``cluster`` blocks of
    ``threads`` per span, ``smem`` bytes each) or "streaming" (``vec``-wide
    accesses over a (N*G, ``splits``) grid of ``chunk``-element parts)."""
    variant: str
    vec: int
    cluster: int = 0
    threads: int = _THREADS
    smem: int = 0
    splits: int = 0
    chunk: int = 0


def streaming_plan(n: int, c: int, hw: int, num_groups: int, itemsize: int,
                   aligned: bool, sm_count: int) -> GNPlan:
    vec, splits, chunk = launch_plan(n, c, hw, num_groups, itemsize, aligned,
                                     sm_count)
    return GNPlan("streaming", vec, splits=splits, chunk=chunk)


def group_norm_plan(n: int, c: int, hw: int, num_groups: int, itemsize: int,
                    aligned: bool, sm_count: int, tensors: int = 1) -> GNPlan:
    """The plan a call takes: the cluster design where
    :func:`cluster_plan` gives one, else the streaming design."""
    cl = cluster_plan(n, c, hw, num_groups, itemsize, aligned, sm_count,
                      tensors)
    if cl is None:
        return streaming_plan(n, c, hw, num_groups, itemsize, aligned,
                              sm_count)
    k, threads, smem = cl
    return GNPlan("cluster", 16 // itemsize, k, threads, smem)


def _plan_for(x: torch.Tensor, num_groups: int, aligned: bool,
              tensors: int) -> GNPlan:
    n, c, h, w = x.shape
    key = (n, c, h, w, num_groups, x.dtype, aligned, x.device.index, tensors)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = group_norm_plan(
            n, c, h * w, num_groups, x.element_size(), aligned,
            _sm_count(x.device), tensors)
    return plan


def cluster_occupancy(x: torch.Tensor, num_groups: int, plan: GNPlan,
                      backward: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a cluster plan on ``x``'s
    card: how many of its clusters the card holds at once."""
    n, c, h, w = x.shape
    out = ctypes.c_int(0)
    err = _lib().occupancy(int(backward), _DTYPE_CODES[x.dtype], n, c, h * w,
                           num_groups, plan.cluster, plan.threads,
                           ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {err}")
    return out.value


def _stream(x: torch.Tensor) -> int:
    """The handle of the current stream on ``x``'s card (what
    ``torch.cuda.current_stream(x.device).cuda_stream`` gives, without
    building a ``Stream`` object on every call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _forward_cluster(x, gamma, beta, num_groups, eps, relu, stats,
                     plan: GNPlan) -> torch.Tensor:
    """One launch of the cluster forward kernel (plan from
    :func:`group_norm_plan`); counts it."""
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    err = _lib().fwd_cluster(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        0 if stats is None else stats.data_ptr(), n, c, h * w, num_groups,
        plan.cluster, plan.threads, float(eps), int(bool(relu)),
        _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_relu cluster kernel launch failed: "
                           f"cudaError {err}")
    _count(group_norm_relu, x, relu, "cluster")
    return y


def _forward_streaming(x, gamma, beta, num_groups, eps, relu, stats,
                       plan: GNPlan) -> torch.Tensor:
    """The two launches of the streaming forward (plan from
    :func:`streaming_plan`); counts them as one call."""
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    partials = torch.empty(n * num_groups * plan.splits * 3,
                           dtype=torch.float32, device=x.device)
    err = _lib().fwd_streaming(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        partials.data_ptr(), 0 if stats is None else stats.data_ptr(),
        n, c, h * w, num_groups, plan.splits, plan.chunk, float(eps),
        int(bool(relu)), _DTYPE_CODES[x.dtype], plan.vec, _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_relu kernel launch failed: "
                           f"cudaError {err}")
    _count(group_norm_relu, x, relu, "streaming")
    return y


def group_norm_relu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    relu: bool = True,
                    stats: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample GroupNorm(``num_groups``) with optional ReLU on contiguous
    NCHW ``x`` (float32 or bfloat16); ``gamma``/``beta`` are (C,) float32.

    A CPU tensor goes to :func:`group_norm_relu_reference`; a CUDA tensor
    launches the kernel of the shape's plan on the current stream or
    raises.  Each call adds one to ``group_norm_relu.launches``, to
    ``group_norm_relu.launches_by_shape[(n, c, h, w, dtype, relu)]`` and to
    ``group_norm_relu.launches_by_variant[(variant, n, c, h, w, dtype,
    relu)]``.  ``stats``, a float32 (N, G, 2) tensor on ``x``'s device,
    receives each (n, group)'s ``[mean, rstd]`` (for the backward)."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of num_groups={num_groups}")
    if stats is not None:
        _check_stats(stats, x, num_groups)
    if n == 0:
        # a rank that holds no rows of a data-parallel micro-batch still
        # runs the forward (its BatchNorm joins the collectives): nothing
        # to launch
        return torch.empty_like(x)
    if x.device.type == "cpu":
        if stats is not None:
            stats.copy_(group_stats_reference(x, num_groups, eps))
        return group_norm_relu_reference(x, gamma, beta, num_groups, eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check_param("gamma", gamma, x, c)
    _check_param("beta", beta, x, c)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NCHW")
    span = (c // num_groups) * h * w
    if n * num_groups * CLUSTER_SIZES[-1] >= 2 ** 31 or span >= 2 ** 24:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's limits")
    plan = _plan_for(x, num_groups, x.data_ptr() % 16 == 0, 1)
    launch = _forward_cluster if plan.variant == "cluster" \
        else _forward_streaming
    return launch(x, gamma, beta, num_groups, eps, relu, stats, plan)


group_norm_relu.launches = 0
group_norm_relu.launches_by_shape = {}
group_norm_relu.launches_by_variant = {}


def _backward_buffers(x: torch.Tensor):
    """dx, the per-(n, c) sums, dgamma and dbeta."""
    n, c = x.shape[:2]
    return (torch.empty_like(x),
            torch.empty(n * c * 2, dtype=torch.float32, device=x.device),
            torch.empty(c, dtype=torch.float32, device=x.device),
            torch.empty(c, dtype=torch.float32, device=x.device))


def _backward_cluster(dy, x, gamma, out, stats, num_groups, relu,
                      plan: GNPlan):
    """The cluster backward kernel and its dgamma/dbeta reduction (plan
    from :func:`group_norm_plan` with ``tensors=2``); counts the call."""
    n, c, h, w = x.shape
    dx, sums, dgamma, dbeta = _backward_buffers(x)
    err = _lib().bwd_cluster(
        dy.data_ptr(), x.data_ptr(), out.data_ptr(), gamma.data_ptr(),
        stats.data_ptr(), sums.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), n, c, h * w, num_groups, plan.cluster,
        plan.threads, int(bool(relu)), _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_relu backward cluster kernel launch "
                           f"failed: cudaError {err}")
    _count(group_norm_relu_backward, x, relu, "cluster")
    return dx, dgamma, dbeta


def _backward_streaming(dy, x, gamma, out, stats, num_groups, relu,
                        plan: GNPlan):
    """The streaming backward's two launches (plan from
    :func:`streaming_plan`); counts them as one call."""
    n, c, h, w = x.shape
    dx, sums, dgamma, dbeta = _backward_buffers(x)
    err = _lib().bwd_streaming(
        dy.data_ptr(), x.data_ptr(), out.data_ptr(), gamma.data_ptr(),
        stats.data_ptr(), sums.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), n, c, h * w, num_groups, plan.splits, plan.chunk,
        int(bool(relu)), _DTYPE_CODES[x.dtype], plan.vec, _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_relu backward kernel launch failed: "
                           f"cudaError {err}")
    _count(group_norm_relu_backward, x, relu, "streaming")
    return dx, dgamma, dbeta


def group_norm_relu_backward(dy: torch.Tensor, x: torch.Tensor,
                             gamma: torch.Tensor, out: torch.Tensor,
                             stats: torch.Tensor, num_groups: int = 32,
                             relu: bool = True):
    """``(dx, dgamma, dbeta)`` of GroupNorm(+ReLU) from the forward's input
    ``x``, scale ``gamma``, output ``out`` and (N, G, 2) ``[mean, rstd]``
    ``stats``; ``dy`` is the gradient of ``out``.

    A CPU tensor goes to :func:`group_norm_relu_backward_reference`; a CUDA
    tensor launches the backward kernel of the shape's plan (no atomics)
    on the current stream or raises.  Each call adds one to
    ``group_norm_relu_backward.launches`` and to its ``launches_by_shape``
    and ``launches_by_variant``.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of num_groups={num_groups}")
    for name, t in (("dy", dy), ("out", out)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{name} must match x ({x.dtype} {tuple(x.shape)} on "
                f"{x.device}), got {t.dtype} {tuple(t.shape)} on {t.device}")
    _check_stats(stats, x, num_groups)
    if n == 0:  # no rows: nothing to launch (see group_norm_relu)
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), zeros, zeros.clone()
    if x.device.type == "cpu":
        return group_norm_relu_backward_reference(dy, x, gamma, out, stats,
                                                  num_groups, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check_param("gamma", gamma, x, c)
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("x and out must be contiguous NCHW")
    dy = dy.contiguous()
    span = (c // num_groups) * h * w
    if n * c >= 2 ** 31 or n * num_groups * CLUSTER_SIZES[-1] >= 2 ** 31 \
            or span >= 2 ** 24:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's limits")
    # dx is a fresh allocation: the caching allocator aligns it to 512 bytes
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, dy))
    plan = _plan_for(x, num_groups, aligned, 2)
    launch = _backward_cluster if plan.variant == "cluster" \
        else _backward_streaming
    return launch(dy, x, gamma, out, stats, num_groups, relu, plan)


group_norm_relu_backward.launches = 0
group_norm_relu_backward.launches_by_shape = {}
group_norm_relu_backward.launches_by_variant = {}


class GroupNormReLUFunction(torch.autograd.Function):
    """GroupNorm(+ReLU) that autograd follows: the counterpart of the JAX
    package's ``group_norm_relu_trainable`` custom VJP.

    The forward is :func:`group_norm_relu` (the kernel on the card) and
    saves ``(x, gamma, out)`` as the JAX forward does, plus the (N, G, 2)
    ``[mean, rstd]`` its kernel writes on the way: 8 bytes per (n, group),
    which spares the backward a full read of ``x`` to recompute them.  The
    backward is :func:`group_norm_relu_backward`.  ``dx`` comes back in
    ``x``'s dtype, ``dgamma``/``dbeta`` in float32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups: int, eps: float,
                relu: bool):
        stats = torch.empty(x.shape[0], num_groups, 2, dtype=torch.float32,
                            device=x.device)
        out = group_norm_relu(x, gamma, beta, num_groups, eps, relu,
                              stats=stats)
        ctx.save_for_backward(x, gamma, out, stats)
        ctx.num_groups, ctx.relu = num_groups, relu
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, out, stats = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_relu_backward(
            dy, x, gamma, out, stats, ctx.num_groups, ctx.relu)
        return dx, dgamma, dbeta, None, None, None


def group_norm_relu_trainable(x: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, num_groups: int = 32,
                              eps: float = 1e-5,
                              relu: bool = True) -> torch.Tensor:
    """:func:`group_norm_relu` through :class:`GroupNormReLUFunction` when a
    gradient is wanted; without one (serving, evaluation) the forward alone,
    which keeps no stats and saves nothing."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        return GroupNormReLUFunction.apply(x, gamma, beta, num_groups, eps,
                                           relu)
    return group_norm_relu(x, gamma, beta, num_groups, eps, relu)

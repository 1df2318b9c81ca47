"""Fused per-sample GroupNorm + ReLU on contiguous NCHW, and its backward.

The counterpart of the JAX package's ``ops/pallas/group_norm.py``.  On a
CUDA tensor :func:`group_norm_relu` launches the hand-written Hopper kernel
``csrc/group_norm_relu.cu`` (which replaces both Pallas kernels,
``_gn_relu_kernel`` and ``_gn_relu_dma_kernel``); on a CPU tensor it runs
:func:`group_norm_relu_reference`, the plain version with the centred f32
math of the JAX package's ``xla_group_norm_relu``.  There is no fallback:
on a CUDA tensor the kernel runs or the call raises.

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

import torch

_SOURCE = "group_norm_relu.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # kThreads in the kernel
_sm_counts: dict = {}


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


def _lib():
    from pdac_pathological_image_segmentation_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    fwd, bwd = lib.pdac_group_norm_relu, lib.pdac_group_norm_relu_bwd
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p])
        fwd.restype = ctypes.c_int
    if bwd.argtypes is None:
        bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return fwd, bwd


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


def _count(fn, x: torch.Tensor, relu: bool) -> None:
    fn.launches += 1
    n, c, h, w = x.shape
    key = (n, c, h, w, str(x.dtype).replace("torch.", ""), bool(relu))
    fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def launch_plan(n: int, c: int, hw: int, num_groups: int, itemsize: int,
                aligned: bool, sm_count: int):
    """(vec, splits, chunk) for the kernel's (N*G, splits) grid.

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


def group_norm_relu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    relu: bool = True,
                    stats: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample GroupNorm(``num_groups``) with optional ReLU on contiguous
    NCHW ``x`` (float32 or bfloat16); ``gamma``/``beta`` are (C,) float32.

    A CPU tensor goes to :func:`group_norm_relu_reference`; a CUDA tensor
    launches the kernel on the current stream or raises.  Each launch adds
    one to ``group_norm_relu.launches`` and to
    ``group_norm_relu.launches_by_shape[(n, c, h, w, dtype, relu)]``.
    ``stats``, a float32 (N, G, 2) tensor on ``x``'s device, receives each
    (n, group)'s ``[mean, rstd]`` (for the backward)."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of num_groups={num_groups}")
    if stats is not None:
        _check_stats(stats, x, num_groups)
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
    if n * num_groups >= 2 ** 31 or span >= 2 ** 24:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's limits")
    vec, splits, chunk = launch_plan(
        n, c, h * w, num_groups, x.element_size(),
        x.data_ptr() % 16 == 0, _sm_count(x.device))
    y = torch.empty_like(x)
    partials = torch.empty(n * num_groups * splits * 3, dtype=torch.float32,
                           device=x.device)
    fwd, _ = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
              partials.data_ptr(), 0 if stats is None else stats.data_ptr(),
              n, c, h * w, num_groups, splits, chunk, float(eps),
              int(bool(relu)), _DTYPE_CODES[x.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"group_norm_relu kernel launch failed: "
                           f"cudaError {err}")
    _count(group_norm_relu, x, relu)
    return y


group_norm_relu.launches = 0
group_norm_relu.launches_by_shape = {}


def group_norm_relu_backward(dy: torch.Tensor, x: torch.Tensor,
                             gamma: torch.Tensor, out: torch.Tensor,
                             stats: torch.Tensor, num_groups: int = 32,
                             relu: bool = True):
    """``(dx, dgamma, dbeta)`` of GroupNorm(+ReLU) from the forward's input
    ``x``, scale ``gamma``, output ``out`` and (N, G, 2) ``[mean, rstd]``
    ``stats``; ``dy`` is the gradient of ``out``.

    A CPU tensor goes to :func:`group_norm_relu_backward_reference`; a CUDA
    tensor launches the backward kernel (two passes, no atomics) on the
    current stream or raises.  Each launch adds one to
    ``group_norm_relu_backward.launches`` and to its ``launches_by_shape``.
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
    if n * c >= 2 ** 31 or span >= 2 ** 24:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's limits")
    dx = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, dy, dx))
    vec, splits, chunk = launch_plan(n, c, h * w, num_groups,
                                     x.element_size(), aligned,
                                     _sm_count(x.device))
    sums = torch.empty(n * c * 2, dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    _, bwd = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = bwd(dy.data_ptr(), x.data_ptr(), out.data_ptr(), gamma.data_ptr(),
              stats.data_ptr(), sums.data_ptr(), dx.data_ptr(),
              dgamma.data_ptr(), dbeta.data_ptr(), n, c, h * w, num_groups,
              splits, chunk, int(bool(relu)), _DTYPE_CODES[x.dtype], vec,
              stream)
    if err != 0:
        raise RuntimeError(f"group_norm_relu backward kernel launch failed: "
                           f"cudaError {err}")
    _count(group_norm_relu_backward, x, relu)
    return dx, dgamma, dbeta


group_norm_relu_backward.launches = 0
group_norm_relu_backward.launches_by_shape = {}


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

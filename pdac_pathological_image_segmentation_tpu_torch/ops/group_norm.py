"""Fused per-sample GroupNorm + ReLU on contiguous NCHW.

The counterpart of the JAX package's ``ops/pallas/group_norm.py``.  On a
CUDA tensor :func:`group_norm_relu` launches the hand-written Hopper kernel
``csrc/group_norm_relu.cu`` (which replaces both Pallas kernels,
``_gn_relu_kernel`` and ``_gn_relu_dma_kernel``); on a CPU tensor it runs
:func:`group_norm_relu_reference`, the plain version with the centred f32
math of the JAX package's ``xla_group_norm_relu``.  There is no fallback:
on a CUDA tensor the kernel runs or the call raises.

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


def _lib():
    from pdac_pathological_image_segmentation_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    fn = lib.pdac_group_norm_relu
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
                    relu: bool = True) -> torch.Tensor:
    """Per-sample GroupNorm(``num_groups``) with optional ReLU on contiguous
    NCHW ``x`` (float32 or bfloat16); ``gamma``/``beta`` are (C,) float32.

    A CPU tensor goes to :func:`group_norm_relu_reference`; a CUDA tensor
    launches the kernel on the current stream or raises.  Each launch adds
    one to ``group_norm_relu.launches`` and to
    ``group_norm_relu.launches_by_shape[(n, c, h, w, dtype, relu)]``."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of num_groups={num_groups}")
    if x.device.type == "cpu":
        return group_norm_relu_reference(x, gamma, beta, num_groups, eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != torch.float32 \
                or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 ({c},) tensor on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
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
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             partials.data_ptr(), n, c, h * w, num_groups, splits, chunk,
             float(eps), int(bool(relu)), _DTYPE_CODES[x.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"group_norm_relu kernel launch failed: "
                           f"cudaError {err}")
    group_norm_relu.launches += 1
    key = (n, c, h, w, str(x.dtype).replace("torch.", ""), bool(relu))
    by_shape = group_norm_relu.launches_by_shape
    by_shape[key] = by_shape.get(key, 0) + 1
    return y


group_norm_relu.launches = 0
group_norm_relu.launches_by_shape = {}

"""int8 convolution with int32 sums and a dequantizing epilogue, NHWC.

The JAX package's int8 serving path (``infer/quantized.py``) leaves its
int8 convolutions to XLA (``conv_general_dilated(int8, int8,
preferred_element_type=int32)`` with the dequantize and what follows fused
into the epilogue).  PyTorch has no int8 convolution on CUDA, so on a CUDA
tensor :func:`int8_conv` launches the hand-written Hopper kernel of
``csrc/int8_conv.cu`` (an implicit GEMM on ``mma.sync`` s8·s8→s32); on a
CPU tensor it runs :func:`int8_conv_reference`, the plain version.  There
is no fallback: on a CUDA tensor the kernel runs or the call raises.

One call is one quantized site: ``acc = conv(xq, kq)`` in int32 (stride,
padding, dilation), then ``y = f32(acc) · (sx · sw[f])``, an optional
per-channel ``y · a[f]``, an optional ``+ b[f]`` (before the residual, or
after it with ``bias_last``), an optional residual (int8 with its scale,
bf16 or f32, NHWC), an optional ReLU, stored as int8 requantized with
``out_scale`` (``clip(round_half_even(y / s), -127, 127)``), bf16, f32, or
the raw int32 sums, NHWC or (``nchw``) NCHW.  The epilogue's arithmetic is
IEEE round-to-nearest on both sides, so the kernel equals the plain version
bitwise.

:func:`quantize_weights` is the JAX ``quantize_weights`` on a torch OIHW
weight, bit for bit: per output channel ``scale = amax / 127`` (1 where
the channel is zero), ``kq = clip(round_half_even(w / scale), -127, 127)``,
laid out ``(F, KH, KW, C)`` as the kernel reads it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_SOURCE = "int8_conv.cu"
# the kernel's dtype codes (csrc/int8_conv.cu, enum Dtype)
_CODES = {None: 0, torch.int8: 1, torch.bfloat16: 2, torch.float32: 3,
          torch.int32: 4}
_fn = None


def quantize_weights(weight: torch.Tensor):
    """An OIHW float weight → ``(kq, scale)``: int8 ``(F, KH, KW, C)``
    contiguous and float32 ``(F,)``, on the weight's device.  Computed on
    the CPU, so the card and the CPU hold the same integers."""
    k = weight.detach().float().cpu()
    amax = k.abs().amax(dim=(1, 2, 3))
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    kq = torch.round(k / scale.view(-1, 1, 1, 1)).clamp_(-127, 127)
    kq = kq.to(torch.int8).permute(0, 2, 3, 1).contiguous()
    return kq.to(weight.device), scale.to(weight.device)


def quantize_activation(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``clip(round_half_even(f32(x) / scale), -127, 127)`` as int8, in
    ``x``'s layout.  The divisor is a one-element tensor on ``x``'s device,
    so the card divides (a Python scalar would make it multiply by the
    reciprocal)."""
    s = torch.full((1,), scale, dtype=torch.float32, device=x.device)
    return torch.round(x.float() / s).clamp_(-127, 127).to(torch.int8)


def output_size(size: int, k: int, stride: int, pad: int,
                dilation: int) -> int:
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def _epilogue_reference(acc, sx, sw, scale, shift, residual, residual_scale,
                        bias_last, relu, out_dtype, out_scale):
    """The epilogue on NHWC int32 sums, one torch op per step."""
    dev = acc.device
    s = torch.full((1,), sx, dtype=torch.float32, device=dev) * sw
    y = acc.float() * s
    if scale is not None:
        y = y * scale
    if shift is not None and not bias_last:
        y = y + shift
    if residual is not None:
        r = residual
        if r.dtype == torch.int8:
            r = r.float() * torch.full((1,), residual_scale,
                                       dtype=torch.float32, device=dev)
        y = y + r.float()
    if shift is not None and bias_last:
        y = y + shift
    if relu:
        y = torch.where(y > 0, y, torch.zeros((), device=dev))
    if out_dtype == torch.int8:
        return quantize_activation(y, out_scale)
    return y.to(out_dtype)


def int8_conv_reference(xq, sx, kq, sw, stride=1, pad=0, dilation=1, *,
                        scale=None, shift=None, residual=None,
                        residual_scale=None, bias_last=False, relu=False,
                        out_dtype=torch.int8, out_scale=None, nchw=False):
    """The plain version: the int8 operands as float64 through
    ``F.conv2d`` (exact: every partial sum is an integer below 2⁵³), rounded
    to int32, then the epilogue as separate torch ops.  Same arguments and
    result as :func:`int8_conv`."""
    x = xq.permute(0, 3, 1, 2).double()
    w = kq.permute(0, 3, 1, 2).double()
    acc = F.conv2d(x, w, stride=stride, padding=pad, dilation=dilation)
    acc = acc.round_().to(torch.int32).permute(0, 2, 3, 1)
    if out_dtype == torch.int32:
        y = acc
    else:
        y = _epilogue_reference(acc, sx, sw, scale, shift, residual,
                                residual_scale, bias_last, relu, out_dtype,
                                out_scale)
    return (y.permute(0, 3, 1, 2) if nchw else y).contiguous()


def _lib():
    global _fn
    if _fn is None:
        from pdac_pathological_image_segmentation_tpu_torch.ops import _build

        fn = _build.load(_SOURCE).pdac_int8_conv
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 7 + [i] * 12 + [f, i, f, i, i, i, f, i, i]
                       + [p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_vector(name: str, t, f: int, device) -> None:
    if t is None:
        return
    if t.dtype != torch.float32 or tuple(t.shape) != (f,) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous float32 ({f},) tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check(xq, kq, sw, stride, pad, dilation, scale, shift, residual,
           residual_scale, out_dtype, out_scale):
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise TypeError(f"xq and kq must be int8, got {xq.dtype} and "
                        f"{kq.dtype}")
    if xq.dim() != 4 or kq.dim() != 4:
        raise ValueError(f"xq must be NHWC and kq (F, KH, KW, C), got shapes "
                         f"{tuple(xq.shape)} and {tuple(kq.shape)}")
    if not xq.is_contiguous() or not kq.is_contiguous():
        raise ValueError("xq (NHWC) and kq (F, KH, KW, C) must be "
                         "contiguous")
    n, h, w, c = xq.shape
    f, kh, kw, kc = kq.shape
    if kc != c:
        raise ValueError(f"kq has {kc} input channels, xq {c}")
    if kq.device != xq.device:
        raise ValueError(f"kq on {kq.device}, xq on {xq.device}")
    if min(stride, dilation) < 1 or pad < 0:
        raise ValueError(f"stride {stride}, pad {pad}, dilation {dilation}")
    oh = output_size(h, kh, stride, pad, dilation)
    ow = output_size(w, kw, stride, pad, dilation)
    if oh < 1 or ow < 1:
        raise ValueError(f"no output for {(h, w)} with a {kh}x{kw} kernel")
    for name, t in (("sw", sw), ("scale", scale), ("shift", shift)):
        _check_vector(name, t, f, xq.device)
    if sw is None:
        raise ValueError("sw is required")
    if residual is not None:
        if residual.dtype not in (torch.int8, torch.bfloat16, torch.float32) \
                or tuple(residual.shape) != (n, oh, ow, f) \
                or not residual.is_contiguous() \
                or residual.device != xq.device:
            raise ValueError(
                f"residual must be a contiguous int8/bf16/f32 "
                f"{(n, oh, ow, f)} tensor on {xq.device}, got "
                f"{residual.dtype} {tuple(residual.shape)}")
        if residual.dtype == torch.int8 and residual_scale is None:
            raise ValueError("an int8 residual needs residual_scale")
    if out_dtype not in (torch.int8, torch.bfloat16, torch.float32,
                         torch.int32):
        raise TypeError(f"out_dtype must be int8, bfloat16, float32 or "
                        f"int32, got {out_dtype}")
    if out_dtype == torch.int8 and out_scale is None:
        raise ValueError("an int8 output needs out_scale")
    if n * oh * ow >= 2 ** 31 or n * h * w >= 2 ** 31:
        raise ValueError(f"shape {tuple(xq.shape)} exceeds the kernel's "
                         "limits")
    return n, h, w, c, f, kh, kw, oh, ow


def _name(dtype) -> str | None:
    return None if dtype is None else str(dtype).replace("torch.", "")


def _vectorized(xq: torch.Tensor, kq: torch.Tensor) -> bool:
    """Whether the kernel loads 16-byte pieces (16 channels of a pixel)."""
    return xq.shape[3] % 16 == 0 and xq.data_ptr() % 16 == 0 \
        and kq.data_ptr() % 16 == 0


def launch_key(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
               pad: int = 0, dilation: int = 1, *, scale=None, shift=None,
               residual=None, bias_last: bool = False, relu: bool = False,
               out_dtype=torch.int8, nchw: bool = False, **_) -> tuple:
    """The key :func:`int8_conv` counts a launch under: the shapes, the
    epilogue and the load path, so that one key is one instantiation at
    one shape."""
    n, h, w, c = xq.shape
    f, kh, kw = kq.shape[:3]
    return (n, h, w, c, f, kh, kw, stride, pad, dilation, scale is not None,
            shift is not None, _name(None if residual is None
                                     else residual.dtype),
            bool(bias_last), bool(relu), _name(out_dtype), bool(nchw),
            _vectorized(xq, kq))


def int8_conv(xq: torch.Tensor, sx: float, kq: torch.Tensor,
              sw: torch.Tensor, stride: int = 1, pad: int = 0,
              dilation: int = 1, *, scale=None, shift=None, residual=None,
              residual_scale=None, bias_last: bool = False,
              relu: bool = False, out_dtype=torch.int8, out_scale=None,
              nchw: bool = False) -> torch.Tensor:
    """One quantized site (module docstring): ``xq`` int8 NHWC with its
    float scale ``sx``, ``kq`` int8 ``(F, KH, KW, C)`` with float32
    per-channel scales ``sw``.  Returns ``(N, OH, OW, F)`` (or NCHW) in
    ``out_dtype``.

    A CPU tensor goes to :func:`int8_conv_reference`; a CUDA tensor launches
    the kernel on the current stream or raises.  Each launch adds one to
    ``int8_conv.launches`` and to ``int8_conv.launches_by_shape`` under
    its :func:`launch_key`."""
    n, h, w, c, f, kh, kw, oh, ow = _check(
        xq, kq, sw, stride, pad, dilation, scale, shift, residual,
        residual_scale, out_dtype, out_scale)
    if xq.device.type == "cpu":
        return int8_conv_reference(
            xq, sx, kq, sw, stride, pad, dilation, scale=scale, shift=shift,
            residual=residual, residual_scale=residual_scale,
            bias_last=bias_last, relu=relu, out_dtype=out_dtype,
            out_scale=out_scale, nchw=nchw)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    shape = (n, f, oh, ow) if nchw else (n, oh, ow, f)
    out = torch.empty(shape, dtype=out_dtype, device=xq.device)
    vec = _vectorized(xq, kq)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib()(
        xq.data_ptr(), kq.data_ptr(), sw.data_ptr(), ptr(scale), ptr(shift),
        ptr(residual), out.data_ptr(), n, h, w, c, f, kh, kw, stride, pad,
        dilation, oh, ow, float(sx),
        _CODES[None if residual is None else residual.dtype],
        float(residual_scale or 0.0), int(bool(bias_last)), int(bool(relu)),
        _CODES[out_dtype], float(out_scale or 0.0), int(bool(nchw)),
        int(vec), torch._C._cuda_getCurrentRawStream(xq.device.index))
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError {err}")
    int8_conv.launches += 1
    key = launch_key(xq, kq, stride, pad, dilation, scale=scale, shift=shift,
                     residual=residual, bias_last=bias_last, relu=relu,
                     out_dtype=out_dtype, nchw=nchw)
    int8_conv.launches_by_shape[key] = \
        int8_conv.launches_by_shape.get(key, 0) + 1
    return out


int8_conv.launches = 0
int8_conv.launches_by_shape = {}

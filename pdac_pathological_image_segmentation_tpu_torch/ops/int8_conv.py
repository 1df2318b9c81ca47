"""int8 convolution with int32 sums and a dequantizing epilogue, NHWC, and
the float→int8 activation quantize that feeds it.

The JAX package's int8 serving path (``infer/quantized.py``) leaves its
int8 convolutions to XLA (``conv_general_dilated(int8, int8,
preferred_element_type=int32)`` with the dequantize and what follows fused
into the epilogue).  PyTorch has no int8 convolution on CUDA, so on a CUDA
tensor :func:`int8_conv` launches the hand-written Hopper kernel of
``csrc/int8_conv.cu`` (an implicit GEMM on ``wgmma`` s8·s8→s32, fed by a
TMA and ``cp.async`` ring, persistent, with a staged epilogue); on a CPU
tensor it runs :func:`int8_conv_reference`, the plain version.  There is no
fallback: on a CUDA tensor the kernel runs or the call raises.

One call is one quantized site: ``acc = conv(xq, kq)`` in int32 (stride,
padding, dilation), then ``y = f32(acc) · (sx · sw[f])``, an optional
per-channel ``y · a[f]``, an optional ``+ b[f]`` (before the residual, or
after it with ``bias_last``), an optional residual (int8 with its scale,
bf16 or f32, NHWC), an optional ReLU, stored as int8 requantized with
``out_scale`` (``clip(round_half_even(y / s), -127, 127)``), bf16, f32, or
the raw int32 sums, NHWC or (``nchw``) NCHW.  The epilogue's arithmetic is
IEEE round-to-nearest on both sides, so the kernel equals the plain version
bitwise.  The kernel gathers the activation as 16-byte pieces, so it
takes C a multiple of 16.  The 3-channel stride-2 stem is run as the same
convolution on a space-to-depth input: quantized with a zero fourth
channel into (N, ⌈H/2⌉, ⌈W/2⌉, 16) (``quantize_activation(...,
channels=4, space_to_depth=True)``; zeros past an odd edge), its weights
rearranged to match (:func:`space_to_depth_weights`), a 4×4/1 convolution
with 16 contiguous bytes a tap.  Zero taps add nothing, so the int32 sums
are those of the original convolution.

:func:`quantize_activation` is ``clip(round_half_even(f32(x) / s), -127,
127)`` as int8 (the JAX mirror's ``_conv_i8`` and ``_Ctx.act``): on a CUDA
tensor one pass of the kernel of ``csrc/quantize.cu`` from any (N, H, W,
C) strides into contiguous NHWC; on a CPU tensor
:func:`quantize_activation_reference`, four torch passes.

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
_QUANTIZE_SOURCE = "quantize.cu"
# the kernels' dtype codes (csrc/int8_conv.cu and csrc/quantize.cu, enum
# Dtype)
_CODES = {None: 0, torch.int8: 1, torch.bfloat16: 2, torch.float32: 3,
          torch.int32: 4}
# csrc/quantize.cu, enum Layout
QUANTIZE_LAYOUTS = ("nhwc", "strided", "s2d")
_fn = None
_quantize_fn = None


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


def quantize_activation_reference(x: torch.Tensor, scale: float, *,
                                  channels: int | None = None,
                                  space_to_depth: bool = False
                                  ) -> torch.Tensor:
    """The plain version of :func:`quantize_activation`: four torch passes
    (divide, round half to even, clamp, cast), then the zero channels, the
    zero row and column past an odd edge and the space-to-depth
    rearrangement, and the NHWC layout.  The divisor is a
    one-element tensor on ``x``'s device, so the card divides (a Python
    scalar would make it multiply by the reciprocal)."""
    s = torch.full((1,), scale, dtype=torch.float32, device=x.device)
    q = torch.round(x.float() / s).clamp_(-127, 127).to(torch.int8)
    if channels is not None and channels > x.shape[3]:
        q = F.pad(q, (0, channels - x.shape[3]))
    if space_to_depth:
        q = F.pad(q, (0, 0, 0, q.shape[2] % 2, 0, q.shape[1] % 2))
        n, h, w, c = q.shape
        q = q.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        q = q.reshape(n, h // 2, w // 2, 4 * c)
    return q.contiguous()


def quantize_layout(x: torch.Tensor, channels: int,
                    space_to_depth: bool = False) -> str:
    """The kernel's path for ``x`` (``csrc/quantize.cu``): ``"s2d"`` for
    the space-to-depth output, else ``"nhwc"`` (contiguous, 16-byte
    aligned), else ``"strided"`` (any strides, the NHWC view of NCHW
    memory among them, and every call that adds zero channels)."""
    if space_to_depth:
        return "s2d"
    if channels == x.shape[3] and x.data_ptr() % 16 == 0 \
            and x.is_contiguous():
        return "nhwc"
    return "strided"


def quantize_key(x: torch.Tensor, channels: int | None = None,
                 space_to_depth: bool = False) -> tuple:
    """The key :func:`quantize_activation` counts a launch under: the shape,
    the output channels, the input dtype and the kernel's layout path."""
    cout = x.shape[3] if channels is None else channels
    return (*x.shape, cout, _name(x.dtype),
            quantize_layout(x, cout, space_to_depth))


def _check_quantize(x: torch.Tensor, channels, space_to_depth) -> int:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape "
                         f"{tuple(x.shape)}")
    cout = x.shape[3] if channels is None else int(channels)
    if cout < x.shape[3]:
        raise ValueError(f"channels {cout} < the input's {x.shape[3]}")
    if x.numel() >= 2 ** 31 or x.shape[0] * x.shape[1] * x.shape[2] * cout \
            >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's "
                         "limits")
    return cout


def _quantize_lib():
    global _quantize_fn
    if _quantize_fn is None:
        from pdac_pathological_image_segmentation_tpu_torch.ops import _build

        fn = _build.load(_QUANTIZE_SOURCE).pdac_quantize
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = [p, i, p] + [i] * 4 + [ll] * 4 + [i, f, i, p]
        fn.restype = ctypes.c_int
        _quantize_fn = fn
    return _quantize_fn


def quantize_activation(x: torch.Tensor, scale: float, *,
                        channels: int | None = None,
                        space_to_depth: bool = False) -> torch.Tensor:
    """``clip(round_half_even(f32(x) / scale), -127, 127)`` as int8: ``x``
    float32 or bfloat16 ``(N, H, W, C)`` in any strides (contiguous NHWC,
    or the NHWC view of NCHW memory) → contiguous NHWC int8 with
    ``channels`` channels (default C; the ones past C are zeros); with
    ``space_to_depth`` ``(N, ⌈H/2⌉, ⌈W/2⌉, 4·channels)``, the 2×2 pixels
    of each block side by side (``(2·sh + sw)·channels + c``; zeros past
    an odd edge).

    A CPU tensor goes to :func:`quantize_activation_reference`; a CUDA
    tensor launches the kernel of ``csrc/quantize.cu`` on the current
    stream or raises.  Each launch adds one to
    ``quantize_activation.launches`` and to
    ``quantize_activation.launches_by_shape`` under its
    :func:`quantize_key`."""
    cout = _check_quantize(x, channels, space_to_depth)
    if x.device.type == "cpu":
        return quantize_activation_reference(
            x, scale, channels=cout, space_to_depth=space_to_depth)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, c = x.shape
    layout = quantize_layout(x, cout, space_to_depth)
    shape = ((n, (h + 1) // 2, (w + 1) // 2, 4 * cout) if space_to_depth
             else (n, h, w, cout))
    out = torch.empty(shape, dtype=torch.int8, device=x.device)
    err = _quantize_lib()(
        x.data_ptr(), _CODES[x.dtype], out.data_ptr(), n, h, w, c,
        *x.stride(), cout, float(scale), QUANTIZE_LAYOUTS.index(layout),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    quantize_activation.launches += 1
    key = quantize_key(x, cout, space_to_depth)
    quantize_activation.launches_by_shape[key] = \
        quantize_activation.launches_by_shape.get(key, 0) + 1
    return out


quantize_activation.launches = 0
quantize_activation.launches_by_shape = {}


def space_to_depth_weights(kq: torch.Tensor, pad: int):
    """The weights ``(F, K, K, C)`` of a stride-2, dilation-1 convolution
    with padding ``pad``, rearranged for the same convolution on the
    space-to-depth input (``quantize_activation(..., channels=C4,
    space_to_depth=True)``, ``C4`` = C rounded up to a multiple of 4):
    ``(kq2, lo)``, ``kq2`` ``(F, KB, KB, 4·C4)`` for a stride-1 convolution
    with low padding ``lo`` blocks (:func:`space_to_depth_pad` gives the
    high padding).  Tap ``(bh, bw)``, channel ``(2·sh + sw)·C4 + c`` holds
    ``kq[f, 2·bh + sh − d, 2·bw + sw − d, c]`` with ``d = 2·lo − pad``, and
    zero where that falls outside the kernel or ``c ≥ C``: the 7×7/2 stem
    (pad 3, C = 3) becomes 4×4 taps of 16 bytes, ``lo = 2``."""
    kq = F.pad(kq, (0, -kq.shape[3] % 4))
    f, k, _, c = kq.shape
    lo = (pad + 1) // 2
    d = 2 * lo - pad
    kb = (k + d + 1) // 2
    out = torch.zeros((f, kb, kb, 2, 2, c), dtype=kq.dtype, device=kq.device)
    for bh in range(kb):
        for sh in range(2):
            kh = 2 * bh + sh - d
            for bw in range(kb):
                for sw in range(2):
                    kw = 2 * bw + sw - d
                    if 0 <= kh < k and 0 <= kw < k:
                        out[:, bh, bw, sh, sw] = kq[:, kh, kw]
    return out.reshape(f, kb, kb, 4 * c).contiguous(), lo


def space_to_depth_pad(size: int, k: int, pad: int, lo: int,
                       kb: int) -> tuple:
    """``(lo, hi)``: the block padding of the space-to-depth convolution
    (kernel ``kb``, stride 1) that gives the stride-2 convolution's output
    size on an input of ``size``.  An odd input's last block is half zeros,
    which land where the stride-2 convolution pads."""
    out = output_size(size, k, 2, pad, 1)
    return lo, out + kb - 1 - (size + 1) // 2 - lo


def _pads(pad) -> tuple:
    """``pad`` as ``(low, high)``: an int pads both sides alike."""
    return (pad, pad) if isinstance(pad, int) else tuple(pad)


def output_size(size: int, k: int, stride: int, pad,
                dilation: int) -> int:
    """Output size along one axis; ``pad`` an int or ``(low, high)``."""
    lo, hi = _pads(pad)
    return (size + lo + hi - dilation * (k - 1) - 1) // stride + 1


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
        return quantize_activation_reference(y, out_scale)
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
    lo, hi = _pads(pad)
    if lo != hi:
        x, lo = F.pad(x, (lo, hi, lo, hi)), 0
    acc = F.conv2d(x, w, stride=stride, padding=lo, dilation=dilation)
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
        fn.argtypes = ([p] * 7 + [i] * 12 + [f, i, f, i, i, i, f, i]
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
    if min(stride, dilation) < 1 or min(_pads(pad)) < 0:
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
    if n * oh * ow >= 2 ** 31 or xq.numel() >= 2 ** 31:
        raise ValueError(f"shape {tuple(xq.shape)} exceeds the kernel's "
                         "limits")
    return n, h, w, c, f, kh, kw, oh, ow


def _name(dtype) -> str | None:
    return None if dtype is None else str(dtype).replace("torch.", "")


def piece_bytes(xq: torch.Tensor) -> int:
    """The kernel's activation load path: 16-byte pieces (16 channels of a
    pixel), or 0 (no path: C not a multiple of 16, or an unaligned tensor;
    refused on the card)."""
    return 16 if xq.shape[3] % 16 == 0 and xq.data_ptr() % 16 == 0 else 0


def launch_key(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
               pad: int = 0, dilation: int = 1, *, scale=None, shift=None,
               residual=None, bias_last: bool = False, relu: bool = False,
               out_dtype=torch.int8, nchw: bool = False, **_) -> tuple:
    """The key :func:`int8_conv` counts a launch under: the shapes, the
    epilogue and the load path (:func:`piece_bytes`), so that one key is
    one instantiation at one shape."""
    n, h, w, c = xq.shape
    f, kh, kw = kq.shape[:3]
    return (n, h, w, c, f, kh, kw, stride, pad, dilation, scale is not None,
            shift is not None, _name(None if residual is None
                                     else residual.dtype),
            bool(bias_last), bool(relu), _name(out_dtype), bool(nchw),
            piece_bytes(xq))


def int8_conv(xq: torch.Tensor, sx: float, kq: torch.Tensor,
              sw: torch.Tensor, stride: int = 1, pad: int = 0,
              dilation: int = 1, *, scale=None, shift=None, residual=None,
              residual_scale=None, bias_last: bool = False,
              relu: bool = False, out_dtype=torch.int8, out_scale=None,
              nchw: bool = False) -> torch.Tensor:
    """One quantized site (module docstring): ``xq`` int8 NHWC with its
    float scale ``sx``, ``kq`` int8 ``(F, KH, KW, C)`` with float32
    per-channel scales ``sw``; ``pad`` an int or ``(low, high)`` (the same
    on both axes).  Returns ``(N, OH, OW, F)`` (or NCHW) in
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
    if piece_bytes(xq) == 0 or kq.data_ptr() % 16:
        raise ValueError(
            f"the kernel gathers 16-byte pieces and reads the weights by "
            f"TMA: it needs C a multiple of 16 and 16-byte aligned xq and "
            f"kq, got C = {c} at bytes {xq.data_ptr() % 16} and "
            f"{kq.data_ptr() % 16} of 16 (a 3-channel stride-2 stem runs "
            f"space to depth: space_to_depth_weights)")
    shape = (n, f, oh, ow) if nchw else (n, oh, ow, f)
    out = torch.empty(shape, dtype=out_dtype, device=xq.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib()(
        xq.data_ptr(), kq.data_ptr(), sw.data_ptr(),
        ptr(scale), ptr(shift), ptr(residual), out.data_ptr(), n, h, w, c,
        f, kh, kw, stride, _pads(pad)[0], dilation, oh, ow, float(sx),
        _CODES[None if residual is None else residual.dtype],
        float(residual_scale or 0.0), int(bool(bias_last)), int(bool(relu)),
        _CODES[out_dtype], float(out_scale or 0.0), int(bool(nchw)),
        torch._C._cuda_getCurrentRawStream(xq.device.index))
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: error {err} "
                           "(a cudaError_t, or 1000 + the CUresult of the "
                           "weights' tensor map)")
    int8_conv.launches += 1
    key = launch_key(xq, kq, stride, pad, dilation, scale=scale, shift=shift,
                     residual=residual, bias_last=bias_last, relu=relu,
                     out_dtype=out_dtype, nchw=nchw)
    int8_conv.launches_by_shape[key] = \
        int8_conv.launches_by_shape.get(key, 0) + 1
    return out


int8_conv.launches = 0
int8_conv.launches_by_shape = {}

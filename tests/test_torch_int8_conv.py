"""The port's int8 convolution (``ops/int8_conv.py``) against JAX, on the
CPU, where the wrapper runs its plain version (the kernel of
``csrc/int8_conv.cu`` is held against the same plain version, bitwise, by
``chip_smoke.py`` on the card).

* int32 sums bitwise against ``jax.lax.conv_general_dilated(int8, int8,
  preferred_element_type=int32)`` at the site shapes of the int8 path: the
  7×7/2 stem on 3 channels, 3×3/1, 3×3/2, the 1×1/2 downsample, and 3×3 at
  dilation 2 and 4 (DeepLabV3+'s dilated stage);
* each epilogue bitwise against the JAX mirror's expressions, run one
  operation at a time (``y = f32(acc)·(sx·sw)``, ``y·a + b``, the int8,
  bf16 or f32 residual, ``maximum(y, 0)``, ``clip(round(y / s), -127,
  127)`` to int8, bf16, f32, NHWC and NCHW);
* ``quantize_weights`` and the activation quantize bitwise against the JAX
  ones;
* the wrapper's refusals;
* the launch key: one key is one instantiation at one shape (the batch,
  the epilogue and the load path all tell keys apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.infer.quantized import (
    quantize_weights as jax_quantize_weights,
)
from pdac_pathological_image_segmentation_tpu_torch.ops import _build
from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
    int8_conv,
    int8_conv_reference,
    launch_key,
    quantize_activation,
    quantize_weights,
)

RNG = np.random.default_rng(11)
# (N, H, W, C), (F, KH, KW), stride, pad, dilation
SITES = {
    "stem_7x7s2_c3": ((2, 64, 64, 3), (64, 7, 7), 2, 3, 1),
    "3x3s1": ((2, 16, 16, 64), (64, 3, 3), 1, 1, 1),
    "3x3s2": ((2, 16, 16, 64), (128, 3, 3), 2, 1, 1),
    "ds_1x1s2": ((2, 16, 16, 64), (128, 1, 1), 2, 0, 1),
    "3x3_dil2": ((2, 8, 8, 256), (64, 3, 3), 1, 2, 2),
    "3x3_dil4": ((1, 9, 11, 32), (48, 3, 3), 1, 4, 4),
}


def _operands(site):
    xs, (f, kh, kw), *_ = SITES[site]
    xq = RNG.integers(-127, 128, xs, dtype=np.int8)
    kq = RNG.integers(-127, 128, (f, kh, kw, xs[3]), dtype=np.int8)
    return xq, kq


def _jax_sums(xq, kq, stride, pad, dilation):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq.transpose(1, 2, 3, 0)),
        (stride, stride), ((pad, pad), (pad, pad)),
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("site", list(SITES))
def test_int32_sums_bitwise_equal_jax(site):
    xq, kq = _operands(site)
    _, _, stride, pad, dil = SITES[site]
    got = int8_conv(torch.from_numpy(xq), 1.0, torch.from_numpy(kq),
                    torch.ones(kq.shape[0]), stride, pad, dil,
                    out_dtype=torch.int32)
    want = _jax_sums(xq, kq, stride, pad, dil)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_epilogue(yi, sx, sw, a, b, r, rscale, bias_last, relu, out, oscale):
    """The JAX mirror's expressions (``infer/quantized.py``), eagerly."""
    y = jnp.asarray(yi).astype(jnp.float32) * (jnp.float32(sx)
                                               * jnp.asarray(sw))
    if a is not None:
        y = y * jnp.asarray(a)
    if b is not None and not bias_last:
        y = y + jnp.asarray(b)
    if r is not None:
        if r.dtype == np.int8:
            r = jnp.asarray(r).astype(jnp.float32) * jnp.float32(rscale)
        y = y + jnp.asarray(r).astype(jnp.float32)
    if b is not None and bias_last:
        y = y + jnp.asarray(b)
    if relu:
        y = jnp.maximum(y, 0.0)
    if out == "int8":
        return np.asarray(jnp.clip(jnp.round(y / jnp.float32(oscale)),
                                   -127, 127).astype(jnp.int8))
    if out == "bf16":
        return np.asarray(y.astype(jnp.bfloat16).astype(jnp.float32))
    return np.asarray(y)


EPILOGUES = {
    # the stem and a block's conv1: BN affine, ReLU, int8 for the consumer
    "affine_relu_int8": dict(affine=True, relu=True, out="int8"),
    # conv2 with an int8 / bf16 / f32 (downsample) residual
    "residual_int8": dict(affine=True, res="int8", relu=True, out="int8"),
    "residual_bf16": dict(affine=True, res="bf16", relu=True, out="bf16"),
    "residual_f32": dict(affine=True, res="f32", relu=True, out="int8"),
    # the downsample itself: affine to f32
    "affine_f32": dict(affine=True, out="f32"),
    # FPN's laterals: bias to bf16
    "bias_bf16": dict(bias=True, out="bf16"),
    # ResUNet's dec.b: + dec.a's f32, then the bias, ReLU
    "concat_bias_last": dict(bias=True, res="f32", bias_last=True,
                             relu=True, out="bf16"),
    # FPN's seg convs: f32 NCHW for the GroupNorm kernel
    "raw_f32_nchw": dict(out="f32", nchw=True),
}


@pytest.mark.parametrize("epi", list(EPILOGUES))
@pytest.mark.parametrize("site", ["3x3s1", "stem_7x7s2_c3"])
def test_epilogue_bitwise_equal_jax(site, epi):
    spec = EPILOGUES[epi]
    xq, kq = _operands(site)
    _, _, stride, pad, dil = SITES[site]
    f = kq.shape[0]
    yi = _jax_sums(xq, kq, stride, pad, dil)
    sx = np.float32(0.0173)
    sw = RNG.uniform(1e-4, 2e-3, f).astype(np.float32)
    a = RNG.uniform(0.5, 1.5, f).astype(np.float32) if spec.get("affine") \
        else None
    b = RNG.normal(0, 0.5, f).astype(np.float32) \
        if spec.get("affine") or spec.get("bias") else None
    r, rscale = None, None
    if spec.get("res") == "int8":
        r, rscale = RNG.integers(-127, 128, yi.shape, dtype=np.int8), 0.021
    elif spec.get("res") == "bf16":
        r = np.asarray(jnp.asarray(RNG.normal(0, 1, yi.shape),
                                   jnp.bfloat16))
    elif spec.get("res") == "f32":
        r = RNG.normal(0, 1, yi.shape).astype(np.float32)
    oscale = 0.0371 if spec["out"] == "int8" else None
    want = _jax_epilogue(yi, sx, sw, a, b, r, rscale,
                         spec.get("bias_last", False),
                         spec.get("relu", False), spec["out"], oscale)

    def t(v):
        if v is None:
            return None
        if v.dtype == jnp.bfloat16:
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(v)

    dtype = {"int8": torch.int8, "bf16": torch.bfloat16,
             "f32": torch.float32}[spec["out"]]
    got = int8_conv(torch.from_numpy(xq), float(sx), torch.from_numpy(kq),
                    t(sw), stride, pad, dil, scale=t(a), shift=t(b),
                    residual=t(r), residual_scale=rscale,
                    bias_last=spec.get("bias_last", False),
                    relu=spec.get("relu", False), out_dtype=dtype,
                    out_scale=oscale, nchw=spec.get("nchw", False))
    assert got.dtype == dtype and got.is_contiguous()
    if spec.get("nchw"):
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_quantize_weights_bitwise_equal_jax():
    hwio = RNG.normal(0, 0.2, (3, 3, 16, 32)).astype(np.float32)
    hwio[..., 5] = 0.0  # a zero channel takes scale 1
    kq_j, s_j = jax_quantize_weights(jnp.asarray(hwio))
    kq, s = quantize_weights(torch.from_numpy(hwio.transpose(3, 2, 0, 1)))
    assert kq.dtype == torch.int8 and tuple(kq.shape) == (32, 3, 3, 16)
    np.testing.assert_array_equal(kq.numpy(),
                                  np.asarray(kq_j).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert s[5] == 1.0


def test_quantize_activation_bitwise_equal_jax():
    x = RNG.normal(0, 3, (2, 8, 8, 16)).astype(np.float32)
    # values on the rounding ties and beyond the clip
    x[0, 0, 0, :4] = np.asarray([0.5, 1.5, -2.5, 900.0]) * 0.25
    s = np.float32(0.25)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / s), -127,
                               127).astype(jnp.int8))
    got = quantize_activation(torch.from_numpy(x), float(s))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0, :4].tolist() == [0, 2, -2, 127]


def test_reference_is_the_wrapper_on_the_cpu():
    xq, kq = _operands("3x3s2")
    args = (torch.from_numpy(xq), 0.01, torch.from_numpy(kq),
            torch.full((128,), 1e-3), 2, 1, 1)
    kw = dict(relu=True, out_dtype=torch.int8, out_scale=0.05)
    assert torch.equal(int8_conv(*args, **kw),
                       int8_conv_reference(*args, **kw))


def test_source_is_built_by_the_build_module():
    assert "int8_conv.cu" in _build.SOURCES
    assert (_build.CSRC / "int8_conv.cu").is_file()


def _valid():
    xq = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    kq = torch.zeros((32, 3, 3, 16), dtype=torch.int8)
    return xq, kq, torch.ones(32)


@pytest.mark.parametrize("case,exc,match", [
    ("float_x", TypeError, "int8"),
    ("nchw_layout", ValueError, "contiguous"),
    ("channels", ValueError, "input channels"),
    ("rank", ValueError, "NHWC"),
    ("sw_shape", ValueError, "sw"),
    ("residual_shape", ValueError, "residual"),
    ("residual_scale", ValueError, "residual_scale"),
    ("out_scale", ValueError, "out_scale"),
    ("out_dtype", TypeError, "out_dtype"),
])
def test_wrapper_refusals(case, exc, match):
    xq, kq, sw = _valid()
    kw = dict(out_dtype=torch.float32)
    if case == "float_x":
        xq = xq.float()
    elif case == "nchw_layout":
        xq = torch.zeros((1, 16, 8, 8), dtype=torch.int8).permute(0, 2, 3, 1)
    elif case == "channels":
        kq = torch.zeros((32, 3, 3, 8), dtype=torch.int8)
    elif case == "rank":
        xq = xq[0]
    elif case == "sw_shape":
        sw = torch.ones(16)
    elif case == "residual_shape":
        kw["residual"] = torch.zeros((1, 4, 4, 32))
    elif case == "residual_scale":
        kw["residual"] = torch.zeros((1, 8, 8, 32), dtype=torch.int8)
    elif case == "out_scale":
        kw["out_dtype"] = torch.int8
    elif case == "out_dtype":
        kw["out_dtype"] = torch.float16
    with pytest.raises(exc, match=match):
        int8_conv(xq, 0.1, kq, sw, 1, 1, 1, **kw)


@pytest.mark.parametrize("change", [
    "batch", "stride", "scale", "shift", "residual_int8", "residual_bf16",
    "bias_last", "relu", "out_dtype", "nchw", "unaligned"])
def test_launch_key_tells_instantiations_apart(change):
    """The counters key a launch by its shape, epilogue and load path, so
    that a checked row on the card stands for exactly the launches under
    its key."""
    xq, kq, sw = _valid()
    base = dict(out_dtype=torch.int8, out_scale=0.1)
    kw = dict(base)
    stride = 1
    if change == "batch":
        xq = torch.zeros((2, 8, 8, 16), dtype=torch.int8)
    elif change == "stride":
        stride = 2
    elif change in ("scale", "shift"):
        kw[change] = torch.ones(32)
    elif change == "residual_int8":
        kw.update(residual=torch.zeros((1, 8, 8, 32), dtype=torch.int8),
                  residual_scale=0.1)
    elif change == "residual_bf16":
        kw["residual"] = torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16)
    elif change in ("bias_last", "relu", "nchw"):
        kw[change] = True
    elif change == "out_dtype":
        kw["out_dtype"] = torch.float32
    elif change == "unaligned":
        # 16-channel pixels from an offset of one byte: the byte loads
        xq = torch.zeros(1 + 8 * 8 * 16, dtype=torch.int8)[1:].view(
            1, 8, 8, 16)
    want = launch_key(*_valid()[:2], 1, 1, 1, **base)
    got = launch_key(xq, kq, stride, 1, 1, **kw)
    assert want[-1] is True and got != want
    assert launch_key(*_valid()[:2], 1, 1, 1, **base) == want

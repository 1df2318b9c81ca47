"""The port's two int8 kernels on one NVIDIA GPU, beside their plain versions.

    python3 scripts/torch_int8_sweep.py [--root DIR] [--check-only]
        [--out runs/int8_sweep.json]

Builds ``csrc/int8_conv.cu`` and ``csrc/quantize.cu`` of the package under
``--root`` (default: this checkout), then:

1. holds both kernels bitwise against their plain versions on random int8
   (and float) operands at small shapes that take every instantiation and
   path: more tiles than SMs and more K steps than ring stages, N tiles
   of 64/128/256 (F = 48, 64, 128, 256, 512), the space-to-depth stem at
   even and odd sizes, partial tiles, stride 2, dilation 2, every output
   type and residual type, NHWC and NCHW outputs, and the quantize
   kernel's nhwc, strided (the NHWC view of NCHW memory among them) and
   s2d paths in float32 and bfloat16;
2. unless ``--check-only``, times the FPN/DeepLabV3+/ResUNet/PSPNet site
   shapes at 512² and batch 32 (random operands; ms by CUDA events, the
   bound from the bytes and operations the site needs, cuDNN's bf16
   convolution and, at the 1×1 sites, ``torch._int_mm`` as yardsticks) and
   the quantize shapes of those paths.

To compare two trees on one card, run it on each in turns within one call
(parent, change, change, parent): ``--root runs/parent`` imports the
parent's package.  A parent without ``space_to_depth_weights`` takes the
stem's 3-channel operands.  Prints one JSON line of rows; writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8
BATCH = 32

# (name, (N, H, W, C), F, k, stride, pad, dilation, epilogue)
SITES = [
    ("stem", (BATCH, 512, 512, 3), 64, 7, 2, 3, 1, "affine_relu_int8"),
    ("layer1.conv1", (BATCH, 128, 128, 64), 64, 3, 1, 1, 1,
     "affine_relu_int8"),
    ("layer1.conv2", (BATCH, 128, 128, 64), 64, 3, 1, 1, 1, "res_int8_int8"),
    ("layer1_1.conv2", (BATCH, 128, 128, 64), 64, 3, 1, 1, 1,
     "res_int8_bf16"),
    ("layer2.conv1", (BATCH, 128, 128, 64), 128, 3, 2, 1, 1,
     "affine_relu_int8"),
    ("layer2.ds", (BATCH, 128, 128, 64), 128, 1, 2, 0, 1, "affine_f32"),
    ("layer2.conv2", (BATCH, 64, 64, 128), 128, 3, 1, 1, 1, "res_f32_int8"),
    ("layer3.conv1", (BATCH, 64, 64, 128), 256, 3, 2, 1, 1,
     "affine_relu_int8"),
    ("layer3.conv2", (BATCH, 32, 32, 256), 256, 3, 1, 1, 1, "res_f32_int8"),
    ("layer4.conv1", (BATCH, 32, 32, 256), 512, 3, 2, 1, 1,
     "affine_relu_int8"),
    ("layer4.conv2", (BATCH, 16, 16, 512), 512, 3, 1, 1, 1, "res_f32_int8"),
    ("lateral5", (BATCH, 16, 16, 512), 256, 1, 1, 0, 1, "bias_bf16"),
    ("lateral2", (BATCH, 128, 128, 64), 256, 1, 1, 0, 1, "bias_bf16"),
    ("seg0_0", (BATCH, 16, 16, 256), 128, 3, 1, 1, 1, "raw_f32_nchw"),
    ("seg3_0", (BATCH, 128, 128, 256), 128, 3, 1, 1, 1, "raw_f32_nchw"),
    ("deeplab.layer4.dil2", (BATCH, 32, 32, 512), 512, 3, 1, 2, 2,
     "res_f32_int8"),
    ("deeplab.project", (BATCH, 32, 32, 1280), 256, 1, 1, 0, 1,
     "affine_relu_bf16"),
    ("deeplab.skip", (BATCH, 128, 128, 64), 48, 1, 1, 0, 1,
     "affine_relu_bf16"),
    ("deeplab.fuse", (BATCH, 128, 128, 304), 256, 1, 1, 0, 1,
     "affine_relu_bf16"),
    ("unet.dec3.a", (BATCH, 128, 128, 64), 64, 3, 1, 1, 1, "raw_f32"),
    ("unet.dec3.b", (BATCH, 128, 128, 64), 64, 3, 1, 1, 1,
     "concat_bias_last"),
    ("pspnet.bottleneck", (BATCH, 64, 64, 256), 512, 1, 1, 0, 1,
     "affine_relu_bf16"),
]

# (name, shape, dtype, layout, channels): NHWC, "nchw" for the NHWC view
# of NCHW (the kernel's strided path), "s2d" for the stem's space-to-depth
# output
QUANTIZE = [
    ("stem input", (BATCH, 512, 512, 3), torch.float32, "s2d", 4),
    ("layer1 bf16", (BATCH, 128, 128, 64), torch.bfloat16, "nhwc", None),
    ("seg3 bf16", (BATCH, 128, 128, 256), torch.bfloat16, "nhwc", None),
    ("aspp f32", (BATCH, 32, 32, 512), torch.float32, "nhwc", None),
    ("fuse f32", (BATCH, 128, 128, 304), torch.float32, "nhwc", None),
    ("GN out f32 (NCHW view)", (BATCH, 128, 128, 128), torch.float32,
     "nchw", None),
    ("GN out bf16 (NCHW view)", (BATCH, 64, 64, 128), torch.bfloat16,
     "nchw", None),
]


def cuda_ms(fn, warmup=3, iters=10, windows=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


def bitwise(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.float32, torch.bfloat16):
        k = torch.int32 if a.dtype == torch.float32 else torch.int16
        return torch.equal(a.view(k), b.view(k))
    return torch.equal(a, b)


def epilogue_kw(kind, n, oh, ow, f, gen):
    """Keyword arguments of one epilogue kind on the card."""
    dev = "cuda"

    def vec(lo, hi):
        return (torch.rand(f, generator=gen) * (hi - lo) + lo).to(dev)

    kw = {}
    if kind.startswith("affine"):
        kw.update(scale=vec(0.5, 1.5), shift=vec(-0.5, 0.5))
    if kind in ("bias_bf16", "concat_bias_last"):
        kw["shift"] = vec(-0.5, 0.5)
    if kind.endswith("relu_int8") or kind.endswith("relu_bf16"):
        kw["relu"] = True
    rshape = (n, oh, ow, f)
    if kind.startswith("res_int8"):
        kw.update(residual=torch.randint(-127, 128, rshape, generator=gen,
                                         dtype=torch.int8).to(dev),
                  residual_scale=0.021, scale=vec(0.5, 1.5),
                  shift=vec(-0.5, 0.5), relu=True)
    elif kind.startswith("res_f32"):
        kw.update(residual=torch.randn(rshape, generator=gen).to(dev),
                  scale=vec(0.5, 1.5), shift=vec(-0.5, 0.5), relu=True)
    elif kind.startswith("res_bf16"):
        kw.update(residual=torch.randn(rshape, generator=gen).to(
            dev, torch.bfloat16), scale=vec(0.5, 1.5),
            shift=vec(-0.5, 0.5), relu=True)
    elif kind == "concat_bias_last":
        kw.update(residual=torch.randn(rshape, generator=gen).to(dev),
                  bias_last=True, relu=True)
    out = kind.rsplit("_", 1)[-1]
    if kind.endswith("nchw"):
        out = kind.split("_")[-2]
        kw["nchw"] = True
    if kind == "concat_bias_last":
        out = "bf16"
    kw["out_dtype"] = {"int8": torch.int8, "bf16": torch.bfloat16,
                       "f32": torch.float32, "int32": torch.int32}[out]
    if out == "int8":
        kw["out_scale"] = 0.0371
    return kw


def operands(ic, shape, f, k, s, p, d, gen):
    """Random int8 operands of one site as the tree's int8 path runs it:
    ``(xq, kq, sw, stride, pad, dilation)``.  A 3-channel stride-2 input
    (the stem) takes the space-to-depth form where the tree has it
    (``space_to_depth_weights``): a zero fourth channel, a zero row and
    column past an odd edge."""
    n, h, w, c = shape
    xq = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    kq = torch.randint(-127, 128, (f, k, k, c), generator=gen,
                       dtype=torch.int8)
    if hasattr(ic, "space_to_depth_weights") and c == 3 and s == 2 \
            and d == 1:
        kq, lo = ic.space_to_depth_weights(kq, p)
        xq = torch.nn.functional.pad(xq, (0, 1, 0, w % 2, 0, h % 2))
        hb, wb = (h + 1) // 2, (w + 1) // 2
        xq = xq.reshape(n, hb, 2, wb, 2, 4).permute(
            0, 1, 3, 2, 4, 5).reshape(n, hb, wb, 16)
        p = ic.space_to_depth_pad(h, k, p, lo, kq.shape[1])
        s = 1
    sw = torch.rand(f, generator=gen) * 2e-3 + 1e-4
    return xq.cuda(), kq.cuda(), sw.cuda(), s, p, d


def check(ic) -> int:
    """Every instantiation and path at small shapes, bitwise."""
    gen = torch.Generator().manual_seed(5)
    cases = 0
    kinds = ["affine_relu_int8", "res_int8_int8", "res_int8_bf16",
             "res_f32_int8", "res_bf16_f32", "affine_f32", "bias_bf16",
             "concat_bias_last", "raw_f32_nchw", "raw_int8_nchw",
             "raw_bf16_nchw", "raw_int32"]
    for shape, f, k, s, p, d in [
            # more tiles than SMs (consumers taking turns) and more K
            # steps than ring stages (phases that lap the ring)
            ((2, 96, 96, 64), 64, 3, 1, 1, 1),
            ((2, 96, 96, 128), 128, 3, 1, 1, 1),
            ((2, 96, 96, 32), 256, 3, 1, 1, 1),
            ((2, 20, 20, 3), 64, 7, 2, 3, 1),      # stem: space to depth
            ((2, 21, 19, 3), 64, 7, 2, 3, 1),      # odd: a zero edge
            ((2, 9, 11, 16), 48, 3, 1, 1, 1),      # F < 64, odd sizes
            ((3, 13, 7, 64), 128, 3, 2, 1, 1),
            ((2, 12, 12, 32), 256, 3, 1, 2, 2),
            ((1, 9, 9, 64), 512, 1, 1, 0, 1),
            ((2, 16, 16, 304), 256, 1, 1, 0, 1),
    ]:
        xq, kq, sw, s, p, d = operands(ic, shape, f, k, s, p, d, gen)
        k = kq.shape[1]
        oh = ic.output_size(xq.shape[1], k, s, p, d)
        ow = ic.output_size(xq.shape[2], k, s, p, d)
        for kind in kinds:
            kw = epilogue_kw(kind, xq.shape[0], oh, ow, f, gen)
            args = (xq, 0.0173, kq, sw, s, p, d)
            got = ic.int8_conv(*args, **kw)
            want = ic.int8_conv_reference(*args, **kw)
            sums = ic.int8_conv(*args, out_dtype=torch.int32)
            sums_ref = ic.int8_conv_reference(*args, out_dtype=torch.int32)
            torch.cuda.synchronize()
            if not (bitwise(got, want) and bitwise(sums, sums_ref)):
                bad = (got.float() - want.float()).abs()
                raise AssertionError(
                    f"int8_conv {shape}->{f} k{k}/s{s}/p{p}/d{d} {kind}: "
                    f"max |d| {float(bad.max())} at "
                    f"{np.unravel_index(int(bad.argmax()), bad.shape)}, "
                    f"sums equal {bitwise(sums, sums_ref)}")
            cases += 1
    if hasattr(ic, "quantize_activation_reference"):
        for shape, dtype, layout, ch in [
                ((2, 9, 11, 64), torch.float32, "nhwc", None),
                ((2, 9, 11, 40), torch.bfloat16, "nhwc", None),
                ((2, 8, 8, 128), torch.float32, "nchw", None),
                ((2, 12, 12, 64), torch.bfloat16, "nchw", None),
                ((2, 9, 7, 96), torch.float32, "nchw", None),
                ((2, 9, 7, 3), torch.float32, "nhwc", 4),
                ((2, 10, 8, 3), torch.float32, "s2d", 4),
                ((2, 9, 7, 3), torch.bfloat16, "s2d", 4),
                ((2, 6, 4, 8), torch.bfloat16, "s2d", None),
                ((2, 9, 7, 5), torch.bfloat16, "nhwc", 7),
                ((2, 9, 7, 24), torch.float32, "slice", None)]:
            x = torch.randn(shape, generator=gen) * 3
            x.view(-1)[:4] = torch.tensor([0.5, 1.5, -2.5, 900.0]) * 0.25
            x = x.to(dtype).cuda()
            if layout == "nchw":
                x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            elif layout == "slice":
                x = torch.cat([x, x], dim=3)[..., 5:29]
            s2d = layout == "s2d"
            got = ic.quantize_activation(x, 0.25, channels=ch,
                                         space_to_depth=s2d)
            want = ic.quantize_activation_reference(x, 0.25, channels=ch,
                                                    space_to_depth=s2d)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or not got.is_contiguous():
                raise AssertionError(f"quantize {shape} {dtype} {layout}")
            cases += 1
    return cases


def bound_ms(shape, f, k, s, p, d, kw):
    """The least time of the original (3-channel, stride-2) site."""
    n, h, w, c = shape
    oh = (h + 2 * p - d * (k - 1) - 1) // s + 1
    ow = (w + 2 * p - d * (k - 1) - 1) // s + 1

    def axis(size, out):
        taps = [o * s - p + i * d for o in range(out) for i in range(k)]
        taps = [t for t in taps if 0 <= t < size]
        return len(set(taps)), len(taps)

    rh, th = axis(h, oh)
    rw, tw = axis(w, ow)
    ob = kw["out_dtype"].itemsize
    res = kw.get("residual")
    nbytes = (n * rh * rw * c + f * k * k * c + 12 * f + n * oh * ow * f * ob
              + (0 if res is None else res.numel() * res.element_size()))
    ops = 2 * n * th * tw * c * f
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3


def sweep(ic) -> list:
    gen = torch.Generator().manual_seed(7)
    rows = []
    for name, shape, f, k0, s0, p0, d0, kind in SITES:
        xq, kq, sw, s, p, d = operands(ic, shape, f, k0, s0, p0, d0, gen)
        n = shape[0]
        oh = ic.output_size(shape[1], k0, s0, p0, d0)
        ow = ic.output_size(shape[2], k0, s0, p0, d0)
        kw = epilogue_kw(kind, n, oh, ow, f, gen)
        args = (xq, 0.0173, kq, sw, s, p, d)
        got = ic.int8_conv(*args, **kw)
        want = ic.int8_conv_reference(*args, **kw)
        torch.cuda.synchronize()
        if not bitwise(got, want):
            raise AssertionError(f"int8_conv {name}: differs from the plain "
                                 "version")
        del want
        ms = cuda_ms(lambda: ic.int8_conv(*args, **kw))
        # cuDNN's bf16 convolution of the original site's shape
        xb = torch.randn((n, shape[3], shape[1], shape[2]), device="cuda",
                         dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wb = torch.randn((f, shape[3], k0, k0), device="cuda",
                         dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn = cuda_ms(lambda: torch.nn.functional.conv2d(
            xb, wb, stride=s0, padding=p0, dilation=d0))
        del xb, wb
        int_mm = None
        if k0 == 1 and p0 == 0:
            a = xq[:, ::s, ::s, :].reshape(-1, xq.shape[3]).contiguous()
            b = kq.view(f, -1).t()
            int_mm = cuda_ms(lambda: torch._int_mm(a, b))
        rows.append({"site": name, "shape": list(shape), "f": f, "k": k0,
                     "stride": s0, "pad": p0, "dilation": d0,
                     "epilogue": kind, "ms": ms,
                     "bound_ms": bound_ms(shape, f, k0, s0, p0, d0, kw),
                     "cudnn_bf16_ms": cudnn, "int_mm_ms": int_mm})
        print(f"[int8] {name:22s} {ms:8.4f} ms  bound "
              f"{rows[-1]['bound_ms']:.4f}  cuDNN bf16 {cudnn:.4f}  _int_mm "
              f"{'-' if int_mm is None else f'{int_mm:.4f}'}", flush=True)
        del args, kw, xq, kq, got
        torch.cuda.empty_cache()
    if not hasattr(ic, "quantize_activation_reference"):
        for name, shape, dtype, layout, ch in QUANTIZE:
            x = torch.randn(shape, device="cuda", dtype=dtype)
            if layout == "nchw":
                x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            ms = cuda_ms(lambda: ic.quantize_activation(x, 0.25).contiguous())
            rows.append({"quantize": name, "shape": list(shape),
                         "dtype": str(dtype), "layout": layout, "ms": ms})
            print(f"[quantize] {name:24s} {ms:8.4f} ms (four torch passes)",
                  flush=True)
        return rows
    for name, shape, dtype, layout, ch in QUANTIZE:
        x = torch.randn(shape, device="cuda", dtype=dtype)
        if layout == "nchw":
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        kw = dict(channels=ch, space_to_depth=layout == "s2d")
        got = ic.quantize_activation(x, 0.25, **kw)
        want = ic.quantize_activation_reference(x, 0.25, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"quantize {name} differs")
        ms = cuda_ms(lambda: ic.quantize_activation(x, 0.25, **kw))
        plain = cuda_ms(lambda: ic.quantize_activation_reference(x, 0.25,
                                                                 **kw))
        nbytes = x.numel() * (x.element_size() + 1)
        rows.append({"quantize": name, "shape": list(shape),
                     "dtype": str(dtype), "layout": layout, "ms": ms,
                     "plain_ms": plain,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        print(f"[quantize] {name:24s} {ms:8.4f} ms  bound "
              f"{rows[-1]['bound_ms']:.4f}  plain {plain:.4f}", flush=True)
        del x, got, want
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    build = importlib.import_module(
        "pdac_pathological_image_segmentation_tpu_torch.ops._build")
    ic = importlib.import_module(
        "pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), "| root", args.root, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    cases = check(ic)
    print(f"[check] {cases} cases bitwise", flush=True)
    rows = [] if args.check_only else sweep(ic)
    line = json.dumps({"root": args.root, "card": card.strip(),
                       "check_cases": cases, "rows": rows})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

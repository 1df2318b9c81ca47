"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. environment: the card's name and power limit, torch/CUDA versions;
2. build every CUDA kernel of the port from ``csrc/`` (one nvcc per
   source, all started together) into ``build/torch_kernels/``;
3. kernel vs plain, each row timed beside its plain version, one PyTorch
   call where one computes the same function (a yardstick only) and the
   least time the card could take:

   * ``group_norm_relu`` at the seven GroupNorm sites of FPN@512 (C=128,
     G=32, H=W in 16, 32, 32, 64, 64, 64, 128) at each served bucket's
     batch (N in 1, 8, 32), in bf16 and f32, so that both the one-split
     and the multi-split statistics are held; plus, off the path, one
     ``relu=False`` C=64 G=16 case and a 7x7 plane (the scalar
     instantiations);
   * ``group_norm_relu_backward`` at the same sites at the smoke's
     training batch (32) in bf16 and f32 and at the config's batch (128)
     in bf16, plus a multi-split (N=8, 128²) and a 7x7 case;
   * ``fused_train_transform`` at 512² and batch 32 and 128, with tables
     that take all seven geometry cases with the jitter on and off;

4. serving end to end, a main path: a seeded random smp-FPN/resnet18
   reference ``.pth`` → ``cli.export`` (tile 512, bf16) → the HTTP daemon
   with buckets 1/8/32 on the card → 48 PNG tiles from 8 concurrent
   clients and one raw-f32 request; every GroupNorm of every device batch
   must have gone through the kernel, counted per shape; then direct
   artifact throughput at bucket 32 and a profile of one bucket-32
   forward;
5. training end to end, a main path: ``cli.train`` on the values of
   ``configs/train_config.yaml`` (FPN/resnet18, bf16, 512²) with the
   epochs cut to 2 and the batch to 32, on synthetic PNG patches, then a
   rerun with 3 epochs that must resume; every train step must have gone
   through the augmentation kernel and every GN site through the forward
   and backward kernels;
6. one train step timed at the config's batch (128), 512², bf16, input on
   the card: ms/step, patches/s, peak memory and the profiler's kernels;
7. card vs CPU: one f32 train step (TF32 off) and the f32 forward;
8. bf16 vs f32 on the card: mask agreement at 0.5.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = "pdac_pathological_image_segmentation_tpu_torch"
TILE = 512
BUCKETS = (1, 8, 32)
# H=W of FPN@512's seven GN calls -> how many of the seven have it
GN_SITES = {16: 1, 32: 2, 64: 3, 128: 1}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
GN_OPS_PER_ELEMENT = 8
# the backward: mask, xhat, two products and sums, then the apply pass
GN_BWD_OPS_PER_ELEMENT = 14
# per pixel: 3 divides, 4 slots x 3 channels x (3 multiplies, 3 adds, the
# clip) when jittered, 2 x 3 normalize ops
AUG_OPS_PER_PIXEL = 3 + 6
AUG_JITTER_OPS_PER_PIXEL = 4 * 3 * 8
TRAIN_BATCH = 32  # the smoke's cut of the config's batch
CONFIG_BATCH = 128  # configs/train_config.yaml
PALLAS = "pdac_pathological_image_segmentation_tpu/ops/pallas/group_norm.py"
PALLAS_AUG = "pdac_pathological_image_segmentation_tpu/ops/pallas/fused_augment.py"
# the Pallas DMA-ring kernel takes blocks with 4*H*W*C*itemsize > 15 MiB
PALLAS_VMEM_LIMIT = 15 * 1024 * 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def cuda_ms(fn, warmup: int = 5, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warm_card(seconds: float = 1.0) -> None:
    """Run matrix products for about ``seconds`` so the first timed kernel
    does not meet idle clocks."""
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


# -- phase 1 ----------------------------------------------------------------

def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"defaults: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


# -- phase 2 ----------------------------------------------------------------

def phase_build() -> None:
    from pdac_pathological_image_segmentation_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(p.relative_to(ROOT)) for p in paths))


# -- phase 3 ----------------------------------------------------------------

def phase_kernels() -> list:
    import torch.nn.functional as F

    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu,
        group_norm_relu_reference,
        launch_plan,
    )

    set_tf32(False)
    warm_card()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(n, 128, hw, 32, True, dt)
             for dt in (torch.bfloat16, torch.float32)
             for n in BUCKETS for hw in GN_SITES]
    # off the served path: no ReLU, and planes that are not a whole number
    # of 16-byte vectors (the kernel's scalar instantiations)
    cases += [(32, 64, 64, 16, False, torch.float32),
              (8, 128, 7, 32, True, torch.bfloat16),
              (8, 128, 7, 32, True, torch.float32)]
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, c, hw, g, relu, dt in cases:
        shape = (n, c, hw, hw)
        x = (torch.randn(shape, device="cuda", generator=gen) * 2.0
             + 0.5).to(dt)
        gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
        beta = torch.randn(c, device="cuda", generator=gen) * 0.1
        vec, splits, _ = launch_plan(n, c, hw * hw, g, x.element_size(),
                                     x.data_ptr() % 16 == 0, sm_count)
        y = group_norm_relu(x, gamma, beta, g, 1e-5, relu)
        torch.cuda.synchronize()
        ref = group_norm_relu_reference(x, gamma, beta, g, 1e-5, relu)
        yf, rf = y.float(), ref.float()
        err = float((yf - rf).abs().max())
        if dt == torch.float32:
            ok = torch.allclose(yf, rf, rtol=1e-5, atol=1e-5)
            same = float((y == ref).float().mean())
        else:
            # one bf16 ulp, and nearly every element bit-identical
            same = float((y == ref).float().mean())
            ok = torch.allclose(yf, rf, rtol=2 ** -7, atol=1e-5) \
                and same >= 0.999
        if not ok or not torch.isfinite(yf).all():
            raise AssertionError(
                f"group_norm_relu {shape} {dt} relu={relu} splits={splits} "
                f"vec={vec}: max_abs_err {err}, bit-identical {same}")
        g_lib, b_lib = gamma.to(dt), beta.to(dt)
        ms = cuda_ms(lambda: group_norm_relu(x, gamma, beta, g, 1e-5, relu))
        plain_ms = cuda_ms(
            lambda: group_norm_relu_reference(x, gamma, beta, g, 1e-5, relu))
        library_ms = cuda_ms(
            lambda: F.relu(F.group_norm(x, g, g_lib, b_lib, 1e-5)) if relu
            else F.group_norm(x, g, g_lib, b_lib, 1e-5))
        elems = n * c * hw * hw
        nbytes = 2 * elems * x.element_size() + 2 * c * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = GN_OPS_PER_ELEMENT * elems / F32_OPS_PER_S * 1e3
        dma = 4 * hw * hw * c * x.element_size() > PALLAS_VMEM_LIMIT
        rows.append({
            "name": "group_norm_relu",
            "route": "cuda",
            "source": f"{PKG}/csrc/group_norm_relu.cu",
            "replaces": f"{PALLAS}:94" if dma else f"{PALLAS}:34",
            "launches": None,  # filled from the main path's run, by shape
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "shape": list(shape),
            "groups": g,
            "relu": relu,
            "dtype": str(dt).replace("torch.", ""),
            "splits": splits,
            "vec": vec,
            "fpn_sites": GN_SITES.get(hw, 0) if (c, g, relu) == (128, 32, True)
            else 0,
            "bit_identical": same,
        })
        log(f"[kernel] {shape} {rows[-1]['dtype']} relu={relu} splits="
            f"{splits} vec={vec}: err {err:.3g} same {same:.6f} | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f}, library {library_ms:.4f}, "
            f"bound {rows[-1]['bound_ms']:.4f}")
        del x, y, ref, yf, rf
    return rows


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_gn_backward_kernels() -> list:
    """``group_norm_relu_backward`` against its plain version on the
    forward kernel's own output and statistics."""
    import torch.nn.functional as F

    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu,
        group_norm_relu_backward,
        group_norm_relu_backward_reference,
        launch_plan,
    )

    set_tf32(False)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(TRAIN_BATCH, hw, dt) for dt in (bf16, f32) for hw in GN_SITES]
    cases += [(CONFIG_BATCH, hw, bf16) for hw in GN_SITES]
    # one multi-split apply pass, and planes of 7x7 (scalar accesses)
    cases += [(8, 128, bf16), (8, 128, f32), (8, 7, bf16), (8, 7, f32)]
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    c, g = 128, 32
    for n, hw, dt in cases:
        shape = (n, c, hw, hw)
        x = (torch.randn(shape, device="cuda", generator=gen) * 2.0
             + 0.5).to(dt)
        gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
        beta = torch.randn(c, device="cuda", generator=gen) * 0.1
        dy = torch.randn(shape, device="cuda", generator=gen).to(dt)
        stats = torch.empty(n, g, 2, device="cuda")
        out = group_norm_relu(x, gamma, beta, g, 1e-5, True, stats=stats)
        vec, splits, _ = launch_plan(n, c, hw * hw, g, x.element_size(),
                                     x.data_ptr() % 16 == 0, sm_count)
        dx, dg, db = group_norm_relu_backward(dy, x, gamma, out, stats, g)
        again = group_norm_relu_backward(dy, x, gamma, out, stats, g)
        torch.cuda.synchronize()
        ref = group_norm_relu_backward_reference(dy, x, gamma, out, stats, g)
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip((dx, dg, db), ref)]
        same = float((dx == ref[0]).float().mean())
        # dgamma/dbeta: f32 sums over N*H*W in another order
        ok = all(torch.allclose(a, b, rtol=1e-4,
                                atol=1e-4 * float(b.abs().max()))
                 for a, b in zip((dg, db), ref[1:]))
        rdx = ref[0].float()
        if dt == f32:
            ok = ok and torch.allclose(dx, rdx, rtol=1e-4, atol=1e-4)
        else:
            # one bf16 ulp (m1, m2 are f32 sums taken in another order),
            # plus 1e-3 of the tensor's largest |dx| where the three terms
            # cancel; nearly every element bit-identical
            ok = ok and same >= 0.999 and torch.allclose(
                dx.float(), rdx, rtol=2 ** -7,
                atol=1e-3 * float(rdx.abs().max()))
        repeat = all(torch.equal(a, b) for a, b in zip((dx, dg, db), again))
        if not ok or not repeat or not torch.isfinite(dx.float()).all():
            raise AssertionError(
                f"group_norm_relu_backward {shape} {dt} splits={splits} "
                f"vec={vec}: max_abs_err dx/dgamma/dbeta {errs}, "
                f"bit-identical {same}, repeatable {repeat}")
        ms = cuda_ms(lambda: group_norm_relu_backward(dy, x, gamma, out,
                                                      stats, g))
        plain_ms = cuda_ms(lambda: group_norm_relu_backward_reference(
            dy, x, gamma, out, stats, g))
        xl = x.detach().requires_grad_()
        gl = gamma.to(dt).requires_grad_()
        bl = beta.to(dt).requires_grad_()
        yl = F.relu(F.group_norm(xl, g, gl, bl, 1e-5))
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            yl, (xl, gl, bl), dy, retain_graph=True))
        elems = n * c * hw * hw
        bound_ms, bound_by = _bound(4 * elems * x.element_size() + 3 * c * 4,
                                    GN_BWD_OPS_PER_ELEMENT * elems)
        rows.append({
            "name": "group_norm_relu_backward",
            "route": "cuda",
            "source": f"{PKG}/csrc/group_norm_relu.cu",
            "replaces": f"{PALLAS}:316",
            "launches": None,  # filled from the training path, by shape
            "max_abs_err": max(errs),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": list(shape),
            "groups": g,
            "relu": True,
            "dtype": str(dt).replace("torch.", ""),
            "splits": splits,
            "vec": vec,
            "fpn_sites": GN_SITES.get(hw, 0),
            "bit_identical": same,
            "max_abs_err_dx_dgamma_dbeta": errs,
        })
        log(f"[kernel] bwd {shape} {rows[-1]['dtype']} splits={splits} "
            f"vec={vec}: err dx {errs[0]:.3g} dgamma {errs[1]:.3g} dbeta "
            f"{errs[2]:.3g} same {same:.6f} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f}, library {library_ms:.4f}, bound "
            f"{bound_ms:.4f}")
        del x, dy, out, dx, ref, rdx, again, xl, yl
    return rows


# (g_apply, choice, rot_k): none, hflip, rot90 k = 0..3, vflip
GEOMETRY = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2),
            (1, 1, 3), (1, 2, 0)]


def _augment_tables(n: int, seed: int):
    """Tables that cycle through the seven geometry cases, each with the
    jitter on and off, with random factors and slot orders."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
        make_augment_tables,
    )

    rng = np.random.default_rng(seed)
    facs = np.concatenate([rng.uniform(0.7, 1.3, (n, 3)),
                           rng.uniform(-0.3, 0.3, (n, 1))], axis=1)
    ints = np.zeros((n, 8), np.int32)
    for i in range(n):
        ints[i, :4] = rng.permutation(4)
        ints[i, 4] = (i // len(GEOMETRY)) % 2
        ints[i, 5:8] = GEOMETRY[i % len(GEOMETRY)]
    return make_augment_tables(torch.from_numpy(facs.astype(np.float32)),
                               torch.from_numpy(ints))


def _masks(n: int, seed: int) -> np.ndarray:
    """Filled circles, one per patch, as uint8 {0, 1}."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:TILE, :TILE]
    out = np.zeros((n, TILE, TILE), np.uint8)
    for i in range(n):
        cy, cx = rng.integers(TILE // 4, 3 * TILE // 4, 2)
        r = rng.integers(TILE // 8, TILE // 3)
        out[i] = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return out


def phase_augment_kernels() -> list:
    """``fused_train_transform`` against its plain version, the bf16 chain
    of ``ops/augment.py``, on the same tables."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
        fused_train_transform,
        fused_train_transform_reference,
    )

    rows = []
    for n in (TRAIN_BATCH, CONFIG_BATCH):
        images = torch.from_numpy(_tiles(n, seed=20 + n)).cuda()
        masks = torch.from_numpy(_masks(n, seed=n)).cuda()
        tables = _augment_tables(n, seed=n).to("cuda")
        out, mout = fused_train_transform(images, masks, tables)
        out2, mout2 = fused_train_transform(images, masks, tables)
        torch.cuda.synchronize()
        ref, rmask = fused_train_transform_reference(images, masks, tables)
        o, r = out.float(), ref.float()
        err = float((o - r).abs().max())
        same = float((out == ref).float().mean())
        # tests/test_fused_augment.py's bound, here for every element
        beyond = int(((o - r).abs() > 0.06 + 0.02 * r.abs()).sum())
        repeat = torch.equal(out, out2) and torch.equal(mout, mout2)
        if not torch.equal(mout, rmask) or same < 0.999 or beyond \
                or not repeat or not torch.isfinite(o).all():
            raise AssertionError(
                f"fused_train_transform n={n}: masks equal "
                f"{torch.equal(mout, rmask)}, max_abs_err {err}, "
                f"bit-identical {same}, beyond the bound {beyond}, "
                f"repeatable {repeat}")
        ms = cuda_ms(lambda: fused_train_transform(images, masks, tables))
        plain_ms = cuda_ms(lambda: fused_train_transform_reference(
            images, masks, tables), warmup=2, iters=5)
        pixels = n * TILE * TILE
        jittered = int(tables.ints[:, 4].sum())
        bound_ms, bound_by = _bound(
            pixels * (3 + 1) + pixels * (3 * 2 + 4),
            pixels * AUG_OPS_PER_PIXEL
            + jittered * TILE * TILE * AUG_JITTER_OPS_PER_PIXEL)
        rows.append({
            "name": "fused_train_transform",
            "route": "cuda",
            "source": f"{PKG}/csrc/fused_augment.cu",
            "replaces": f"{PALLAS_AUG}:79",
            "launches": None,  # filled from the training path, by shape
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes it
            "shape": [n, TILE, TILE, 3],
            "jittered": jittered,
            "bit_identical": same,
        })
        log(f"[kernel] augment ({n}, {TILE}, {TILE}, 3) jittered {jittered}: "
            f"err {err:.3g} same {same:.6f}, masks bitwise | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f}, bound {bound_ms:.4f}")
        del images, masks, out, out2, ref, o, r
    return rows


# -- phase 4 ----------------------------------------------------------------

def _tiles(n: int, seed: int) -> np.ndarray:
    """Smooth, tissue-like uint8 tiles: bilinear-upsampled low-resolution
    colour noise plus fine noise."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(40, 230, (n, 3, 16, 16))
                              .astype(np.float32))
    smooth = torch.nn.functional.interpolate(
        coarse, size=(TILE, TILE), mode="bilinear", align_corners=False)
    img = smooth.numpy().transpose(0, 2, 3, 1) + rng.normal(
        0, 12, (n, TILE, TILE, 3))
    return img.clip(0, 255).astype(np.uint8)


def _post(url: str, body: bytes, headers: dict):
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _write_reference_pth(cfg, path: Path, seed: int) -> dict:
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    sd = seeded_state_dict(build_model(cfg), seed=seed)
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 0, "previous_best": 0.0}, path)
    return sd


def phase_serving(tmp: Path, card: str) -> tuple:
    import yaml
    from PIL import Image

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        export as cli_export,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        load_serving_artifact,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.server import (
        SegmentationServer,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu,
    )

    set_tf32(False)
    cfg_d = {"model": "fpn", "backbone": "resnet18", "img_size": TILE,
             "compute_dtype": "bfloat16"}
    (tmp / "cfg.yaml").write_text(yaml.safe_dump(cfg_d))
    pth = tmp / "best.pth"
    sd = _write_reference_pth(Config(**cfg_d), pth, seed=0)
    art_path = tmp / "fpn512.pdacpt"
    cli_export.main(["--config", str(tmp / "cfg.yaml"), "--pth_path",
                     str(pth), "--out", str(art_path), "--tile", str(TILE)])
    artifact = load_serving_artifact(str(art_path), device="cuda")

    n_tiles, n_clients = 48, 8
    tiles = _tiles(n_tiles, seed=1)
    pngs = []
    for t in tiles:
        buf = io.BytesIO()
        Image.fromarray(t).save(buf, format="PNG")
        pngs.append(buf.getvalue())
    raw_tile = _tiles(1, seed=2)[0]

    server = SegmentationServer(("127.0.0.1", 0), artifact, buckets=BUCKETS,
                                max_wait_ms=5.0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    # -- the main path: launches counted from here ...
    group_norm_relu.launches = 0
    group_norm_relu.launches_by_shape.clear()
    server.start(warmup=True)
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    results = [None] * n_tiles
    errors = []

    def client(k: int) -> None:
        for i in range(k, n_tiles, n_clients):
            try:
                results[i] = _post(url + "/v1/segment", pngs[i],
                                   {"Content-Type": "image/png"})
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(f"tile {i}: {exc!r}")

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=300)
    http_s = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in clients):
        raise AssertionError(f"HTTP clients failed: {errors[:3]}")
    status, headers, body = _post(
        url + "/v1/segment", raw_tile.tobytes(),
        {"Content-Type": "application/octet-stream",
         "X-Image-Shape": f"{TILE},{TILE},3",
         "Accept": "application/octet-stream"})
    with urllib.request.urlopen(url + "/v1/stats", timeout=60) as r:
        stats = json.loads(r.read())
    launches = group_norm_relu.launches
    by_shape = dict(group_norm_relu.launches_by_shape)
    # -- ... to here
    server.shutdown()
    serve_thread.join(timeout=30)

    for i, (st, hd, bd) in enumerate(results):
        if st != 200 or "X-Tumor-Fraction" not in hd:
            raise AssertionError(f"tile {i}: status {st}, headers {hd}")
        mask = np.asarray(Image.open(io.BytesIO(bd)))
        if mask.shape != (TILE, TILE):
            raise AssertionError(f"tile {i}: mask shape {mask.shape}")
    if status != 200 or headers.get("X-Prob-Repr") != "f32":
        raise AssertionError(f"raw request: {status} {headers}")
    served = np.frombuffer(body, np.float32).reshape(TILE, TILE)
    direct = artifact(raw_tile[None])[0]
    if not np.array_equal(served, direct):
        raise AssertionError(
            "raw f32 response differs from the direct artifact call: max "
            f"{np.abs(served - direct).max()}")
    if not (np.isfinite(direct).all() and 0 <= direct.min()
            and direct.max() <= 1):
        raise AssertionError("probabilities out of [0, 1] or not finite")
    forwards = stats["batches"] + stats["warmups"]
    expected = sum(GN_SITES.values()) * forwards
    if launches != expected or stats["requests"] != n_tiles + 1:
        raise AssertionError(
            f"GN launches {launches}, expected 7 x ({stats['batches']} "
            f"batches + {stats['warmups']} warm-ups) = {expected}; stats "
            f"{stats}")
    # per shape: each forward at bucket b launches GN_SITES[hw] times at
    # (b, 128, hw, hw) in bf16, and every bucket ran at least its warm-up
    per_bucket = {b: by_shape.get((b, 128, 16, 16, "bfloat16", True), 0)
                  for b in BUCKETS}
    want = {(b, 128, hw, hw, "bfloat16", True): k * per_bucket[b]
            for b in BUCKETS for hw, k in GN_SITES.items()}
    if by_shape != want or min(per_bucket.values()) < 1 \
            or sum(per_bucket.values()) != forwards:
        raise AssertionError(f"GN launches by shape {by_shape}, expected "
                             f"{want} over {forwards} forwards")
    log(f"[serve] {stats['requests']} requests in {stats['batches']} device "
        f"batches (+{stats['warmups']} warm-ups), occupancy "
        f"{stats.get('mean_batch_occupancy', 0):.3f}, p50 "
        f"{stats.get('latency_ms_p50', 0):.1f} ms, p99 "
        f"{stats.get('latency_ms_p99', 0):.1f} ms; 48 PNG tiles over HTTP "
        f"from {n_clients} clients in {http_s:.2f} s; GN kernel launches "
        f"{launches} = 7 x (batches + warm-ups); forwards by bucket "
        f"{per_bucket}")

    # direct artifact throughput at the largest bucket (H2D + D2H included)
    batch = _tiles(BUCKETS[-1], seed=3)
    fn = artifact.aot(BUCKETS[-1])
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(batch)
    dt = time.perf_counter() - t0
    log(f"[serve] direct artifact calls at bucket {BUCKETS[-1]}: "
        f"{reps * BUCKETS[-1] / dt:.1f} tiles/s ({dt / reps * 1e3:.1f} ms "
        f"per call) on {card}")

    # one bucket-32 forward, device-resident input, by kernel
    x = torch.from_numpy(batch).cuda()
    step = artifact.step
    fwd_ms = cuda_ms(lambda: step(x), warmup=2, iters=10)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x)
        torch.cuda.synchronize()
    # kernels only: an operator's device time is its kernels' again
    by_name = {ev.key: ev.self_device_time_total / 1e3
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    total = sum(by_name.values())
    gn = sum(v for k, v in by_name.items() if "gn_stats" in k
             or "gn_apply" in k)
    log(f"[profile] bucket-{BUCKETS[-1]} forward: {fwd_ms:.3f} ms by CUDA "
        f"events; profiler device time {total:.3f} ms, GroupNorm kernels "
        f"{gn:.3f} ms ({100 * gn / total if total else 0:.1f}%)")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {v:8.3f} ms  {k[:110]}")
    return sd, by_shape


# -- phase 5: training, the new main path -----------------------------------

def _write_patches(root: Path, n: int, seed: int) -> None:
    """``n`` synthetic 512² image/mask PNG pairs in the reference's layout
    (``patch_i.png`` + ``patch_i-labelled.png``): tissue-like tiles with a
    filled circle, tinted purple, as the label."""
    from PIL import Image

    root.mkdir(parents=True)
    images, masks = _tiles(n, seed), _masks(n, seed)
    tint = np.asarray([120, 60, 160], np.float32)
    for i in range(n):
        m = masks[i].astype(bool)
        img = images[i].astype(np.float32)
        img[m] = 0.5 * img[m] + 0.5 * tint
        Image.fromarray(img.astype(np.uint8)).save(
            root / f"patch_{i:04d}.png", compress_level=1)
        Image.fromarray(masks[i]).save(root / f"patch_{i:04d}-labelled.png",
                                       compress_level=1)


def _train_counters(reset: bool = False) -> dict:
    from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
        fused_train_transform,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu,
        group_norm_relu_backward,
    )

    fns = {"augment": fused_train_transform, "gn_forward": group_norm_relu,
           "gn_backward": group_norm_relu_backward}
    if reset:
        for fn in fns.values():
            fn.launches = 0
            fn.launches_by_shape.clear()
    return {k: (fn.launches, dict(fn.launches_by_shape))
            for k, fn in fns.items()}


def _run_cli_train(cfg_path: Path, out: Path) -> tuple:
    """``cli.train`` on the card; its result and what it printed."""
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        train as cli_train,
    )

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli_train.main(["--config", str(cfg_path), "--save_path",
                                 str(out)])
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"[train]   {line}")
    return result, buf.getvalue(), seconds


def phase_training(tmp: Path) -> dict:
    import yaml

    n_train, n_val = 96, 32
    t0 = time.perf_counter()
    _write_patches(tmp / "data" / "train", n_train, seed=30)
    _write_patches(tmp / "data" / "val", n_val, seed=31)
    cfg = yaml.safe_load((ROOT / "configs" / "train_config.yaml").read_text())
    cuts = {"epochs": (cfg["epochs"], 2),
            "batch_size": (cfg["batch_size"], TRAIN_BATCH)}
    cfg.update({k: v[1] for k, v in cuts.items()})
    cfg.update({"train_path": str(tmp / "data" / "train"),
                "val_path": str(tmp / "data" / "val")})
    cfg_path = tmp / "train.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    log(f"[train] {n_train} train + {n_val} val synthetic {TILE}² PNG patches "
        f"in {time.perf_counter() - t0:.1f} s; configs/train_config.yaml "
        f"({cfg['model']}/{cfg['backbone']}, {cfg['compute_dtype']}, "
        f"img_size {cfg['img_size']}, lr {cfg['lr']}) with the cuts "
        + ", ".join(f"{k} {a} -> {b}" for k, (a, b) in cuts.items()))
    out = tmp / "train_out"
    # -- the main path: launches counted from here ...
    _train_counters(reset=True)
    first, _, s1 = _run_cli_train(cfg_path, out)
    cfg["epochs"] = 3
    cfg_path.write_text(yaml.safe_dump(cfg))
    second, printed, s2 = _run_cli_train(cfg_path, out)
    counts = _train_counters()
    # -- ... to here
    if "resumed from epoch 1" not in printed:
        raise AssertionError("the 3-epoch rerun did not resume from epoch 1")
    history = first["history"] + second["history"]
    if [h["epoch"] for h in history] != [0, 1, 2] or not all(
            np.isfinite([h["train_loss"], h["train_score"], h["val_loss"],
                         h["val_score"]]).all() for h in history):
        raise AssertionError(f"training history {history}")
    for name in ("latest.pth", "best.pth"):
        if not (out / "pth" / name).is_file():
            raise AssertionError(f"{name} was not written")
    steps = 3 * -(-n_train // TRAIN_BATCH)
    evals = 3 * -(-n_val // TRAIN_BATCH)
    sites = sum(GN_SITES.values())
    want = {"augment": steps, "gn_backward": sites * steps,
            "gn_forward": sites * (steps + evals)}
    got = {k: v[0] for k, v in counts.items()}
    want_fwd = {(TRAIN_BATCH, 128, hw, hw, "bfloat16", True):
                k * (steps + evals) for hw, k in GN_SITES.items()}
    want_bwd = {key: v // (steps + evals) * steps
                for key, v in want_fwd.items()}
    if got != want or counts["gn_forward"][1] != want_fwd \
            or counts["gn_backward"][1] != want_bwd \
            or counts["augment"][1] != {(TRAIN_BATCH, TILE): steps}:
        raise AssertionError(f"training launches {counts}, expected {want} "
                             f"({steps} steps, {evals} eval batches)")
    log(f"[train] 2 epochs in {s1:.1f} s, resumed for a 3rd in {s2:.1f} s; "
        f"losses {[round(h['train_loss'], 4) for h in history]}, val scores "
        f"{[round(h['val_score'], 4) for h in history]}; launches: augment "
        f"{got['augment']} = {steps} steps, GN backward "
        f"{got['gn_backward']} = 7 x {steps}, GN forward {got['gn_forward']} "
        f"= 7 x ({steps} steps + {evals} eval batches)")
    return counts


# -- phase 6: the timed train step ------------------------------------------

def _train_setup(cfg, sd: dict, device: str):
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
        make_objective,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.state import (
        make_optimizer,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_train_step,
    )

    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    model = model.to(device)
    opt = make_optimizer(model, cfg.lr)
    return model, make_train_step(model, opt, cfg.img_size,
                                  make_objective(cfg))


def phase_timed_step(card: str) -> dict:
    import yaml
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        step_generator,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    set_tf32(False)
    raw = yaml.safe_load((ROOT / "configs" / "train_config.yaml").read_text())
    raw.pop("train_path"), raw.pop("val_path"), raw.pop("test_path")
    cfg = Config.from_dict(raw)
    n = cfg.batch_size
    sd = seeded_state_dict(build_model(cfg), seed=7)
    model, step = _train_setup(cfg, sd, "cuda")
    images = torch.from_numpy(_tiles(n, seed=8)).cuda()
    masks = torch.from_numpy(_masks(n, seed=8)).cuda()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    gens = [step_generator(cfg.seed, 0, i) for i in range(16)]
    for i in range(3):
        step(images, masks, valid, gens[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 8
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        loss, score = step(images, masks, valid, gens[3 + i])
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    ms = start.elapsed_time(end) / iters
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(float(loss)) and np.isfinite(float(score))):
        raise AssertionError(f"timed step: loss {loss}, score {score}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(images, masks, valid, gens[15])
        torch.cuda.synchronize()
    by_name = {ev.key: ev.self_device_time_total / 1e3
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    total = sum(by_name.values())
    groups = {
        "gn_forward": ("gn_stats", "gn_apply"),
        "gn_backward": ("gn_bwd_",),
        "augment": ("augment_kernel",),
    }
    shares = {g: sum(v for k, v in by_name.items()
                     if any(p in k for p in pats))
              for g, pats in groups.items()}
    log(f"[step] train step at batch {n}, {cfg.img_size}², "
        f"{cfg.compute_dtype}, input on the card: {ms:.2f} ms/step by CUDA "
        f"events ({host_ms:.2f} by the host clock), {n * 1e3 / ms:.1f} "
        f"patches/s, peak memory {peak / 2 ** 30:.2f} GiB, on {card}")
    log(f"[profile] one step: profiler device time {total:.2f} ms, idle "
        f"share {max(0.0, 1 - total / ms):.3f} of the timed step; "
        + ", ".join(f"{g} {v:.3f} ms ({100 * v / total if total else 0:.1f}%)"
                    for g, v in shares.items()))
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {v:8.3f} ms  {k[:110]}")
    return {"ms_per_step": ms, "patches_per_s": n * 1e3 / ms,
            "peak_bytes": peak, "profile_ms": total, "shares_ms": shares}


# -- phase 7: card vs CPU ---------------------------------------------------

def phase_train_card_vs_cpu() -> None:
    """One f32 train step (TF32 off) from the same weights, the same batch
    and the same host generator: on the CPU, on the card with cuDNN's
    convolutions, and on the card with PyTorch's own (cuDNN off)."""
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        step_generator,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    set_tf32(False)
    cfg = Config(model="fpn", backbone="resnet18", img_size=TILE,
                 compute_dtype="float32", lr=1e-4)
    sd = seeded_state_dict(build_model(cfg), seed=9)
    n = 2
    images = torch.from_numpy(_tiles(n, seed=10))
    masks = torch.from_numpy(_masks(n, seed=10))
    valid = torch.ones(n, dtype=torch.bool)
    res = {}
    for run, dev, cudnn in (("cpu", "cpu", True), ("cudnn", "cuda", True),
                            ("no_cudnn", "cuda", False)):
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            model, step = _train_setup(cfg, sd, dev)
            loss, _ = step(images.to(dev), masks.to(dev), valid.to(dev),
                           step_generator(1, 0, 0))
            res[run] = (float(loss), {k: p.grad.cpu() for k, p in
                                      model.named_parameters()})
    norms = {k: float(g.norm()) for k, g in res["cpu"][1].items()}
    top = max(norms.values())

    def compare(run: str, rel: float) -> str:
        d_loss = abs(res[run][0] - res["cpu"][0])
        errs = {k: float((res[run][1][k] - g).norm())
                for k, g in res["cpu"][1].items()}
        bad = [k for k in norms if errs[k] > rel * norms[k] + 1e-4 * top]
        worst = sorted(norms, key=lambda k: -errs[k] / max(norms[k], 1e-30))
        detail = ", ".join(f"{k} {errs[k]:.3g}/{norms[k]:.3g}"
                           for k in worst[:3])
        if d_loss > 1e-4 or bad or not np.isfinite(res[run][0]):
            raise AssertionError(
                f"train step card ({run}) vs CPU: |Δloss| {d_loss}, tensors "
                f"beyond the bound {bad}; worst |Δg|/|g| (L2): {detail}; "
                f"largest |g| {top:.3g}")
        return (f"|Δloss| {d_loss:.3g}; worst |Δg|/|g| (L2): {detail} "
                f"(bound {rel:g} of the norm + 1e-4 of the largest, {top:.3g})")

    # With PyTorch's own convolutions the card sums in another order than
    # the CPU and nothing else, but the f32 backward through the encoder's
    # BatchNorms is ill-conditioned (each removes the mean and the xhat
    # component of its incoming gradient, which leaves the rounding): the
    # CPU test against the JAX package at 64² sees 1.2e-3 of scale between
    # two f32 libraries (tests/test_torch_train.py), so 5e-3 of the norm.
    # cuDNN's heuristics may pick transform-based (Winograd, FFT)
    # algorithms for the f32 data and weight gradients, whose rounding is
    # coarser: 5e-2 of the norm.  The loss within 1e-4 in both.
    log(f"[card-vs-cpu] one f32 train step, TF32 off, {n}x{TILE}², card "
        f"without cuDNN: {compare('no_cudnn', 5e-3)}")
    log(f"[card-vs-cpu] the same, card with cuDNN: {compare('cudnn', 5e-2)}")


# -- phases 7 and 8 ---------------------------------------------------------

def _model(sd: dict, dtype: str, device: str):
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_infer_step,
    )

    model = build_model(Config(model="fpn", backbone="resnet18",
                               img_size=TILE, compute_dtype=dtype))
    model.load_state_dict(sd, strict=True)
    return make_infer_step(model.to(device), TILE)


def phase_card_vs_cpu(sd: dict) -> None:
    set_tf32(False)
    imgs = torch.from_numpy(_tiles(2, seed=4))
    card = _model(sd, "float32", "cuda")(imgs.cuda()).cpu()
    cpu = _model(sd, "float32", "cpu")(imgs)
    err = float((card - cpu).abs().max())
    if card.shape != (2, TILE, TILE) or not torch.isfinite(card).all() \
            or err > 5e-4:
        raise AssertionError(f"card vs CPU: shape {tuple(card.shape)}, max "
                             f"abs err {err} (bound 5e-4)")
    log(f"[card-vs-cpu] f32, TF32 off, 2x{TILE}²: max |Δp| {err:.3g} "
        f"(bound 5e-4)")


def phase_bf16_vs_f32(sd: dict) -> None:
    set_tf32(False)
    imgs = torch.from_numpy(_tiles(8, seed=5)).cuda()
    p16 = _model(sd, "bfloat16", "cuda")(imgs)
    p32 = _model(sd, "float32", "cuda")(imgs)
    agree = float(((p16 >= 0.5) == (p32 >= 0.5)).float().mean())
    if agree <= 0.98:
        raise AssertionError(f"bf16 vs f32 mask agreement {agree} <= 0.98")
    log(f"[bf16-vs-f32] mask agreement at 0.5: {agree:.6f} (gate > 0.98), "
        f"max |Δp| {float((p16 - p32).abs().max()):.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import pdac_pathological_image_segmentation_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent != ROOT / PKG:
        print(f"chip_smoke: {PKG} not found beside this script",
              file=sys.stderr)
        return 2
    card = phase_environment()
    phase_build()
    kernels = phase_kernels()
    kernels += phase_gn_backward_kernels()
    kernels += phase_augment_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sd, serve_by_shape = phase_serving(Path(tmp), card)
        train = phase_training(Path(tmp))
    if not serve_by_shape:
        raise AssertionError("group_norm_relu was not launched on the path")
    for row in kernels:
        # launches on the two main paths, by shape: 0 for rows off them
        if row["name"] == "fused_train_transform":
            key = (row["shape"][0], TILE)
            paths = {"train": train["augment"][1].get(key, 0)}
        else:
            key = (*row["shape"], row["dtype"], row["relu"])
            if row["name"] == "group_norm_relu":
                paths = {"serve": serve_by_shape.get(key, 0),
                         "train": train["gn_forward"][1].get(key, 0)}
            else:
                paths = {"train": train["gn_backward"][1].get(key, 0)}
        row["launches"] = sum(paths.values())
        row["launches_by_path"] = paths
    phase_timed_step(card)
    phase_train_card_vs_cpu()
    phase_card_vs_cpu(sd)
    phase_bf16_vs_f32(sd)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. environment: the card's name and power limit, torch/CUDA versions;
2. build every CUDA kernel of the port from ``csrc/`` (one nvcc per
   source) into ``build/torch_kernels/``;
3. kernel vs plain: ``group_norm_relu`` at the shapes of the seven
   GroupNorm sites of FPN@512 (C=128, G=32, H=W in 16, 32, 32, 64, 64, 64,
   128) at each served bucket's batch (N in 1, 8, 32), in bf16 and f32,
   so that both the one-split and the multi-split statistics are held;
   plus, off the served path, one ``relu=False`` C=64 G=16 case and a 7x7
   plane (the scalar, non-vector instantiations) in bf16 and f32.  Each
   is held against ``group_norm_relu_reference`` on the same inputs and
   timed beside the plain version, one PyTorch call
   (``F.relu(F.group_norm(...))``, a yardstick only) and the least time
   the card could take;
4. serving end to end, the main path: a seeded random smp-FPN/resnet18
   reference ``.pth`` → ``cli.export`` (tile 512, bf16) → the HTTP daemon
   with buckets 1/8/32 on the card → 48 PNG tiles from 8 concurrent
   clients and one raw-f32 request; every GroupNorm of every device batch
   must have gone through the kernel, counted per shape; then direct
   artifact throughput at bucket 32 and a profile of one bucket-32
   forward;
5. card vs CPU: the same weights, f32 with TF32 off, batch 2 at 512²;
6. bf16 vs f32 on the card: mask agreement at 0.5.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
PALLAS = "pdac_pathological_image_segmentation_tpu/ops/pallas/group_norm.py"
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


# -- phases 5 and 6 ---------------------------------------------------------

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sd, by_shape = phase_serving(Path(tmp), card)
    if not by_shape:
        raise AssertionError("group_norm_relu was not launched on the path")
    for row in kernels:
        # 0 for the f32 and off-path rows: the main path serves bf16
        row["launches"] = by_shape.get(
            (*row["shape"], row["dtype"], row["relu"]), 0)
    phase_card_vs_cpu(sd)
    phase_bf16_vs_f32(sd)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

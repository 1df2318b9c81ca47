"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. environment: the card's name and power limit, torch/CUDA versions;
2. build every CUDA kernel of the port from ``csrc/`` (one nvcc per
   source, all started together) into ``build/torch_kernels/``, and beside
   them with g++ the native PNG decoder the trainer's loader reads through
   (``build/native/``);
3. kernel vs plain, each row timed beside its plain version, one PyTorch
   call where one computes the same function (a yardstick only) and the
   least time the card could take; each row's ``ms`` is back-to-back calls
   by CUDA events (the host's time where the host cannot keep up), its
   ``device_ms`` the kernels' own time per call from ``torch.profiler``,
   and its ``elementwise_ms`` one elementwise PyTorch call that moves the
   same bytes (``copy_`` for the forward, ``addcmul`` of dy, x and out for
   the backward): what a plain streaming kernel reaches at that size:

   * ``group_norm_relu`` at the seven GroupNorm sites of FPN@512 (C=128,
     G=32, H=W in 16, 32, 32, 64, 64, 64, 128) at each served bucket's
     batch (N in 1, 8, 32), in bf16 and f32, and at the config's batch
     (128) in bf16 (the timed step) and f32 (the int8 whole-slide paths);
     plus, off the path, one ``relu=False`` C=64 G=16
     case and a 7x7 plane.  Each shape runs the design its plan takes and,
     where that is the cluster design, the streaming design beside it
     (through the two private launchers), both held and timed; the 7x7
     plane is one the plan itself sends to the streaming design (scalar
     accesses).  Cluster rows print their K and
     ``cudaOccupancyMaxActiveClusters``;
   * ``group_norm_relu_backward`` the same way at the same sites at the
     smoke's training batch (32) in bf16 and f32 and at the config's batch
     (128) in bf16, plus N=8 at 128² (a multi-split streaming pass) and a
     7x7 case; every design is run twice and must repeat bitwise; after
     the main paths, both GN kernels the same way at every other key a
     path launched them under (the sweep's partial batches, the int8
     overlay's f32 bucket 16); a launched key without a row fails the run;
   * ``fused_train_transform`` at 512² and batch 32 and 128 on tables
     that take all seven geometry cases with the jitter on and off, at
     batch 128 on the trainer's own draws (``draw_augment_scalars``,
     seeded), and at 8x200² (rows that are not 16-byte aligned: the
     byte-load instantiation); its ``copy_ms`` moves the same bytes with
     no arithmetic (``out.copy_(images.permute(0, 3, 1, 2))`` and
     ``mout.copy_(masks)``);
   * ``int8_conv`` (``csrc/int8_conv.cu``) bitwise (int32 sums and the
     int8/bf16/f32 output) at every site of the int8 forwards of FPN,
     DeepLabV3+, ResUNet and PSPNet at 512² and batch 32, operands
     recorded from one forward of each with seeded weights, with
     ``torch._int_mm`` on the same bytes for the 1×1 sites and cuDNN's
     bf16 conv of the same shape as yardsticks, and the kernel's time in
     its earlier mma.sync design beside each row where that design had the
     key (``scripts/int8_conv_mma_sync_ms.json``); after the int8 main
     paths of phase 10, the same at every other key they launched it under
     (shapes and epilogue: the buckets 1 and 8, the slides' batch 128 and
     last batches, ResUNet's 512); a launched key without a bitwise row
     fails the run; then ``quantize_activation`` (``csrc/quantize.cu``)
     bitwise against its plain version at every key the int8 main paths
     launched it under (shape, channels, dtype, layout), with its byte
     bound; a launched key without a row fails the run;

4. serving end to end, a main path: a seeded random smp-FPN/resnet18
   reference ``.pth`` → ``cli.export`` (tile 512, bf16) → the HTTP daemon
   with buckets 1/8/32 on the card → 48 PNG tiles from 8 concurrent
   clients and one raw-f32 request; every GroupNorm of every device batch
   must have gone through the cluster kernel, counted per shape and per
   design; then direct artifact throughput at bucket 32 and a profile of
   one bucket-32 forward; then the same for FPN/efficientnet-b7, whose
   smp-layout ``.pth`` also carries the encoder's unrun
   ``encoder._conv_head``/``encoder._bn1``;
4b. unet serving, a main path: a seeded reference ResUNet ``.pth`` →
   ``cli.export`` with ``head_dtype: bfloat16`` → the same daemon and
   requests (no GroupNorm may run); then the JAX bench's tile→mask program
   at batch 512 (512 uint8 tiles of 512² on the card): ms by CUDA events,
   tiles/s, peak memory and a profile by kernel;
4c. DeepLabV3+, PSPNet and UNet++ on resnet18 and DeepLabV3+ on
   mobilenet_v2 (bf16), a main path each:
   a seeded reference ``.pth`` in the port's names (smp's for the first
   two) → ``cli.export`` → the same daemon and requests (no GroupNorm may
   run), direct artifact calls and a profiled bucket-32 forward; then a
   DeepLabV3+ artifact exported with ``dilations: (6, 12, 18)`` must serve
   what the ``.pth`` serves at those rates;
5. training end to end, a main path for each of the five models:
   ``cli.train`` on the values of ``configs/train_config.yaml`` (bf16,
   512²) with the epochs cut to 2 and the batch to 32, on synthetic PNG
   patches, then a rerun with 3 epochs that must resume; every train step
   must have gone through the augmentation kernel and, for FPN, every GN
   site through the cluster forward and backward kernels.  FPN/resnet18
   starts from a seeded torchvision resnet18 ``.npz`` (``pretrained_path``)
   and so do FPN/efficientnet-b7 and DeepLabV3+/mobilenet_v2 from seeded
   efficientnet-pytorch and torchvision files with their classifier tops:
   the trainer's encoder must equal the file's before its first step
   (FPN/efficientnet-b7's batch 32 takes about 56 GiB);
5c. evaluation, a main path per run: ``cli.test --device cuda`` on each
   ``best.pth`` of phase 5 (16 test patches, batch 8, no figures, so
   matplotlib is not required); the GN forward launches must be 7 x the
   eval batches of each FPN, all cluster, and ``metrics.csv`` and
   ``threshold_sweep.csv`` whole; then each in f32 on the card and on the
   CPU, ``test_score`` within 1e-3;
6. one train step timed at the config's batch (128), 512², bf16, input on
   the card, for each model (a model whose batch does not fit is cut to
   the largest power of two that does, said in the log): ms/step,
   patches/s, peak memory, idle share and the profiler's kernels;
6b. DeepLabV3+'s ASPP dropout at (128, 256, 32, 32) on the card: its law,
   its mask repeatable per step, and no host tensor but the seed;
7. card vs CPU, every model: the f32 forward (probabilities 5e-4, masks
   99.9% equal; PSPNet/mobilenet_v2 and UNet++/efficientnet-b0 too), and
   one train step (TF32 off) in f32 for FPN and ResUNet; in f64 for the
   later models (their f32 gradients round at the f32 gate's own size;
   the f32 differences are reported), DeepLabV3+ with its dropout off;
   FPN/efficientnet-b7 in f32 at 256² (the GN kernels take no f64; each
   f32 side against the CPU's f64 step reported);
8. bf16 vs f32 on the card: mask agreement at 0.5 (ResUNet with its bf16
   head);
9. whole-slide inference, last, a main path per run: ``cli.overlay --device
   cuda`` with the FPN ``best.pth`` of phase 5 on the config (bf16, batch
   128) over an 8192² JPEG TIFF written by PIL (GeoJSON, TIFF export,
   region cleaning), a deflate pyramidal tiled TIFF written by the port's
   writer (banded, stride 256, hann, TTA, uncertainty), an exported
   artifact, and a PyHIST directory; every output read back, the tumor
   fraction against the saved map or polygons, and the GN forward
   launches 7 x the tile batches (x 8 with TTA), per shape, all cluster.
   Then the JAX rounds' 40,960² slide (25,281 windows at stride 256,
   hann) through ``BandedSlidingWindow`` with band input: wall seconds,
   windows/s, the device's busy share (profiler), peak memory, band
   uploads, GN launches.  Then card vs CPU in f32 on a 1024² slide with
   and without TTA (probabilities within 5e-4, masks 99.9% equal) and
   the banded runner against the plain one within float16 rounding.
9b. ``cli.overlay --banded`` with DeepLabV3+'s and FPN/efficientnet-b7's
   ``best.pth`` on a 2048² slide (7 GN launches for FPN's one batch): any
   model runs the whole-slide path.
10. int8 serving, stain normalization and the device slide, each a main
   path with the int8 kernel's counters set to 0 just before it and read
   just after: FPN int8 from
   ``cli.export --int8 --calib_path`` (phase 5's ``best.pth``, the test
   patches) served by the daemon at buckets 1/8/32 (int8 and GN launches
   per forward), direct calls, the profiled forward, card vs CPU masks
   ≥ 99.9%, int8 vs bf16 masks > 98%, the artifact ≤ 0.4× the float one;
   ResUNet int8 at batch 512 and DeepLabV3+/PSPNet int8 at 32;
   ``cli.overlay --int8 --banded`` on a 2048² slide; a ``stain: macenko``
   FPN artifact served and held card vs CPU on H&E-like tiles and the
   synthetic patches (stained pixels and probabilities 5e-4, masks 99.9%;
   stained pixels in float64 1e-8); the 40,960²
   slide (25,281 windows) from ``DeviceSlideSource`` in bf16 and int8,
   with 0 bytes uploaded.
11. every training option of the JAX trainer, each a main path through
   ``cli.train`` (phase 5's cuts; the GN and augmentation counters set to
   0 just before and read just after, and held to the path's steps):
   11a BASELINE.json config #2, ResUNet with 3 classes, ``stain:
   macenko`` and softmax Dice on 3-class synthetic patches (2 epochs, a
   resumed 3rd with ``profile_epoch`` and ``debug_nans``: the trace holds
   CUDA kernels, ``scalars.csv`` the four tags a epoch), ``cli.test`` with
   per-class metrics, the timed step at 128 with Macenko's own ms beside
   it, and one f32 step card vs CPU at phase 7's bounds; 11b config #3,
   UNet++ with 3 classes and weighted Dice + CE (fused), 2 + 1 epochs and
   the timed step; 11c FPN with ``fused_augment: false`` and with
   ``parity_mode`` (its resume resets the best), their timed steps beside
   the fused one, and the non-fused chain card vs CPU (f32 1e-6, bf16 one
   ulp and ≥ 99.9% bit-identical, masks bitwise); 11d FPN/efficientnet-b7
   at the config's batch 128 with ``remat`` and ``grad_accum_steps: 4``:
   a k = 4 step with remat equal to the same step without (at batch 32,
   cuDNN deterministic; loss 1e-5, BN buffers 1e-5, twice the GN forward
   launches, gradients within the larger of 5e-3 of their norm and twice
   what two plain steps differ by, every parameter within 2·lr after
   Adam), the timed step at 128, and ``cli.train``.  The non-fused paths launch
   no augmentation kernel.
12. the tools and the host data path, each a main path: 12a
   ``generate_synthetic_patches`` (128 pairs at 512²), timed; 12b
   ``PatchLoader`` over them on the card at batch 32 with the native
   decoder and with PIL, 3 epochs each (every batch bitwise equal, no PNG
   through the decoder's PIL path), pairs/s beside phase 6's FPN step,
   and the trainer's FPN epoch at 128 fed by its loader, native and PIL
   in turn in one run, beside the same step with its batch on the card;
   12c ``cli.extract`` on phase 9's tiled TIFF and GeoJSON at downsample 1
   and 2 (names, label tiles against ``rasterize_shapes``, image tiles
   against ``read_region``, every pair through the native loader); 12d
   ``serve_and_loadtest`` at ``bench.py --mode serve``'s settings (32
   closed-loop clients, 640 requests, buckets 1/8/32) on the FPN (f32 and
   u8 responses) and ResUNet artifacts, GN launches 7 per forward; 12e
   ``run_sweep`` with phase 5's FPN over two numpy slides and the tiled
   TIFF (against direct runs, files read back, ``sharded=True`` raises).

Each phase ends with a ``[phase] name: seconds`` line (wall time since
the previous one).  Before the ``kernels`` line a ``{"models": ...}`` line
sums up the new
models' numbers (``int8`` and ``stain`` among them), a ``{"tools": ...}``
line phase 12's and a ``{"wsi_host": ..., "wsi_40k_device": ...}`` line
the timed slides.  The
line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
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
EVAL_BATCH = 8  # cli.test's batch: a served bucket's, and cheap on the CPU
UNET_INFER_BATCH = 512  # the JAX bench's tile->mask batch (bench.py)
# the registry's other architectures on resnet18, after FPN and ResUNet
NEW_MODELS = ("deeplabv3+", "pspnet", "unet++")
MODELS = ("fpn", "unet") + NEW_MODELS
# the other encoder families, a main path each: FPN on the widest encoder
# the reference names (its GN sites are FPN/resnet18's), DeepLabV3+ on
# MobileNetV2 at output stride 16 (the dilated last stage)
B7, MNV2 = "efficientnet-b7", "mobilenet_v2"
ENCODER_PATHS = (("fpn", B7), ("deeplabv3+", MNV2))
# b7's card-vs-CPU train step (phase 7) runs at 256², a quarter of 512²'s
# pixels, to keep its float64 and float32 runs on the CPU short
B7_CPU_TILE = 256
PALLAS = "pdac_pathological_image_segmentation_tpu/ops/pallas/group_norm.py"
PALLAS_AUG = "pdac_pathological_image_segmentation_tpu/ops/pallas/fused_augment.py"
# the Pallas DMA-ring kernel takes blocks with 4*H*W*C*itemsize > 15 MiB
PALLAS_VMEM_LIMIT = 15 * 1024 * 1024
# profiler names of the GN kernels (csrc/group_norm_relu.cu), both designs
GN_FORWARD_KERNELS = ("gn_fwd_cluster", "gn_stats", "gn_apply")
GN_BACKWARD_KERNELS = ("gn_bwd_",)
# profiler names of the augmentation kernels (csrc/fused_augment.cu): four
# statistics passes and the output pass, five launches a call
AUG_KERNELS = ("augment_stats_kernel", "augment_out_kernel")
AUG_LAUNCHES_PER_CALL = 5


def log(msg: str) -> None:
    print(msg, flush=True)


_PHASE_CLOCK = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Logs the wall seconds since the previous phase ended (or the run
    started) as ``[phase] name: s``."""
    now = time.perf_counter()
    log(f"[phase] {name}: {now - _PHASE_CLOCK[0]:.1f} s")
    _PHASE_CLOCK[0] = now


def _tag(model: str, backbone: str = "resnet18") -> str:
    """The name of a model's run: the model alone on resnet18."""
    return model if backbone == "resnet18" else f"{model}_{backbone}"


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def cuda_ms(fn, warmup: int = 5, iters: int = 20, windows: int = 5) -> float:
    """ms per call of ``fn`` by CUDA events: the median of ``windows``
    windows of ``iters`` back-to-back calls, so that one stall of the host
    does not decide a row whose calls are host-bound."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def _all_cluster(what: str, by_variant: dict, by_shape: dict) -> None:
    """Every GN call of a path went through the cluster kernels: the
    per-variant counts hold only the cluster variant and add up, shape by
    shape, to the per-shape counts."""
    cluster = {k[1:]: v for k, v in by_variant.items() if k[0] == "cluster"}
    if cluster != by_shape or len(cluster) != len(by_variant):
        raise AssertionError(f"{what}: launches by variant {by_variant}, "
                             f"by shape {by_shape}: not all cluster")


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
    """Every CUDA kernel, and beside them with g++ the native PNG decoder
    the trainer's loader reads through: a failed build stops the run before
    any path starts."""
    from concurrent.futures import ThreadPoolExecutor

    from pdac_pathological_image_segmentation_tpu_torch.data import (
        native_loader,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        png = pool.submit(native_loader.build)
        paths = _build.build_all()
        paths.append(png.result())
    log(f"[build] {len(paths) - 1} kernel libraries and the native PNG "
        f"decoder in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(p.relative_to(ROOT)) for p in paths))


# -- phase 3 ----------------------------------------------------------------

def device_ms(fn, kernels: int, iters: int = 10, names=None):
    """The device time of ``fn``'s kernels per call, from ``torch.profiler``
    over ``iters`` calls: beside ``cuda_ms``'s back-to-back time, which is
    the host's where the host cannot keep up.  None (not measured) unless
    the profiler saw ``kernels`` kernels per call: a window where it drops
    events reads below the bound.  With ``names``, only kernels whose name
    holds one of them count (the profiler also records other threads'
    launches in its window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and (names is None or any(n in ev.key for n in names))]
    seen = sum(ev.count for ev in events)
    if seen != kernels * iters:
        log(f"[profile] device time not measured: the profiler saw {seen} "
            f"kernels, {kernels * iters} expected")
        return None
    return sum(ev.self_device_time_total for ev in events) / 1e3 / iters


def _gn_variants(x: torch.Tensor, g: int, tensors: int, sm_count: int):
    """[(plan, launcher)] of a GN shape: the plan the wrapper takes and,
    where that is the cluster design, the streaming design beside it."""
    from pdac_pathological_image_segmentation_tpu_torch.ops import (
        group_norm as gn,
    )

    n, c, h, w = x.shape
    args = (n, c, h * w, g, x.element_size(), x.data_ptr() % 16 == 0,
            sm_count)
    plan = gn.group_norm_plan(*args, tensors=tensors)
    fwd = {"cluster": gn._forward_cluster, "streaming": gn._forward_streaming}
    bwd = {"cluster": gn._backward_cluster,
           "streaming": gn._backward_streaming}
    launchers = fwd if tensors == 1 else bwd
    out = [(plan, launchers[plan.variant])]
    if plan.variant == "cluster":
        out.append((gn.streaming_plan(*args), launchers["streaming"]))
    return out


# kernels one call launches: the cluster forward one, the backward's
# cluster kernel and its dgamma/dbeta reduction two, the streaming designs
# two each
GN_KERNELS_PER_CALL = {(1, "cluster"): 1, (1, "streaming"): 2,
                       (2, "cluster"): 2, (2, "streaming"): 2}


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _variant_fields(plan, occupancy) -> dict:
    return {"variant": plan.variant,
            "cluster": plan.cluster,
            "threads": plan.threads,
            "smem_bytes": plan.smem,
            "splits": plan.splits,
            "vec": plan.vec,
            "max_active_clusters": occupancy}


def phase_kernels(cases: list | None = None) -> list:
    """``group_norm_relu``'s designs against its plain version at ``cases``
    ``(n, c, h, w, groups, relu, dtype)``: by default the served buckets',
    the config batch's and a few off the paths."""
    import torch.nn.functional as F

    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        cluster_occupancy,
        group_norm_relu_reference,
    )

    set_tf32(False)
    warm_card()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    if cases is None:
        cases = [(n, 128, hw, hw, 32, True, dt)
                 for dt in (torch.bfloat16, torch.float32)
                 for n in BUCKETS for hw in GN_SITES]
        # the timed train step's batch, and the int8 whole-slide paths'
        # (f32 GN at the config's batch)
        cases += [(CONFIG_BATCH, 128, hw, hw, 32, True, dt)
                  for dt in (torch.bfloat16, torch.float32)
                  for hw in GN_SITES]
        # off the served path: no ReLU, and planes that are not a whole
        # number of 16-byte vectors (the plan sends them to the streaming
        # design, with scalar accesses)
        cases += [(32, 64, 64, 64, 16, False, torch.float32),
                  (8, 128, 7, 7, 32, True, torch.bfloat16),
                  (8, 128, 7, 7, 32, True, torch.float32)]
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, c, h, w, g, relu, dt in cases:
        shape = (n, c, h, w)
        x = (torch.randn(shape, device="cuda", generator=gen) * 2.0
             + 0.5).to(dt)
        gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
        beta = torch.randn(c, device="cuda", generator=gen) * 0.1
        ref = group_norm_relu_reference(x, gamma, beta, g, 1e-5, relu)
        rf = ref.float()
        g_lib, b_lib = gamma.to(dt), beta.to(dt)
        plain_ms = cuda_ms(
            lambda: group_norm_relu_reference(x, gamma, beta, g, 1e-5, relu))
        library_ms = cuda_ms(
            lambda: F.relu(F.group_norm(x, g, g_lib, b_lib, 1e-5)) if relu
            else F.group_norm(x, g, g_lib, b_lib, 1e-5))
        # the same bytes through one elementwise call: x read, y written
        sink = torch.empty_like(x)
        elementwise_ms = cuda_ms(lambda: sink.copy_(x))
        del sink
        elems = n * c * h * w
        nbytes = 2 * elems * x.element_size() + 2 * c * 4
        bound_ms, bound_by = _bound(nbytes, GN_OPS_PER_ELEMENT * elems)
        dma = 4 * h * w * c * x.element_size() > PALLAS_VMEM_LIMIT
        for plan, launch in _gn_variants(x, g, 1, sm_count):
            def call():
                return launch(x, gamma, beta, g, 1e-5, relu, None, plan)

            y, again = call(), call()
            torch.cuda.synchronize()
            yf = y.float()
            err = float((yf - rf).abs().max())
            same = float((y == ref).float().mean())
            if dt == torch.float32:
                ok = torch.allclose(yf, rf, rtol=1e-5, atol=1e-5)
            else:
                # one bf16 ulp, and nearly every element bit-identical
                ok = torch.allclose(yf, rf, rtol=2 ** -7, atol=1e-5) \
                    and same >= 0.999
            repeat = torch.equal(y, again)
            if not ok or not repeat or not torch.isfinite(yf).all():
                raise AssertionError(
                    f"group_norm_relu {shape} {dt} relu={relu} {plan}: "
                    f"max_abs_err {err}, bit-identical {same}, repeatable "
                    f"{repeat}")
            occ = cluster_occupancy(x, g, plan) \
                if plan.variant == "cluster" else None
            ms = cuda_ms(call)
            dev_ms = device_ms(call, GN_KERNELS_PER_CALL[1, plan.variant])
            rows.append({
                "name": "group_norm_relu",
                "route": "cuda",
                "source": f"{PKG}/csrc/group_norm_relu.cu",
                "replaces": f"{PALLAS}:94" if dma else f"{PALLAS}:34",
                "launches": None,  # filled from the main paths' runs
                "max_abs_err": err,
                "ms": ms,
                "device_ms": dev_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "elementwise_ms": elementwise_ms,
                **_variant_fields(plan, occ),
                "shape": list(shape),
                "groups": g,
                "relu": relu,
                "dtype": str(dt).replace("torch.", ""),
                "fpn_sites": GN_SITES.get(h, 0)
                if (c, h, g, relu) == (128, w, 32, True) else 0,
                "bit_identical": same,
            })
            log(f"[kernel] {shape} {rows[-1]['dtype']} relu={relu} "
                f"{plan.variant} K={plan.cluster} threads={plan.threads} "
                f"splits={plan.splits} vec={plan.vec} clusters/card={occ}: "
                f"err {err:.3g} same {same:.6f} | kernel {ms:.4f} ms, "
                f"device {_ms_text(dev_ms)}, plain {plain_ms:.4f}, library "
                f"{library_ms:.4f}, copy_ {elementwise_ms:.4f}, bound "
                f"{bound_ms:.4f}")
            del y, again, yf
        del x, ref, rf
    return rows


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _gn_key(row: dict) -> tuple:
    """A GN row's launch key: the counters' ``launches_by_variant`` key."""
    return (row["variant"], *row["shape"], row["dtype"], row["relu"])


def phase_gn_launched(rows: list, by_path: dict) -> list:
    """GN rows at every key a main path launched and no row of ``rows``
    holds (``by_path[name][path]`` the path's launches by key): a partial
    tile batch, say, held against the plain version like the others.
    Raises if a launched key is then still without its row."""
    new: list = []
    for name, phase in (("group_norm_relu", phase_kernels),
                        ("group_norm_relu_backward",
                         phase_gn_backward_kernels)):
        launched = {k for counts in by_path[name].values()
                    for k, v in counts.items() if v}

        def held() -> set:
            return {_gn_key(r) for r in rows + new if r["name"] == name}

        shapes = sorted({k[1:] for k in launched - held()})
        if shapes:
            log(f"[kernel] {name}: rows at the paths' other keys {shapes}")
        if any(c != 128 or not relu for _, c, _, _, _, relu in shapes):
            raise AssertionError(f"{name}: launched at {shapes}, outside "
                                 "FPN's GN sites (C 128, 32 groups, ReLU)")
        if shapes and name == "group_norm_relu":
            new += phase([(n, c, h, w, 32, True, getattr(torch, dt))
                          for n, c, h, w, dt, _ in shapes])
        elif shapes:
            new += phase([(n, h, w, getattr(torch, dt))
                          for n, _, h, w, dt, _ in shapes])
        left = launched - held()
        if left:
            raise AssertionError(f"{name}: launched at keys no row holds "
                                 f"against its plain version: {sorted(left)}")
    return new


def phase_gn_backward_kernels(cases: list | None = None) -> list:
    """``group_norm_relu_backward``'s designs against its plain version on
    the forward kernel's own output and statistics, at ``cases``
    ``(n, h, w, dtype)`` (C 128, 32 groups, ReLU): by default the train
    step's batches and a few off the paths."""
    import torch.nn.functional as F

    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        cluster_occupancy,
        group_norm_relu,
        group_norm_relu_backward_reference,
    )

    set_tf32(False)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    if cases is None:
        cases = [(TRAIN_BATCH, hw, hw, dt) for dt in (bf16, f32)
                 for hw in GN_SITES]
        cases += [(CONFIG_BATCH, hw, hw, bf16) for hw in GN_SITES]
        # a multi-split streaming apply pass, and planes of 7x7 (the plan's
        # streaming design, scalar accesses)
        cases += [(8, hw, hw, dt) for hw in (128, 7) for dt in (bf16, f32)]
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    c, g = 128, 32
    for n, h, w, dt in cases:
        shape = (n, c, h, w)
        x = (torch.randn(shape, device="cuda", generator=gen) * 2.0
             + 0.5).to(dt)
        gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
        beta = torch.randn(c, device="cuda", generator=gen) * 0.1
        dy = torch.randn(shape, device="cuda", generator=gen).to(dt)
        stats = torch.empty(n, g, 2, device="cuda")
        out = group_norm_relu(x, gamma, beta, g, 1e-5, True, stats=stats)
        ref = group_norm_relu_backward_reference(dy, x, gamma, out, stats, g)
        rdx = ref[0].float()
        plain_ms = cuda_ms(lambda: group_norm_relu_backward_reference(
            dy, x, gamma, out, stats, g))
        xl = x.detach().requires_grad_()
        gl = gamma.to(dt).requires_grad_()
        bl = beta.to(dt).requires_grad_()
        yl = F.relu(F.group_norm(xl, g, gl, bl, 1e-5))
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            yl, (xl, gl, bl), dy, retain_graph=True))
        # the same bytes through one elementwise call: dy, x, out read,
        # one tensor written
        sink = torch.empty_like(x)
        elementwise_ms = cuda_ms(
            lambda: torch.addcmul(dy, x, out, out=sink))
        del sink
        elems = n * c * h * w
        bound_ms, bound_by = _bound(4 * elems * x.element_size() + 3 * c * 4,
                                    GN_BWD_OPS_PER_ELEMENT * elems)
        for plan, launch in _gn_variants(x, g, 2, sm_count):
            def call():
                return launch(dy, x, gamma, out, stats, g, True, plan)

            dx, dg, db = call()
            again = call()
            torch.cuda.synchronize()
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip((dx, dg, db), ref)]
            same = float((dx == ref[0]).float().mean())
            # dgamma/dbeta: f32 sums over N*H*W in another order
            ok = all(torch.allclose(a, b, rtol=1e-4,
                                    atol=1e-4 * float(b.abs().max()))
                     for a, b in zip((dg, db), ref[1:]))
            if dt == f32:
                ok = ok and torch.allclose(dx, rdx, rtol=1e-4, atol=1e-4)
            else:
                # one bf16 ulp (m1, m2 are f32 sums taken in another
                # order), plus 1e-3 of the tensor's largest |dx| where the
                # three terms cancel; nearly every element bit-identical
                ok = ok and same >= 0.999 and torch.allclose(
                    dx.float(), rdx, rtol=2 ** -7,
                    atol=1e-3 * float(rdx.abs().max()))
            repeat = all(torch.equal(a, b)
                         for a, b in zip((dx, dg, db), again))
            if not ok or not repeat or not torch.isfinite(dx.float()).all():
                raise AssertionError(
                    f"group_norm_relu_backward {shape} {dt} {plan}: "
                    f"max_abs_err dx/dgamma/dbeta {errs}, bit-identical "
                    f"{same}, repeatable {repeat}")
            occ = cluster_occupancy(x, g, plan, backward=True) \
                if plan.variant == "cluster" else None
            ms = cuda_ms(call)
            dev_ms = device_ms(call, GN_KERNELS_PER_CALL[2, plan.variant])
            rows.append({
                "name": "group_norm_relu_backward",
                "route": "cuda",
                "source": f"{PKG}/csrc/group_norm_relu.cu",
                "replaces": f"{PALLAS}:316",
                "launches": None,  # filled from the training path
                "max_abs_err": max(errs),
                "ms": ms,
                "device_ms": dev_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "elementwise_ms": elementwise_ms,
                **_variant_fields(plan, occ),
                "shape": list(shape),
                "groups": g,
                "relu": True,
                "dtype": str(dt).replace("torch.", ""),
                "fpn_sites": GN_SITES.get(h, 0) if h == w else 0,
                "bit_identical": same,
                "max_abs_err_dx_dgamma_dbeta": errs,
            })
            log(f"[kernel] bwd {shape} {rows[-1]['dtype']} {plan.variant} "
                f"K={plan.cluster} threads={plan.threads} splits="
                f"{plan.splits} vec={plan.vec} clusters/card={occ}: err dx "
                f"{errs[0]:.3g} dgamma {errs[1]:.3g} dbeta {errs[2]:.3g} "
                f"same {same:.6f} | kernel {ms:.4f} ms, device "
                f"{_ms_text(dev_ms)}, plain {plain_ms:.4f}, library "
                f"{library_ms:.4f}, addcmul {elementwise_ms:.4f}, bound "
                f"{bound_ms:.4f}")
            del dx, dg, db, again
        del x, dy, out, ref, rdx, xl, yl
    return rows


# (g_apply, choice, rot_k): none, hflip, rot90 k = 0..3, vflip
GEOMETRY = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2),
            (1, 1, 3), (1, 2, 0)]


def _augment_tables(n: int, seed: int):
    """The smoke's tables: they cycle through the seven geometry cases, each
    with the jitter on and off, with random factors and slot orders."""
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


def _masks(n: int, seed: int, size: int = TILE,
           classes: int = 1) -> np.ndarray:
    """Filled circles, one per patch, as uint8 {0, 1}; with ``classes``
    above 1, one circle per class id ``1..classes-1``, later ones on top."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        for c in range(1, max(classes, 2)):
            cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
            r = rng.integers(size // 8, size // 3)
            out[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
    return out


def _trainer_tables(n: int, seed: int):
    """Tables as the train step draws them (``draw_augment_scalars`` on a
    seeded host generator): about half the samples jittered, 5% transposed."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
        draw_augment_scalars,
        make_augment_tables,
    )

    gen = torch.Generator().manual_seed(seed)
    return make_augment_tables(*draw_augment_scalars(n, gen))


def phase_augment_kernels() -> list:
    """``fused_train_transform`` against its plain version, the bf16 chain
    of ``ops/augment.py``, on the same tables: at 512² on the smoke's tables
    (batch 32 and 128) and on the trainer's draws (batch 128), and at 200²
    (rows that are not 16-byte aligned: the byte-load instantiation)."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
        fused_train_transform,
        fused_train_transform_reference,
        vector_path,
    )

    rows = []
    cases = [(TRAIN_BATCH, TILE, "smoke"), (CONFIG_BATCH, TILE, "smoke"),
             (CONFIG_BATCH, TILE, "trainer"), (8, 200, "smoke")]
    for n, size, which in cases:
        images = torch.from_numpy(_tiles(n, seed=20 + n, size=size)).cuda()
        masks = torch.from_numpy(_masks(n, seed=n, size=size)).cuda()
        tables = (_augment_tables(n, seed=n) if which == "smoke"
                  else _trainer_tables(n, seed=n)).to("cuda")
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
        vec = vector_path(size, images, masks, out, mout)
        if not torch.equal(mout, rmask) or same < 0.999 or beyond \
                or not repeat or not torch.isfinite(o).all() \
                or vec != (size % 16 == 0):
            raise AssertionError(
                f"fused_train_transform n={n} size={size} {which} tables: "
                f"masks equal {torch.equal(mout, rmask)}, max_abs_err {err}, "
                f"bit-identical {same}, beyond the bound {beyond}, "
                f"repeatable {repeat}, 16-byte path {vec}")

        def call():
            return fused_train_transform(images, masks, tables)

        def copy():
            # the same bytes with no arithmetic: u8 NHWC read, bf16 NCHW and
            # f32 masks written
            out.copy_(images.permute(0, 3, 1, 2))
            mout.copy_(masks)

        ms = cuda_ms(call)
        dev_ms = device_ms(call, AUG_LAUNCHES_PER_CALL)
        copy_ms = cuda_ms(copy)
        plain_ms = cuda_ms(lambda: fused_train_transform_reference(
            images, masks, tables), warmup=2, iters=5)
        pixels = n * size * size
        jittered = int(tables.ints[:, 4].sum())
        transposed = int(tables.geom[:, 0].sum())
        bound_ms, bound_by = _bound(
            pixels * (3 + 1) + pixels * (3 * 2 + 4),
            pixels * AUG_OPS_PER_PIXEL
            + jittered * size * size * AUG_JITTER_OPS_PER_PIXEL)
        rows.append({
            "name": "fused_train_transform",
            "route": "cuda",
            "source": f"{PKG}/csrc/fused_augment.cu",
            "replaces": f"{PALLAS_AUG}:79",
            "launches": None,  # filled from the training path, by shape
            "max_abs_err": err,
            "ms": ms,
            "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes it
            "copy_ms": copy_ms,
            "shape": [n, size, size, 3],
            "tables": which,
            "vec": vec,
            "jittered": jittered,
            "transposed": transposed,
            "bit_identical": same,
        })
        log(f"[kernel] augment ({n}, {size}, {size}, 3) {which} tables, "
            f"jittered {jittered}, transposed {transposed}, 16-byte path "
            f"{vec}: err {err:.3g} same {same:.6f}, masks bitwise | kernel "
            f"{ms:.4f} ms, device {_ms_text(dev_ms)}, copy {copy_ms:.4f}, "
            f"plain {plain_ms:.4f}, bound {bound_ms:.4f}")
        del images, masks, out, out2, ref, o, r
    return rows


# -- phase 4 ----------------------------------------------------------------

def _tiles(n: int, seed: int, size: int = TILE) -> np.ndarray:
    """Smooth, tissue-like uint8 tiles: bilinear-upsampled low-resolution
    colour noise plus fine noise (a copy of the cached batch: making 128
    tiles of 512² takes the host about 5 s, and the timed steps all take
    the same ones)."""
    return _tiles_cached(n, seed, size).copy()


@functools.lru_cache(maxsize=8)
def _tiles_cached(n: int, seed: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(40, 230, (n, 3, 16, 16))
                              .astype(np.float32))
    smooth = torch.nn.functional.interpolate(
        coarse, size=(size, size), mode="bilinear", align_corners=False)
    img = smooth.numpy().transpose(0, 2, 3, 1) + rng.normal(
        0, 12, (n, size, size, 3))
    return img.clip(0, 255).astype(np.uint8)


def _post(url: str, body: bytes, headers: dict):
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _classifier_top(backbone: str, seed: int, smp: bool = False) -> dict:
    """The classifier an ImageNet file of ``backbone``'s family carries
    beside its encoder (torchvision's ``fc``/``classifier.1``,
    efficientnet-pytorch's ``_conv_head``/``_bn1``/``_fc``), seeded; with
    ``smp``, what smp's encoder keeps of it (EfficientNet's unrun
    ``_conv_head`` and ``_bn1``; nothing of the others)."""
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        efficientnet,
    )

    rng = np.random.default_rng(seed)

    def arr(*shape):
        return torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32))

    if backbone in efficientnet.VARIANTS:
        cin = efficientnet.feature_channels(backbone)[-1]
        c = efficientnet.round_filters(1280, efficientnet.VARIANTS[backbone][0])
        top = {"_conv_head.weight": arr(c, cin, 1, 1), "_bn1.weight": arr(c),
               "_bn1.bias": arr(c), "_bn1.running_mean": arr(c),
               "_bn1.running_var": arr(c).abs() + 0.5,
               "_bn1.num_batches_tracked": torch.tensor(0)}
        return top if smp else dict(top, **{"_fc.weight": arr(1000, c),
                                            "_fc.bias": arr(1000)})
    if smp:
        return {}
    if backbone == "mobilenet_v2":
        return {"classifier.1.weight": arr(1000, 1280),
                "classifier.1.bias": arr(1000)}
    return {"fc.weight": arr(1000, 512), "fc.bias": arr(1000)}


def _write_reference_pth(cfg, path: Path, seed: int) -> dict:
    """A seeded reference ``.pth`` of ``cfg``'s model in smp's layout (an
    EfficientNet encoder with smp's unrun ``encoder._conv_head``/``_bn1``);
    returns the port's weights."""
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    sd = seeded_state_dict(build_model(cfg), seed=seed)
    top = {f"encoder.{k}": v for k, v in
           _classifier_top(cfg.backbone, seed, smp=True).items()}
    torch.save({"model": {f"module.{k}": v for k, v in {**sd, **top}.items()},
                "epoch": 0, "previous_best": 0.0}, path)
    return sd


def _pretrained_file(tmp: Path, backbone: str, seed: int) -> tuple:
    """A seeded ImageNet encoder file in its family's layout, classifier
    top included: torchvision's resnet18 as the ``.npz`` that
    ``scripts/convert_torchvision_resnet18.py`` writes, torchvision's
    mobilenet_v2 and efficientnet-pytorch's b* as a bare ``.pth``.
    Returns its path and the encoder's tensors."""
    from pdac_pathological_image_segmentation_tpu_torch.models.encoders import (
        build_encoder,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    enc = seeded_state_dict(build_encoder(backbone), seed=seed)
    full = {**enc, **_classifier_top(backbone, seed)}
    if backbone == "resnet18":
        path = tmp / "resnet18_imagenet.npz"
        np.savez(path, **{k: v.numpy() for k, v in full.items()})
    else:
        path = tmp / f"{backbone}_imagenet.pth"
        torch.save(full, path)
    return path, enc


def _export(tmp: Path, cfg_d: dict, name: str):
    """A seeded reference ``.pth`` for ``cfg_d`` → ``cli.export`` (tile 512)
    → the artifact loaded on the card; returns the weights and it."""
    import yaml

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        export as cli_export,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        load_serving_artifact,
    )

    cfg_path = tmp / f"{name}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg_d))
    pth = tmp / f"{name}.pth"
    sd = _write_reference_pth(Config.from_dict(cfg_d), pth, seed=0)
    art_path = tmp / f"{name}.pdacpt"
    cli_export.main(["--config", str(cfg_path), "--pth_path", str(pth),
                     "--out", str(art_path), "--tile", str(TILE)])
    return sd, load_serving_artifact(str(art_path), device="cuda")


def _serve_http(artifact) -> dict:
    """48 PNG tiles from 8 concurrent clients and one raw-f32 request over
    HTTP, the daemon on the card at buckets 1/8/32: every response whole,
    the raw one bit-equal to a direct artifact call.  The GN counters are
    set to 0 just before the daemon starts and read just after the last
    response; returns them with the daemon's stats."""
    from PIL import Image

    from pdac_pathological_image_segmentation_tpu_torch.infer.server import (
        SegmentationServer,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu,
    )

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
    group_norm_relu.launches_by_variant.clear()
    _int8_counts(reset=True)
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
    by_variant = dict(group_norm_relu.launches_by_variant)
    int8_launches, int8_by_shape = _int8_counts()
    quantize_by_shape = _quantize_counts()
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
    if stats["requests"] != n_tiles + 1:
        raise AssertionError(f"daemon stats {stats}")
    return {"stats": stats, "launches": launches, "by_shape": by_shape,
            "by_variant": by_variant, "http_s": http_s,
            "n_clients": n_clients, "int8_launches": int8_launches,
            "int8_by_shape": int8_by_shape,
            "quantize_by_shape": quantize_by_shape}


def _serve_log(what: str, served: dict) -> str:
    stats = served["stats"]
    return (f"[serve] {what}: {stats['requests']} requests in "
            f"{stats['batches']} device batches (+{stats['warmups']} "
            f"warm-ups), occupancy {stats.get('mean_batch_occupancy', 0):.3f},"
            f" p50 {stats.get('latency_ms_p50', 0):.1f} ms, p99 "
            f"{stats.get('latency_ms_p99', 0):.1f} ms; 48 PNG tiles over HTTP "
            f"from {served['n_clients']} clients in {served['http_s']:.2f} s, "
            "the raw response bit-equal to a direct call")


def _profile_by_kernel(fn) -> dict:
    """Device ms by kernel name of one call of ``fn`` (kernels only: an
    operator's device time is its kernels' again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / 1e3
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def phase_serving(tmp: Path, card: str, backbone: str = "resnet18") -> tuple:
    """FPN on ``backbone``: a seeded smp reference ``.pth`` → ``cli.export``
    → the daemon; every GN of every device batch through the cluster
    kernel, 7 a batch, per shape (the decoder's widths do not depend on the
    encoder).  Returns the weights, the GN launches by variant and the
    direct calls' numbers."""
    set_tf32(False)
    sd, artifact = _export(tmp, {"model": "fpn", "backbone": backbone,
                                 "img_size": TILE,
                                 "compute_dtype": "bfloat16"},
                           f"{_tag('fpn', backbone)}512")
    if artifact.meta.get("backbone") != backbone:
        raise AssertionError(f"artifact metadata {artifact.meta}")
    served = _serve_http(artifact)
    stats, launches = served["stats"], served["launches"]
    by_shape, by_variant = served["by_shape"], served["by_variant"]
    forwards = stats["batches"] + stats["warmups"]
    expected = sum(GN_SITES.values()) * forwards
    if launches != expected:
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
    _all_cluster("serving GN forward", by_variant, by_shape)
    log(_serve_log(f"fpn/{backbone}", served)
        + f"; GN kernel launches {launches} = 7 x (batches + warm-ups); "
        f"forwards by bucket {per_bucket}")
    direct = _direct_and_profile(artifact, f"fpn/{backbone}", card)
    return sd, by_variant, {
        **direct, "latency_ms_p50": served["stats"].get("latency_ms_p50"),
        "latency_ms_p99": served["stats"].get("latency_ms_p99")}


def _direct_and_profile(artifact, model: str, card: str) -> dict:
    """Direct artifact calls at the largest bucket (H2D + D2H included),
    then one forward at that bucket with the input on the card: ms by
    CUDA events and the profiler's device time by kernel."""
    batch = _tiles(BUCKETS[-1], seed=3)
    fn = artifact.aot(BUCKETS[-1])
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(batch)
    dt = time.perf_counter() - t0
    tiles_per_s = reps * BUCKETS[-1] / dt
    log(f"[serve] {model} direct artifact calls at bucket {BUCKETS[-1]}: "
        f"{tiles_per_s:.1f} tiles/s ({dt / reps * 1e3:.1f} ms per call) on "
        f"{card}")
    x = torch.from_numpy(batch).cuda()
    step = artifact.step
    fwd_ms = cuda_ms(lambda: step(x), warmup=2, iters=10)
    torch.cuda.reset_peak_memory_stats()
    by_name = _profile_by_kernel(lambda: step(x))
    peak = torch.cuda.max_memory_allocated()
    total = sum(by_name.values())
    gn = sum(v for k, v in by_name.items()
             if any(p in k for p in GN_FORWARD_KERNELS))
    log(f"[profile] {model} bucket-{BUCKETS[-1]} forward: {fwd_ms:.3f} ms by "
        f"CUDA events; profiler device time {total:.3f} ms, idle share "
        f"{max(0.0, 1 - total / fwd_ms):.3f}, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, GroupNorm kernels {gn:.3f} ms "
        f"({100 * gn / total if total else 0:.1f}%)")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {v:8.3f} ms  {k[:110]}")
    return {"tiles_per_s": tiles_per_s, "forward_ms": fwd_ms,
            "forward_profile_ms": total, "forward_peak_bytes": peak}


def phase_model_serving(tmp: Path, card: str, model: str,
                        backbone: str = "resnet18") -> dict:
    """``model`` on ``backbone`` (bf16, 512²): a seeded reference ``.pth``
    in the port's names (smp's for DeepLabV3+ and PSPNet) → ``cli.export``
    → the daemon at buckets 1/8/32 with the same requests as FPN's; none of
    these models has a GroupNorm, so no GN kernel may run.  Then direct
    artifact calls and the profiled forward at bucket 32."""
    set_tf32(False)
    sd, artifact = _export(tmp, {"model": model, "backbone": backbone,
                                 "img_size": TILE,
                                 "compute_dtype": "bfloat16"},
                           f"{_tag(model, backbone)}512")
    served = _serve_http(artifact)
    if served["launches"]:
        raise AssertionError(f"{model} serving launched GN "
                             f"{served['launches']} times")
    log(_serve_log(f"{model}/{backbone}", served) + "; no GN kernel ran")
    return {"sd": sd,
            **_direct_and_profile(artifact, f"{model}/{backbone}", card),
            "latency_ms_p50": served["stats"].get("latency_ms_p50"),
            "latency_ms_p99": served["stats"].get("latency_ms_p99")}


def phase_dilations_artifact(tmp: Path) -> None:
    """A DeepLabV3+ artifact exported with ``dilations: (6, 12, 18)``
    serves on the card what the ``.pth`` of phase 4c serves at those rates
    (the artifact carries the rates), which is not what the default rates
    give on the same weights."""
    import yaml

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        export as cli_export,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        load_serving_state,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        load_serving_artifact,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_infer_step,
    )

    set_tf32(False)
    cfg_d = {"model": "deeplabv3+", "backbone": "resnet18", "img_size": TILE,
             "compute_dtype": "bfloat16", "dilations": "(6, 12, 18)"}
    cfg_path = tmp / "deeplab_rates.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg_d))
    pth, art = tmp / "deeplabv3+512.pth", tmp / "deeplab_rates.pdacpt"
    with contextlib.redirect_stdout(io.StringIO()):
        cli_export.main(["--config", str(cfg_path), "--pth_path", str(pth),
                         "--out", str(art), "--tile", str(TILE)])
    artifact = load_serving_artifact(str(art), device="cuda")
    tiles = _tiles(8, seed=7)
    served = artifact(tiles)
    x = torch.from_numpy(tiles).cuda()
    probs = {}
    for rates in ("(6, 12, 18)", "(3, 6, 9)"):
        model, _ = load_serving_state(
            Config.from_dict(dict(cfg_d, dilations=rates)), str(pth), "cuda")
        probs[rates] = make_infer_step(model, TILE)(x).cpu().numpy()
    same = float(np.abs(served - probs["(6, 12, 18)"]).max())
    other = float(np.abs(served - probs["(3, 6, 9)"]).max())
    if artifact.meta.get("dilations") != [6, 12, 18] or same > 1e-6 \
            or other < 1e-3:
        raise AssertionError(f"dilations artifact: meta {artifact.meta}, "
                             f"vs the .pth at its rates {same}, vs the "
                             f"default rates {other}")
    log(f"[serve] deeplabv3+ artifact exported with dilations (6, 12, 18): "
        f"metadata {artifact.meta['dilations']}; vs --pth_path at those "
        f"rates max |Δp| {same:.3g} (bound 1e-6), vs the default rates "
        f"{other:.3g} (must exceed 1e-3)")


def phase_unet_serving(tmp: Path, card: str) -> dict:
    """ResUNet (the reference's own model) exported with ``head_dtype:
    bfloat16``, served over HTTP as FPN is, then the bench's tile→mask
    program timed at batch 512 with the input on the card.  ResUNet has no
    GroupNorm: the daemon must launch no GN kernel."""
    set_tf32(False)
    sd, artifact = _export(tmp, {"model": "unet", "img_size": TILE,
                                 "compute_dtype": "bfloat16",
                                 "head_dtype": "bfloat16"}, "unet512")
    if artifact.meta.get("head_dtype") != "bfloat16":
        raise AssertionError(f"unet artifact metadata {artifact.meta}")
    served = _serve_http(artifact)
    if served["launches"]:
        raise AssertionError(f"unet serving launched GN {served['launches']}"
                             " times")
    log(_serve_log("unet/resnet18, head bf16", served))

    # the bench's program: 512 tiles of 512² uint8 on the card → masks
    step = artifact.step
    x = torch.from_numpy(_tiles(32, seed=6)).cuda().repeat(
        UNET_INFER_BATCH // 32, 1, 1, 1)
    step(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(x), warmup=1, iters=4, windows=3)
    peak = torch.cuda.max_memory_allocated()
    probs = step(x)
    if tuple(probs.shape) != (UNET_INFER_BATCH, TILE, TILE) \
            or not torch.isfinite(probs).all():
        raise AssertionError(f"batch-512 probabilities {tuple(probs.shape)}")
    del probs
    by_name = _profile_by_kernel(lambda: step(x))
    total = sum(by_name.values())
    log(f"[unet-infer] tile->mask at batch {UNET_INFER_BATCH}, {TILE}² uint8 "
        f"in ({x.numel() / 1e9:.3f} GB), bf16, head bf16, input on the "
        f"card: {ms:.3f} ms by CUDA events, "
        f"{UNET_INFER_BATCH * 1e3 / ms:.1f} tiles/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, on {card}")
    log(f"[profile] one batch-{UNET_INFER_BATCH} unet forward: profiler "
        f"device time {total:.3f} ms, idle share "
        f"{max(0.0, 1 - total / ms):.3f}")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {v:8.3f} ms  {k[:110]}")
    del x
    return {"sd": sd, "infer_ms": ms, "peak_bytes": peak}


# -- phase 5: training, the new main path -----------------------------------

def _write_patches(root: Path, n: int, seed: int, classes: int = 1) -> None:
    """``n`` synthetic 512² image/mask PNG pairs in the reference's layout
    (``patch_i.png`` + ``patch_i-labelled.png``): tissue-like tiles with a
    filled circle, tinted purple, as the label; with ``classes`` above 1,
    a circle per class id, each its own tint."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    root.mkdir(parents=True)
    images, masks = _tiles(n, seed), _masks(n, seed, classes=classes)
    tints = np.asarray([[120, 60, 160], [200, 90, 120]], np.float32)

    def write(i: int) -> None:
        img = images[i].astype(np.float32)
        for c in range(1, max(classes, 2)):
            m = masks[i] == c
            img[m] = 0.5 * img[m] + 0.5 * tints[c - 1]
        Image.fromarray(img.astype(np.uint8)).save(
            root / f"patch_{i:04d}.png", compress_level=1)
        Image.fromarray(masks[i]).save(root / f"patch_{i:04d}-labelled.png",
                                       compress_level=1)

    # PIL's encoder lets go of the interpreter lock: the files in parallel
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, range(n)))


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
            if hasattr(fn, "launches_by_variant"):
                fn.launches_by_variant.clear()
    return {k: (fn.launches, dict(fn.launches_by_shape),
                dict(getattr(fn, "launches_by_variant", {})))
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


N_TRAIN, N_VAL, N_TEST = 96, 32, 16


def phase_data(tmp: Path) -> None:
    """Synthetic 512² PNG patches: train and val for the training phases,
    test for the evaluation phase."""
    t0 = time.perf_counter()
    for split, n, seed in (("train", N_TRAIN, 30), ("val", N_VAL, 31),
                           ("test", N_TEST, 32)):
        _write_patches(tmp / "data" / split, n, seed)
    log(f"[data] {N_TRAIN} train + {N_VAL} val + {N_TEST} test synthetic "
        f"{TILE}² PNG patches in {time.perf_counter() - t0:.1f} s")


def _train_config(tmp: Path, model: str, epochs: int,
                  backbone: str = "resnet18", name: str | None = None,
                  batch: int = TRAIN_BATCH, data: str = "data",
                  **extra) -> tuple:
    """``configs/train_config.yaml`` for ``model`` on ``backbone`` with the
    smoke's cuts (the batch cut to ``batch``), the synthetic splits under
    ``tmp / data`` and ``extra`` keys, written as ``train_<name>.yaml``
    (the run's tag by default); its path and the cuts."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "train_config.yaml").read_text())
    cuts = {"epochs": (cfg["epochs"], epochs),
            "batch_size": (cfg["batch_size"], batch)}
    cfg.update({k: v[1] for k, v in cuts.items() if v[0] != v[1]})
    cuts = {k: v for k, v in cuts.items() if v[0] != v[1]}
    cfg.update({"model": model, "backbone": backbone,
                "train_path": str(tmp / data / "train"),
                "val_path": str(tmp / data / "val"),
                "test_path": str(tmp / data / "test"), **extra})
    cfg_path = tmp / f"train_{name or _tag(model, backbone)}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return cfg_path, cfg, cuts


def _check_pretrained_start(cfg_path: Path, want: dict) -> int:
    """The ``Trainer`` that ``cli.train`` builds for ``cfg_path`` holds the
    ``pretrained_path`` file's encoder before its first step; returns the
    tensors compared."""
    from pdac_pathological_image_segmentation_tpu_torch.config import (
        load_config,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
        discover_split,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
        PatchDataset,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.loop import (
        Trainer,
    )

    cfg = load_config(str(cfg_path))
    ds = PatchDataset(*discover_split(cfg.train_path), cfg)
    with tempfile.TemporaryDirectory() as out, \
            contextlib.redirect_stdout(io.StringIO()):
        enc = Trainer(cfg, out, ds, ds, device="cuda").model.encoder
    got = enc.state_dict()
    bad = [k for k, v in want.items()
           if not torch.equal(got[k].cpu(), v)]
    if bad or set(got) != set(want):
        raise AssertionError(f"encoder before the first step differs from "
                             f"the pretrained file at {bad[:4]}")
    del enc, got
    torch.cuda.empty_cache()
    return len(want)


def _expected_train_launches(steps: int, evals: int, batch: int,
                             eval_batch: int, fused: bool, gn: bool,
                             micro: int = 1, remat: bool = False) -> tuple:
    """``(totals, by shape)`` of a cli.train path's augmentation and GN
    launches: each train step's GN sites run once a microbatch forward
    (twice under remat: the recompute) and once backward, each eval batch's
    once forward."""
    sites = sum(GN_SITES.values()) if gn else 0
    mb = batch // micro
    fwd_per_step = micro * (2 if remat else 1)
    fwd, bwd = {}, {}
    if gn:
        for hw, k in GN_SITES.items():
            train_key = (mb, 128, hw, hw, "bfloat16", True)
            eval_key = (eval_batch, 128, hw, hw, "bfloat16", True)
            fwd[train_key] = fwd.get(train_key, 0) + k * steps * fwd_per_step
            fwd[eval_key] = fwd.get(eval_key, 0) + k * evals
            bwd[train_key] = k * steps * micro
    totals = {"augment": steps if fused else 0,
              "gn_backward": sites * steps * micro,
              "gn_forward": sites * (steps * fwd_per_step + evals)}
    shapes = {"augment": {(batch, TILE): steps} if fused else {},
              "gn_forward": fwd, "gn_backward": bwd}
    return totals, shapes


def phase_training(tmp: Path, model: str = "fpn",
                   backbone: str = "resnet18", pretrained: bool = False
                   ) -> dict:
    """``cli.train`` for 2 epochs, then a rerun with 3 that must resume;
    every train step through the augmentation kernel and, for FPN, every
    GN site through the cluster forward and backward kernels (the other
    models have no GroupNorm: none may run).  With ``pretrained``, the
    config's ``pretrained_path`` names a seeded ImageNet file of
    ``backbone``'s family, whose encoder the trainer must hold before its
    first step."""
    tag = _tag(model, backbone)
    extra = {}
    if pretrained:
        path, want = _pretrained_file(tmp, backbone, seed=12)
        extra["pretrained_path"] = str(path)
    cfg_path, cfg, cuts = _train_config(tmp, model, 2, backbone, **extra)
    if pretrained:
        n = _check_pretrained_start(cfg_path, want)
        log(f"[train] {tag}: the trainer's encoder before its first step "
            f"equals the pretrained file {path.name} ({n} tensors, "
            "classifier top dropped)")
    log(f"[train] {tag}: configs/train_config.yaml "
        f"({cfg['model']}/{cfg['backbone']}, {cfg['compute_dtype']}, "
        f"img_size {cfg['img_size']}, lr {cfg['lr']}) with the cuts "
        + ", ".join(f"{k} {a} -> {b}" for k, (a, b) in cuts.items()))
    out = tmp / f"train_{tag}_out"
    # -- the main path: launches counted from here ...
    _train_counters(reset=True)
    first, _, s1 = _run_cli_train(cfg_path, out)
    _train_config(tmp, model, 3, backbone, **extra)
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
    steps = 3 * -(-N_TRAIN // TRAIN_BATCH)
    evals = 3 * -(-N_VAL // TRAIN_BATCH)
    sites = sum(GN_SITES.values()) if model == "fpn" else 0
    want, want_shapes = _expected_train_launches(
        steps, evals, TRAIN_BATCH, TRAIN_BATCH, True, model == "fpn")
    got = {k: v[0] for k, v in counts.items()}
    if got != want or any(counts[k][1] != want_shapes[k] for k in want):
        raise AssertionError(f"training launches {counts}, expected {want} "
                             f"({steps} steps, {evals} eval batches)")
    for k in ("gn_forward", "gn_backward"):
        _all_cluster(f"training {k}", counts[k][2], counts[k][1])
    log(f"[train] {tag}: 2 epochs in {s1:.1f} s, resumed for a 3rd in "
        f"{s2:.1f} s; losses {[round(h['train_loss'], 4) for h in history]},"
        f" val scores {[round(h['val_score'], 4) for h in history]}; "
        f"launches: augment {got['augment']} = {steps} steps, GN backward "
        f"{got['gn_backward']} = {sites} x {steps}, GN forward "
        f"{got['gn_forward']} = {sites} x ({steps} steps + {evals} eval "
        "batches)")
    return counts


# -- phase 5c: evaluation ---------------------------------------------------

def _run_cli_test(cfg_path: Path, pth: Path, out: Path, device: str) -> dict:
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        test as cli_test,
    )

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        # no figures: they need matplotlib, which the smoke does not
        # require of the card's host
        result = cli_test.main(["--config", str(cfg_path), "--save_path",
                                str(out), "--pth_path", str(pth),
                                "--max_figures", "0", "--device", device])
    result["seconds"] = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"[test]   {line}")
    return result


def phase_evaluation(tmp: Path) -> dict:
    """``cli.test --device cuda`` on every training run's ``best.pth``
    (bf16, the config's), then each again in f32 on the card (TF32 off)
    and on the CPU.  Only the FPN runs have GroupNorm sites.  A main path
    per run: the GN counters are set to 0 just before it and read just
    after."""
    import yaml

    set_tf32(False)
    runs_of = {_tag(m, b): (m, b) for m, b in
               [(m, "resnet18") for m in MODELS] + list(ENCODER_PATHS)}
    cfgs = {}
    for tag, (model, backbone) in runs_of.items():
        cfg_path, cfg, _ = _train_config(tmp, model, 3, backbone)
        cfg["batch_size"] = EVAL_BATCH
        for dtype in ("bfloat16", "float32"):
            path = tmp / f"test_{tag}_{dtype}.yaml"
            path.write_text(yaml.safe_dump(dict(cfg, compute_dtype=dtype)))
            cfgs[tag, dtype] = path
    pths = {t: tmp / f"train_{t}_out" / "pth" for t in runs_of}
    batches = -(-N_TEST // EVAL_BATCH)
    runs, by_variant = {}, {}
    for tag, (model, _) in runs_of.items():
        # -- the main path: launches counted from here ...
        _gn_forward_counts(reset=True)
        runs[tag] = _run_cli_test(cfgs[tag, "bfloat16"], pths[tag],
                                  tmp / f"test_{tag}_out", "cuda")
        counts = _gn_forward_counts()
        # -- ... to here
        _check_forwards(f"cli.test {tag}", counts,
                        {EVAL_BATCH: batches} if model == "fpn" else {})
        runs[tag]["gn_launches"] = counts[0]
        by_variant[tag] = counts[2]
    for m, res in runs.items():
        out = tmp / f"test_{m}_out"
        rows = (out / "metrics.csv").read_text().splitlines()
        sweep = (out / "threshold_sweep.csv").read_text().splitlines()
        if len(rows) != 1 + N_TEST + 2 or len(sweep) != 1 + 257 \
                or res["n_samples"] != N_TEST or not all(np.isfinite(
                    [res["test_score"], res["test_loss"],
                     res["best_dice"]])):
            raise AssertionError(f"cli.test {m}: {res}, metrics.csv "
                                 f"{len(rows)} lines, sweep {len(sweep)}")
        log(f"[test] {m} bf16 on the card: test_score {res['test_score']:.6f}"
            f" test_loss {res['test_loss']:.6f}, best threshold "
            f"{res['best_threshold']:.4f} (dice {res['best_dice']:.6f}), "
            f"metrics.csv {len(rows) - 3} samples + macro/micro, "
            f"threshold_sweep.csv 257 rows, {res['seconds']:.1f} s")
    log("[test] GN forward launches " + ", ".join(
        f"{t} {r['gn_launches']}" for t, r in runs.items())
        + f": 7 x {batches} eval batches for each FPN, all cluster; the other "
        "models launched none")
    # card vs CPU, f32 (comparison runs: not counted)
    for m in runs_of:
        card = _run_cli_test(cfgs[m, "float32"], pths[m],
                             tmp / f"test_{m}_card32", "cuda")
        cpu = _run_cli_test(cfgs[m, "float32"], pths[m],
                            tmp / f"test_{m}_cpu32", "cpu")
        d_score = abs(card["test_score"] - cpu["test_score"])
        d_loss = abs(card["test_loss"] - cpu["test_loss"])
        if d_score > 1e-3 or not np.isfinite(d_loss):
            raise AssertionError(f"cli.test {m} f32 card vs CPU: test_score "
                                 f"{card['test_score']} vs "
                                 f"{cpu['test_score']}")
        log(f"[test] {m} f32, card vs CPU: test_score {card['test_score']:.6f}"
            f" vs {cpu['test_score']:.6f} (|Δ| {d_score:.3g}, bound 1e-3), "
            f"test_loss |Δ| {d_loss:.3g}; CPU run {cpu['seconds']:.1f} s")
    return {"by_variant": by_variant,
            "scores": {m: runs[m]["test_score"] for m in runs_of},
            "seconds": {m: runs[m]["seconds"] for m in runs_of}}


# -- phase 9: whole-slide inference ------------------------------------------

WSI_SIDE = 8192  # the CLI's slides
# BASELINE.md:175 (bench.py --mode wsi --size 40960): the "~40k x 40k @ 20x"
# slide, 25,281 windows at stride 256
WSI_TIMED_SIDE = 40_960
WSI_STRIDE = 256
WSI_CPU_SIDE = 1024  # card vs CPU


def _gn_forward_counts(reset: bool = False) -> tuple:
    """The GN forward's counters ``(launches, by shape, by variant)``; with
    ``reset`` they are set to 0 first."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu,
    )

    if reset:
        group_norm_relu.launches = 0
        group_norm_relu.launches_by_shape.clear()
        group_norm_relu.launches_by_variant.clear()
    return (group_norm_relu.launches, dict(group_norm_relu.launches_by_shape),
            dict(group_norm_relu.launches_by_variant))


def _check_forwards(what: str, counts: tuple, forwards: dict) -> None:
    """``counts`` are 7 GN launches per forward, ``forwards[n]`` forwards
    at batch ``n`` (bf16), per shape, all through the cluster kernel."""
    launches, by_shape, by_variant = counts
    want = {(n, 128, hw, hw, "bfloat16", True): k * f
            for n, f in forwards.items() for hw, k in GN_SITES.items()}
    if launches != sum(want.values()) or by_shape != want:
        raise AssertionError(f"{what}: GN launches {launches} {by_shape}, "
                             f"expected 7 x forwards {forwards}: {want}")
    _all_cluster(what, by_variant, by_shape)


def _add_counts(total: dict, by_variant: dict) -> None:
    for k, v in by_variant.items():
        total[k] = total.get(k, 0) + v


def _run_cli_overlay(argv: list) -> tuple:
    """``cli.overlay`` with ``argv``; its result, what it printed and the
    printed tumor fraction."""
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        overlay as cli_overlay,
    )

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli_overlay.main(argv)
    result["seconds"] = time.perf_counter() - t0
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"[wsi]   {line}")
    if "warning" in printed:
        raise AssertionError(f"cli.overlay warned: {printed}")
    frac = float(printed.split("(tumor fraction ")[1].split(",")[0])
    return result, printed, frac


def _windows(side: int, stride: int, tile: int = TILE) -> int:
    return len(range(0, side - tile + 1, stride)) + bool((side - tile)
                                                         % stride)


def _wsi_slide(side: int, seed: int) -> np.ndarray:
    """A ``side``² H&E-like slide: the port's ``SyntheticSlideSource``
    (tissue cells with a purple blob, 30% glass) read as one region."""
    from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
        SyntheticSlideSource,
    )

    return SyntheticSlideSource(side, tile=TILE, seed=seed).read_region(
        0, 0, side, side)


def _check_prob_map(what: str, path: Path, shape: tuple, dtype) -> np.ndarray:
    prob = np.load(path)
    p = prob.astype(np.float32)
    if prob.shape != shape or prob.dtype != dtype or not np.isfinite(p).all() \
            or p.min() < 0 or p.max() > 1:
        raise AssertionError(f"{what}: {path.name} {prob.shape} {prob.dtype} "
                             f"range [{p.min()}, {p.max()}]")
    return prob


def _check_tiff_readback(what: str, path: Path, values: np.ndarray) -> int:
    """The exported TIFF, read back with the port's ``TiffSlide``, holds
    ``round(values * 255)`` at level 0 (in ``values``' own dtype, as the
    writer takes it); returns its level count."""
    from pdac_pathological_image_segmentation_tpu_torch.data.tiffslide import (
        TiffSlide,
    )

    want = np.clip(np.round(values * 255.0), 0, 255).astype(np.uint8)
    with TiffSlide(str(path)) as s:
        w, h = s.dimensions(0)
        got = s.read_region(0, 0, 0, w, h)
        levels = s.level_count
    if got.shape[:2] != values.shape or not np.array_equal(got[..., 0], want):
        raise AssertionError(f"{what}: {path.name} read back differs")
    return levels


def phase_wsi_cli(tmp: Path, card: str) -> dict:
    """``cli.overlay --device cuda`` with phase 5's FPN ``best.pth`` on the
    config (bf16, batch max(128, 8)): a JPEG TIFF written by PIL (plain
    runner, GeoJSON, TIFF export, region cleaning), a deflate pyramidal
    tiled TIFF written by the port's writer (banded runner, stride 256,
    hann, TTA, uncertainty), an exported artifact on the JPEG TIFF, and a
    PyHIST directory.  Each run is a main path: the GN counters are set to
    0 just before it and read just after; 7 launches per tile batch (x 8
    with TTA), per shape, all cluster."""
    import yaml
    from PIL import Image

    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        export as cli_export,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
        parse_geojson,
        rasterize_shapes,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.tiffwriter import (
        write_tiff,
    )

    from pdac_pathological_image_segmentation_tpu_torch.data import tiffslide

    set_tf32(False)
    t0 = time.perf_counter()
    lib = tiffslide.build()
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    log(f"[wsi] native TIFF reader (tiffreader.cpp + jpegdec.cpp, -lz) built "
        f"by {gxx} in {time.perf_counter() - t0:.1f} s: "
        f"{lib.relative_to(ROOT)}")
    wsi = tmp / "wsi"
    wsi.mkdir()
    t0 = time.perf_counter()
    slide = _wsi_slide(WSI_SIDE, seed=40)
    jpeg, tiled = wsi / "slide_jpeg.tiff", wsi / "slide_tiled.tiff"
    Image.fromarray(slide).save(jpeg, compression="jpeg", quality=90)
    levels = write_tiff(str(tiled), slide, tile=256, compression="deflate",
                        min_size=TILE)
    # the PyHIST directory: a 3 x 3 grid of tile PNGs, one not kept
    tiles_dir = wsi / "tiles"
    tiles_dir.mkdir()
    rows = ["Tile\tRow\tColumn\tKeep"]
    for r in range(3):
        for c in range(3):
            name = f"tile_{r}_{c}.png"
            Image.fromarray(slide[r * TILE:(r + 1) * TILE,
                                  c * TILE:(c + 1) * TILE]).save(
                tiles_dir / name, compress_level=1)
            rows.append(f"{name}\t{r}\t{c}\t{0 if (r, c) == (2, 2) else 1}")
    (wsi / "tile_selection.tsv").write_text("\n".join(rows) + "\n")
    log(f"[wsi] inputs in {time.perf_counter() - t0:.1f} s: {WSI_SIDE}² JPEG "
        f"TIFF ({jpeg.stat().st_size / 1e6:.1f} MB, PIL), tiled deflate "
        f"pyramid {levels} ({tiled.stat().st_size / 1e6:.1f} MB, the port's "
        "writer), 9 PyHIST tile PNGs (8 kept)")

    cfg_path, cfg, _ = _train_config(tmp, "fpn", epochs=3)
    # the config's own batch (the training phases cut it)
    cfg.update({"batch_size": CONFIG_BATCH, "tile_path": str(tiles_dir),
                "tsv_path": str(wsi / "tile_selection.tsv")})
    cfg_path = wsi / "overlay.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    batch = max(cfg["batch_size"], 8)
    pth = tmp / "train_fpn_out" / "pth" / "best.pth"
    art = wsi / "fpn.pdacpt"
    with contextlib.redirect_stdout(io.StringIO()):
        cli_export.main(["--config", str(cfg_path), "--pth_path", str(pth),
                         "--out", str(art), "--tile", str(TILE)])
    base = ["--config", str(cfg_path), "--device", "cuda"]
    n_plain = _windows(WSI_SIDE, TILE) ** 2
    n_over = _windows(WSI_SIDE, WSI_STRIDE)
    # the banded runner pads every chunk of a band to the batch
    band_rows = [sum(1 for y in range(0, WSI_SIDE - TILE + 1, WSI_STRIDE)
                     if b * 4096 <= y < (b + 1) * 4096)
                 for b in range(-(-WSI_SIDE // 4096))]
    banded_batches = sum(-(-r * n_over // batch) for r in band_rows)
    plain_batches = {n: k for n, k in ((batch, n_plain // batch),
                                       (n_plain % batch, 1)) if n and k}
    runs = [
        ("jpeg", ["--pth_path", str(pth), "--slide", str(jpeg), "--geojson",
                  "--export_tiff", "--min_region", "64", "--fill_holes",
                  "64"], plain_batches),
        ("tiled", ["--pth_path", str(pth), "--slide", str(tiled), "--banded",
                   "--stride", str(WSI_STRIDE), "--blend", "hann", "--tta",
                   "--uncertainty", "--export_tiff"],
         {batch: 8 * banded_batches}),
        ("artifact", ["--artifact", str(art), "--slide", str(jpeg)],
         plain_batches),
        ("pyhist", ["--pth_path", str(pth)], {8: 1}),
    ]
    total: dict = {}
    outs = {}
    for name, argv, forwards in runs:
        out = wsi / f"out_{name}"
        # -- the main path: launches counted from here ...
        _gn_forward_counts(reset=True)
        result, printed, frac = _run_cli_overlay(
            base + argv + ["--save_path", str(out)])
        counts = _gn_forward_counts()
        # -- ... to here
        _check_forwards(f"cli.overlay {name}", counts, forwards)
        _add_counts(total, counts[2])
        outs[name] = out
        banded = name == "tiled"
        side = 3 * TILE if name == "pyhist" else WSI_SIDE
        prob = _check_prob_map(name, out / "probability_map.npy",
                               (side, side),
                               np.float16 if banded else np.float32)
        png = np.asarray(Image.open(out / "overlay.png"))
        if png.ndim != 3 or max(png.shape[:2]) > 2048:
            raise AssertionError(f"{name}: overlay.png {png.shape}")
        extra = ""
        if name == "jpeg":
            gj = json.loads((out / "annotations.geojson").read_text())
            mask = rasterize_shapes(parse_geojson(gj), side, side)
            saved = float(mask.mean())
            fracs = {f["properties"]["measurements"]["tumor_fraction"]
                     for f in gj["features"]}
            if fracs - {saved}:
                raise AssertionError(f"{name}: GeoJSON tumor_fraction "
                                     f"{fracs} vs its own mask {saved}")
            tiff_levels = _check_tiff_readback(
                name, out / "probability_map.tiff", prob)
            extra = (f"; {len(gj['features'])} GeoJSON polygons, rasterized "
                     f"back: mean {saved:.6f}; probability_map.tiff "
                     f"{tiff_levels} levels read back equal")
        else:
            saved = float((prob >= 0.5).mean())
        # the banded runner thresholds the float32 map and saves it in
        # float16: a pixel just under 0.5 may round to 0.5 exactly
        low = float((prob > 0.5).mean()) if banded else saved
        if not low - 1e-12 <= result["tumor_fraction"] <= saved + 1e-12 \
                or abs(frac - result["tumor_fraction"]) > 5e-5:
            raise AssertionError(f"{name}: tumor fraction {frac} printed, "
                                 f"{result['tumor_fraction']} returned, "
                                 f"[{low}, {saved}] in the saved map")
        if banded:
            unc = _check_prob_map(name, out / "uncertainty_map.npy",
                                  (side, side), np.float16)
            if float(unc.astype(np.float32).max()) > 0.25:
                raise AssertionError(f"{name}: uncertainty above 0.25")
            _check_tiff_readback(name, out / "probability_map.tiff", prob)
            if not (out / "uncertainty_map.tiff").is_file():
                raise AssertionError(f"{name}: no uncertainty_map.tiff")
            extra = (f"; uncertainty mean "
                     f"{float(unc.astype(np.float32).mean()):.5f}, max "
                     f"{float(unc.astype(np.float32).max()):.5f}; both TIFFs "
                     "written, the probabilities read back equal")
        if name == "artifact":
            d = float(np.abs(prob - np.load(
                outs["jpeg"] / "probability_map.npy")).max())
            if d > 1e-6:
                raise AssertionError(f"artifact vs pth: max |Δp| {d}")
            extra = f"; vs --pth_path max |Δp| {d:.3g}"
        if name == "pyhist" and prob[2 * TILE:, 2 * TILE:].max() != 0:
            raise AssertionError("pyhist: the tile not kept was predicted")
        log(f"[wsi] {name}: {result['n_tiles']} windows in "
            f"{result['seconds']:.1f} s, tumor fraction {saved:.6f} (printed "
            f"{frac}), overlay.png {png.shape[1]}x{png.shape[0]}; GN "
            f"launches {counts[0]} = 7 x {sum(forwards.values())} forwards "
            f"{forwards}, all cluster{extra}")
    return total


def phase_wsi_timed(tmp: Path, card: str) -> dict:
    """The JAX rounds' whole-slide program: a 40,960² ``SyntheticSlideSource``
    at stride 256 (25,281 windows), hann, through ``BandedSlidingWindow``
    with band input, FPN/resnet18 bf16 from phase 5's ``best.pth``, batch
    128.  One run, profiled for the device's busy share."""
    import yaml
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
        SyntheticSlideSource,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        load_serving_state,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
        BandedSlidingWindow,
    )

    set_tf32(False)
    _, cfg_d, _ = _train_config(tmp, "fpn", epochs=3)
    cfg = Config.from_dict(dict(cfg_d, batch_size=CONFIG_BATCH))
    batch = max(cfg.batch_size, 8)
    model, _ = load_serving_state(
        cfg, str(tmp / "train_fpn_out" / "pth" / "best.pth"), "cuda")
    source = SyntheticSlideSource(WSI_TIMED_SIDE, tile=TILE,
                                  stride=WSI_STRIDE, seed=41)
    runner = BandedSlidingWindow(model, tile=TILE, batch_size=batch,
                                 blend="hann", num_workers=cfg.num_worker)
    per_band = {}
    for y, _ in source.coords:
        b = min(y // runner.band_h, -(-WSI_TIMED_SIDE // runner.band_h) - 1)
        per_band[b] = per_band.get(b, 0) + 1
    batches = sum(-(-n // batch) for n in per_band.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: launches counted from here ...
    _gn_forward_counts(reset=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prob, mask = runner.run(source)
        wall = time.perf_counter() - t0
    counts = _gn_forward_counts()
    # -- ... to here
    peak = torch.cuda.max_memory_allocated()
    _check_forwards("banded 40,960²", counts, {batch: batches})
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    copies = sum(ev.self_device_time_total for ev in events
                 if ev.key.startswith(("Memcpy", "Memset"))) / 1e6
    kernels = sum(ev.self_device_time_total for ev in events) / 1e6 - copies
    n = len(source)
    if prob.shape != (WSI_TIMED_SIDE,) * 2 or prob.dtype != np.float16 \
            or mask.shape != prob.shape:
        raise AssertionError(f"40k maps {prob.shape} {prob.dtype}")
    sample = prob[::97, ::89].astype(np.float32)
    if not np.isfinite(sample).all() or sample.min() < 0 or sample.max() > 1:
        raise AssertionError("40k probabilities out of [0, 1]")
    stats = runner.last_run
    out = {"windows": n, "wall_s": wall, "windows_per_s": n / wall,
           "kernel_s": kernels, "copy_s": copies,
           "busy_share": kernels / wall, "peak_bytes": peak,
           "upload_gb": stats["band_upload_bytes"] / 1e9,
           "upload_s": stats["band_upload_s"], "read_s": stats["band_read_s"],
           "bands": stats["bands"], "gn_launches": counts[0],
           "batches": batches, "tumor_fraction": float(mask[::7, ::7].mean())}
    log(f"[wsi-40k] {WSI_TIMED_SIDE}² synthetic slide, stride {WSI_STRIDE}, "
        f"hann, band input, FPN/resnet18 bf16, batch {batch}: {n} windows in "
        f"{wall:.2f} s wall = {n / wall:.1f} windows/s; device kernels "
        f"{kernels:.2f} s, busy share {kernels / wall:.3f}; copies "
        f"{copies:.2f} s; peak device memory {peak / 2 ** 30:.2f} GiB; "
        f"{stats['bands']} bands, upload {out['upload_gb']:.3f} GB in "
        f"{stats['band_upload_s']:.3f} s of copies (host reads "
        f"{stats['band_read_s']:.1f} s); GN launches {counts[0]} = 7 x "
        f"{batches} batches, all cluster; on {card}")
    del prob, mask
    return {"summary": out, "by_variant": counts[2]}


def phase_wsi_card_vs_cpu(tmp: Path) -> None:
    """f32, TF32 off, phase 5's FPN ``best.pth`` on a 1024² ``GridTiler``
    slide at stride 256, hann: the card's plain runner against the CPU's,
    with and without TTA (probabilities within 5e-4, masks ≥ 99.9% equal),
    and the card's banded runner (two bands) against its plain one within
    float16 rounding."""
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        load_serving_state,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
        BandedSlidingWindow,
        GridTiler,
        SlidingWindowInference,
    )

    set_tf32(False)
    _, cfg_d, _ = _train_config(tmp, "fpn", epochs=3)
    cfg = Config.from_dict(dict(cfg_d, compute_dtype="float32"))
    pth = str(tmp / "train_fpn_out" / "pth" / "best.pth")
    tiler = GridTiler(_wsi_slide(WSI_CPU_SIDE, seed=42), tile=TILE,
                      stride=WSI_STRIDE)
    models = {d: load_serving_state(cfg, pth, d)[0] for d in ("cuda", "cpu")}
    for tta in (False, True):
        kw = dict(tile=TILE, batch_size=CONFIG_BATCH, tta=tta, blend="hann",
                  num_workers=cfg.num_worker)
        t0 = time.perf_counter()
        card_p, card_m = SlidingWindowInference(models["cuda"], **kw).run(
            tiler)
        t1 = time.perf_counter()
        cpu_p, cpu_m = SlidingWindowInference(models["cpu"], **kw).run(tiler)
        t2 = time.perf_counter()
        err = float(np.abs(card_p - cpu_p).max())
        agree = float((card_m == cpu_m).mean())
        if err > 5e-4 or agree < 0.999:
            raise AssertionError(f"wsi card vs CPU (tta={tta}): max |Δp| "
                                 f"{err}, masks equal {agree}")
        band_p, band_m = BandedSlidingWindow(models["cuda"], band_h=TILE,
                                             **kw).run(tiler)
        d = np.abs(band_p.astype(np.float32) - card_p)
        bound = np.abs(card_p) * 2.0 ** -11 + 1e-6
        if (d > bound).any() or (band_m != card_m).mean() > 1e-4:
            raise AssertionError(f"wsi banded vs plain (tta={tta}): max "
                                 f"|Δp| {float(d.max())}")
        log(f"[wsi-card-vs-cpu] {WSI_CPU_SIDE}², stride {WSI_STRIDE}, hann, "
            f"tta={tta}, f32, TF32 off, {len(tiler)} windows: max |Δp| "
            f"{err:.3g} (bound 5e-4), masks equal {agree:.6f} (gate 0.999); "
            f"banded (2 bands, float16 out) vs plain on the card max |Δp| "
            f"{float(d.max()):.3g} (bound float16 rounding + 1e-6); card "
            f"{t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")


# -- phase 6: the timed train step ------------------------------------------

def _train_setup(cfg, sd: dict, device: str, dtype=None,
                 no_dropout: bool = False):
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

    from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
        Dropout,
    )

    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    if no_dropout:
        # DeepLabV3+'s elementwise mask is drawn on the activation's
        # device: the card's stream differs from the CPU's by design
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    if dtype is not None:
        model = model.to(dtype)
        model.compute_dtype = dtype
    model = model.to(device)
    opt = make_optimizer(model, cfg.lr)
    extras = cfg.extras
    return model, make_train_step(
        model, opt, cfg.img_size, make_objective(cfg),
        fused_augment=bool(extras.get("fused_augment", True)),
        remat=bool(extras.get("remat", False)),
        grad_accum_steps=int(extras.get("grad_accum_steps", 1)),
        parity_mode=cfg.parity_mode, stain=cfg.stain)


def phase_timed_step(card: str, model: str = "fpn",
                     backbone: str = "resnet18", extra: dict | None = None,
                     tag: str | None = None, iters: int = 8,
                     warmup: int = 3) -> dict:
    """One train step at the config's batch (``extra`` keys over the
    config), timed over ``iters`` steps after ``warmup``; the augmentation
    kernel must run once a step where the step fuses, never elsewhere."""
    import yaml

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        can_fuse_augment,
        step_generator,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    set_tf32(False)
    raw = yaml.safe_load((ROOT / "configs" / "train_config.yaml").read_text())
    raw.pop("train_path"), raw.pop("val_path"), raw.pop("test_path")
    raw.update(model=model, backbone=backbone, **(extra or {}))
    tag = tag or _tag(model, backbone)
    cfg = Config.from_dict(raw)
    n = cfg.batch_size
    sd = seeded_state_dict(build_model(cfg), seed=7)
    net, step = _train_setup(cfg, sd, "cuda")
    fused = cfg.extras.get("fused_augment", True) and can_fuse_augment(
        (n, cfg.img_size, cfg.img_size, 3), cfg.img_size, cfg.parity_mode,
        cfg.stain, net.compute_dtype)
    all_images = torch.from_numpy(_tiles(n, seed=8)).cuda()
    all_masks = torch.from_numpy(_masks(n, seed=8, classes=cfg.num_classes)
                                 ).cuda()
    gens = [step_generator(cfg.seed, 0, i) for i in range(warmup + iters + 1)]
    while True:
        # the config's batch, or the largest power-of-two cut of it that
        # fits in the card's memory (said in the log)
        images, masks = all_images[:n], all_masks[:n]
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        try:
            for i in range(warmup):
                step(images, masks, valid, gens[i])
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if n == 1:
                raise
        log(f"[step] {tag}: batch {n} does not fit in the card's memory; "
            f"cut to {n // 2}")
        n //= 2
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    augment_before = _train_counters()["augment"][0]
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        loss, score = step(images, masks, valid, gens[warmup + i])
    end.record()
    torch.cuda.synchronize()
    augment_launches = _train_counters()["augment"][0] - augment_before
    if augment_launches != (iters if fused else 0):
        raise AssertionError(f"timed {tag} step: {augment_launches} "
                             f"augmentation launches in {iters} steps "
                             f"(fused: {fused})")
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    ms = start.elapsed_time(end) / iters
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(float(loss)) and np.isfinite(float(score))):
        raise AssertionError(f"timed step: loss {loss}, score {score}")
    by_name = _profile_by_kernel(
        lambda: step(images, masks, valid, gens[-1]))
    total = sum(by_name.values())
    groups = {
        "gn_forward": GN_FORWARD_KERNELS,
        "gn_backward": GN_BACKWARD_KERNELS,
        "augment": AUG_KERNELS,
    }
    shares = {g: sum(v for k, v in by_name.items()
                     if any(p in k for p in pats))
              for g, pats in groups.items()}
    log(f"[step] {tag} train step at batch {n}, {cfg.img_size}², "
        f"{cfg.compute_dtype}, {'fused' if fused else 'non-fused'} "
        f"augmentation, input on the card: {ms:.2f} ms/step by CUDA "
        f"events ({host_ms:.2f} by the host clock), {n * 1e3 / ms:.1f} "
        f"patches/s, peak memory {peak / 2 ** 30:.2f} GiB, augmentation "
        f"kernel launched {augment_launches} times in {iters} steps, on "
        f"{card}")
    log(f"[profile] one {tag} step: profiler device time {total:.2f} ms, idle "
        f"share {max(0.0, 1 - total / ms):.3f} of the timed step; "
        + ", ".join(f"{g} {v:.3f} ms ({100 * v / total if total else 0:.1f}%)"
                    for g, v in shares.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for k, v in top[:12]:
        log(f"[profile]   {v:8.3f} ms  {k[:110]}")
    return {"batch": n, "fused": bool(fused), "ms_per_step": ms,
            "patches_per_s": n * 1e3 / ms,
            "peak_bytes": peak, "profile_ms": total,
            "idle_share": max(0.0, 1 - total / ms), "shares_ms": shares,
            "top_kernels_ms": [[k[:80], v] for k, v in top[:5]]}


# -- phase 7: card vs CPU ---------------------------------------------------

def phase_train_card_vs_cpu(model: str = "fpn", backbone: str = "resnet18",
                            size: int = TILE, extra: dict | None = None,
                            tag: str | None = None) -> None:
    """One f32 train step (TF32 off) from the same weights, the same batch
    and the same host generator: on the CPU, on the card with cuDNN's
    convolutions, and on the card with PyTorch's own (cuDNN off).  The
    models after FPN/resnet18 and ResUNet are held in float64 instead, but
    FPN on a new encoder: its GN kernels take f32 and bf16, so it is held
    in f32 at FPN/resnet18's bounds, each f32 side's distance from the
    CPU's f64 step reported beside them."""
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
    cfg = Config.from_dict({"model": model, "backbone": backbone,
                            "img_size": size, "compute_dtype": "float32",
                            "lr": 1e-4, **(extra or {})})
    tag = tag or _tag(model, backbone)
    sd = seeded_state_dict(build_model(cfg), seed=9)
    n = 2
    images = torch.from_numpy(_tiles(n, seed=10, size=size))
    masks = torch.from_numpy(_masks(n, seed=10, size=size,
                                    classes=cfg.num_classes))
    valid = torch.ones(n, dtype=torch.bool)
    # the GN kernels take f32 and bf16, as the Pallas ones do, so an FPN
    # step has no float64 run on the card
    f64 = (model in NEW_MODELS or backbone != "resnet18") and model != "fpn"
    f32_runs = (("cpu", "cpu", True, None), ("cudnn", "cuda", True, None),
                ("no_cudnn", "cuda", False, None))
    runs = ((("cpu64", "cpu", True, torch.float64),
             ("cudnn64", "cuda", True, torch.float64)) + f32_runs[:2]
            if f64 else f32_runs if backbone == "resnet18"
            else (("cpu64", "cpu", True, torch.float64),) + f32_runs)
    res = {}
    for run, dev, cudnn, dtype in runs:
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            net, step = _train_setup(cfg, sd, dev, dtype,
                                     no_dropout=model == "deeplabv3+")
            loss, _ = step(images.to(dev), masks.to(dev), valid.to(dev),
                           step_generator(1, 0, 0))
            # PSPNet's layer3/layer4 are built but not run: no gradient
            res[run] = (float(loss), {k: p.grad.cpu().double() for k, p in
                                      net.named_parameters()
                                      if p.grad is not None})
    card_run = next(run for run, dev, _, _ in runs if dev == "cuda")
    if set(res["cpu"][1]) != set(res[card_run][1]):
        raise AssertionError(f"{tag}: the card and the CPU gave gradients "
                             "to different parameters")
    unrun = sorted(k for k, _ in net.named_parameters()
                   if k not in res["cpu"][1])
    if unrun and not (model == "pspnet" and all(
            k.startswith(("encoder.layer3.", "encoder.layer4."))
            for k in unrun)):
        raise AssertionError(f"{tag}: no gradient for {unrun[:4]}")

    def compare(run: str, rel: float, base: str = "cpu",
                loss_tol: float = 1e-4, floor: float = 1e-4) -> str:
        norms = {k: float(g.norm()) for k, g in res[base][1].items()}
        top = max(norms.values())
        d_loss = abs(res[run][0] - res[base][0])
        errs = {k: float((res[run][1][k] - g).norm())
                for k, g in res[base][1].items()}
        bad = [k for k in norms if errs[k] > rel * norms[k] + floor * top]
        worst = sorted(norms, key=lambda k: -errs[k] / max(norms[k], 1e-30))
        detail = ", ".join(f"{k} {errs[k]:.3g}/{norms[k]:.3g}"
                           for k in worst[:3])
        if rel and (d_loss > loss_tol or bad
                    or not np.isfinite(res[run][0])):
            raise AssertionError(
                f"train step {run} vs {base}: |Δloss| {d_loss}, tensors "
                f"beyond the bound {bad}; worst |Δg|/|g| (L2): {detail}; "
                f"largest |g| {top:.3g}")
        bound = (f"bound {rel:g} of the norm + {floor:g} of the largest, "
                 f"{top:.3g}" if rel else "reported, not gated")
        return f"|Δloss| {d_loss:.3g}; worst |Δg|/|g| (L2): {detail} ({bound})"

    if f64:
        # f32 gradients of these models carry rounding of the order of the
        # f32 gate itself (on a CPU, f32 against f64 at this batch: U-Net++
        # 5.9e-3 of a tensor's norm, DeepLabV3+ 3.0e-3), so the card is
        # held to the CPU in float64; the f32 numbers are reported.  The
        # heads still resize, and the objective still scores, in f32 on
        # both sides: that rounding, through the same cancelling BN
        # backward sums, left PSPNet's pyramid branches 2.8e-5 of their
        # norm apart in a first run, hence 1e-4 (and 1e-6 of the largest
        # for gradients that are zero but for rounding, such as the 1×1
        # bin's bias ahead of a BN)
        log(f"[card-vs-cpu] {tag}: one f64 train step, {n}x{size}², "
            f"card with cuDNN: "
            f"{compare('cudnn64', 1e-4, 'cpu64', 1e-6, floor=1e-6)}")
        log(f"[card-vs-cpu] {tag}: the same in f32, TF32 off: card vs CPU "
            f"{compare('cudnn', 0.0)}; CPU f32 vs CPU f64 "
            f"{compare('cpu', 0.0, 'cpu64')}")
        return

    # With PyTorch's own convolutions the card sums in another order than
    # the CPU and nothing else, but the f32 backward through the encoder's
    # BatchNorms is ill-conditioned (each removes the mean and the xhat
    # component of its incoming gradient, which leaves the rounding): the
    # CPU test against the JAX package at 64² sees 1.2e-3 of scale between
    # two f32 libraries (tests/test_torch_train.py), so 5e-3 of the norm.
    # cuDNN's heuristics may pick transform-based (Winograd, FFT)
    # algorithms for the f32 data and weight gradients, whose rounding is
    # coarser: 5e-2 of the norm.  The loss within 1e-4 in both.
    if "cpu64" in res:
        log(f"[card-vs-cpu] {tag}: CPU f32 vs CPU f64, {n}x{size}²: "
            f"{compare('cpu', 0.0, 'cpu64')}; card f32 without cuDNN vs CPU "
            f"f64: {compare('no_cudnn', 0.0, 'cpu64')}")
    log(f"[card-vs-cpu] {tag}: one f32 train step, TF32 off, {n}x{size}², "
        f"card without cuDNN: {compare('no_cudnn', 5e-3)}")
    log(f"[card-vs-cpu] {tag}: the same, card with cuDNN: "
        f"{compare('cudnn', 5e-2)}")


# -- phases 7 and 8 ---------------------------------------------------------

def _model(sd: dict, dtype: str, device: str, model: str = "fpn",
           head: str = "float32", backbone: str = "resnet18"):
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_infer_step,
    )

    net = build_model(Config.from_dict({
        "model": model, "backbone": backbone, "img_size": TILE,
        "compute_dtype": dtype, "head_dtype": head}))
    net.load_state_dict(sd, strict=True)
    return make_infer_step(net.to(device), TILE)


def phase_card_vs_cpu(sd: dict, model: str = "fpn",
                      backbone: str = "resnet18") -> None:
    """The f32 serving step (TF32 off) on the card and on the CPU:
    probabilities within 5e-4, masks at 0.5 at least 99.9% equal."""
    set_tf32(False)
    tag = _tag(model, backbone)
    imgs = torch.from_numpy(_tiles(2, seed=4))
    card = _model(sd, "float32", "cuda", model,
                  backbone=backbone)(imgs.cuda()).cpu()
    cpu = _model(sd, "float32", "cpu", model, backbone=backbone)(imgs)
    err = float((card - cpu).abs().max())
    agree = float(((card >= 0.5) == (cpu >= 0.5)).float().mean())
    if card.shape != (2, TILE, TILE) or not torch.isfinite(card).all() \
            or err > 5e-4 or agree < 0.999:
        raise AssertionError(f"{tag} card vs CPU: shape "
                             f"{tuple(card.shape)}, max abs err {err} "
                             f"(bound 5e-4), masks equal {agree}")
    log(f"[card-vs-cpu] {tag} forward, f32, TF32 off, 2x{TILE}²: max |Δp| "
        f"{err:.3g} (bound 5e-4), masks equal {agree:.6f} (bound 0.999)")


def phase_bf16_vs_f32(sd: dict, model: str = "fpn",
                      head: str = "float32", backbone: str = "resnet18") -> None:
    set_tf32(False)
    tag = _tag(model, backbone)
    imgs = torch.from_numpy(_tiles(8, seed=5)).cuda()
    p16 = _model(sd, "bfloat16", "cuda", model, head, backbone)(imgs)
    p32 = _model(sd, "float32", "cuda", model, backbone=backbone)(imgs)
    agree = float(((p16 >= 0.5) == (p32 >= 0.5)).float().mean())
    if agree <= 0.98:
        raise AssertionError(f"{tag} bf16 vs f32 mask agreement {agree} "
                             "<= 0.98")
    log(f"[bf16-vs-f32] {tag} (bf16 head: {head == 'bfloat16'}): mask "
        f"agreement at 0.5: {agree:.6f} (gate > 0.98), max |Δp| "
        f"{float((p16 - p32).abs().max()):.4f}")


# -- phase 6b: DeepLabV3+'s ASPP dropout on the card ---------------------------

ASPP_SHAPE = (CONFIG_BATCH, 256, 32, 32)  # the ASPP output at 512², batch 128


def phase_aspp_dropout() -> dict:
    """``models/dropout.py::Dropout(0.5)`` at the timed step's ASPP shape,
    bf16, on the card: every element zero or doubled exactly, the kept
    share within 5σ of 0.5, the same step generator the same mask bitwise
    and another step another, and no tensor of more than one element made
    on the host (a dispatch mode records every tensor the call creates);
    ms by CUDA events."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
        Dropout,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        step_generator,
    )

    class HostTensors(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if torch.is_tensor(t) and t.device.type == "cpu":
                    self.largest = max(self.largest, t.numel())
            return out

    drop = Dropout(0.5).train()
    x = (torch.rand(ASPP_SHAPE, device="cuda") + 0.5).to(torch.bfloat16)
    with HostTensors() as host:
        y = drop(x, step_generator(41, 0, 0))
    torch.cuda.synchronize()
    kept = y != 0
    share = float(kept.float().mean())
    sigma = (0.25 / x.numel()) ** 0.5
    doubled = torch.equal(y[kept], x[kept] * 2)
    again = torch.equal(drop(x, step_generator(41, 0, 0)), y)
    other = not torch.equal(drop(x, step_generator(41, 0, 1)), y)
    if abs(share - 0.5) > 5 * sigma or not doubled or not again \
            or not other or host.largest > 1:
        raise AssertionError(
            f"ASPP dropout on the card: kept share {share} (5σ {5 * sigma}),"
            f" kept values doubled {doubled}, same seed same mask {again}, "
            f"another step another mask {other}, largest host tensor "
            f"{host.largest} elements")
    gen = step_generator(41, 0, 0)
    ms = cuda_ms(lambda: drop(x, gen), warmup=2, iters=10)
    log(f"[dropout] ASPP Dropout(0.5) at {ASPP_SHAPE} bf16 on the card: kept "
        f"share {share:.6f} (|Δ| {abs(share - 0.5):.2e}, 5σ "
        f"{5 * sigma:.2e}), kept values exactly doubled, the same step's "
        f"mask bitwise equal, another step's not, largest host tensor "
        f"{host.largest} element (the seed); {ms:.3f} ms a call")
    return {"kept_share": share, "ms": ms, "host_elements": host.largest}


# -- phases 9b, 9c: a whole slide through DeepLabV3+ and FPN/efficientnet-b7 --

OVERLAY_SLIDE = 2048


def phase_model_overlay(tmp: Path, model: str,
                        backbone: str = "resnet18") -> dict:
    """``cli.overlay --banded --device cuda`` with ``model``'s ``best.pth``
    of phase 5 on a 2048² JPEG TIFF, stride 256, hann, the config's batch
    (bf16): the map read back, the tumor fraction against it, and 7 GN
    launches per tile batch for FPN, none for the others.  A main path:
    the counters are set to 0 just before it and read just after."""
    import yaml
    from PIL import Image

    set_tf32(False)
    tag = _tag(model, backbone)
    slide = _wsi_slide(OVERLAY_SLIDE, seed=43)
    path = tmp / "wsi" / f"slide_{tag}.tiff"
    path.parent.mkdir(exist_ok=True)
    Image.fromarray(slide).save(path, compression="jpeg", quality=90)
    _, cfg, _ = _train_config(tmp, model, 3, backbone)
    cfg_path = tmp / "wsi" / f"overlay_{tag}.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(cfg, batch_size=CONFIG_BATCH)))
    out = tmp / "wsi" / f"out_{tag}"
    # -- the main path: launches counted from here ...
    _gn_forward_counts(reset=True)
    result, _, frac = _run_cli_overlay([
        "--config", str(cfg_path), "--device", "cuda", "--pth_path",
        str(tmp / f"train_{tag}_out" / "pth" / "best.pth"), "--slide",
        str(path), "--banded", "--stride", str(WSI_STRIDE), "--blend",
        "hann", "--save_path", str(out)])
    counts = _gn_forward_counts()
    # -- ... to here
    prob = _check_prob_map(tag, out / "probability_map.npy",
                           (OVERLAY_SLIDE, OVERLAY_SLIDE), np.float16)
    windows = _windows(OVERLAY_SLIDE, WSI_STRIDE) ** 2
    # one band: its windows in batches of the config's size, the last padded
    batches = -(-windows // CONFIG_BATCH)
    _check_forwards(f"{tag} overlay", counts,
                    {CONFIG_BATCH: batches} if model == "fpn" else {})
    high, low = float((prob >= 0.5).mean()), float((prob > 0.5).mean())
    if result["n_tiles"] != windows \
            or not low - 1e-12 <= result["tumor_fraction"] <= high + 1e-12 \
            or abs(frac - result["tumor_fraction"]) > 5e-5:
        raise AssertionError(f"{tag} overlay: {result}, map fraction "
                             f"[{low}, {high}]")
    log(f"[wsi] {model}/{backbone} banded: {OVERLAY_SLIDE}² JPEG TIFF, "
        f"stride {WSI_STRIDE}, hann, {result['n_tiles']} windows in "
        f"{result['seconds']:.1f} s, tumor fraction "
        f"{result['tumor_fraction']:.6f} (printed {frac}; the float16 map "
        f"gives [{low:.6f}, {high:.6f}]); GN launches {counts[0]}"
        + (f" = 7 x {batches} batch, all cluster" if model == "fpn" else ""))
    return {"windows": result["n_tiles"], "seconds": result["seconds"],
            "by_variant": counts[2]}


# -- phase 10: int8 serving, stain normalization, the device slide -----------

INT8_SOURCE = "pdac_pathological_image_segmentation_tpu_torch/csrc/int8_conv.cu"
# no TPU kernel: the JAX package's int8 convolution, left to XLA
INT8_REPLACES = "pdac_pathological_image_segmentation_tpu/infer/quantized.py:149"
INT8_BATCH = 32  # the served bucket: the int8 kernel rows' batch
INT8_OPS_PER_MAC = 2
INT8_PEAK_OPS = 1.979e15  # H100 SXM dense int8, NVIDIA data sheet
INT8_MODELS = ("fpn", "deeplabv3+", "unet", "pspnet")
# the int8 kernel's times in its mma.sync design, by the launch key it had
# (ms; chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W)
INT8_MMA_SYNC_MS = ROOT / "scripts" / "int8_conv_mma_sync_ms.json"
QUANTIZE_SOURCE = "pdac_pathological_image_segmentation_tpu_torch/csrc/quantize.cu"
# no TPU kernel: the JAX package's activation quantize, left to XLA
QUANTIZE_REPLACES = "pdac_pathological_image_segmentation_tpu/infer/quantized.py:66"


def _site_shape(key: tuple) -> tuple:
    """The convolution a launch key computes, ``(n, h, w, c, f, kh, kw,
    stride, pad, dilation)``: the key's own shape, except that the
    space-to-depth stem (the only key with an asymmetric pad) is the
    3-channel 7×7/2 convolution of the 512² tiles it came from (the main
    paths' tiles are even-sized: ``2·h`` rows)."""
    n, h, w, c, f, kh, kw, stride, pad, dil = key[:10]
    if not isinstance(pad, int):
        return n, 2 * h, 2 * w, 3, f, 7, 7, 2, 3, dil
    return n, h, w, c, f, kh, kw, stride, pad, dil


def _mma_sync_ms(key: tuple):
    """The mma.sync design's ms at the site of ``key`` (None where it had
    no row), from PR 10's final run: its key had a 16-byte-load flag where
    this one has the piece width, and the stem the 3-channel 7×7/2 form
    (:func:`_site_shape`).  Logged beside the new time; not a reading of
    this run."""
    if not hasattr(_mma_sync_ms, "rows"):
        rows = json.loads(INT8_MMA_SYNC_MS.read_text())["rows"]
        _mma_sync_ms.rows = {tuple(k): ms for k, ms in rows}
    site = _site_shape(key)
    old = (*site, *key[10:-1], key[-1] == 16 and site[3] % 16 == 0)
    return _mma_sync_ms.rows.get(old)


def _int8_counts(reset: bool = False) -> tuple:
    """The int8 kernel's counters ``(launches, by shape)``; with ``reset``
    they are set to 0 first, and the quantize kernel's with them."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
        int8_conv,
        quantize_activation,
    )

    if reset:
        for fn in (int8_conv, quantize_activation):
            fn.launches = 0
            fn.launches_by_shape.clear()
    return int8_conv.launches, dict(int8_conv.launches_by_shape)


def _quantize_counts() -> dict:
    """The quantize kernel's launches by key (``ops.int8_conv.
    quantize_key``) since the last ``_int8_counts(reset=True)``."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
        quantize_activation,
    )

    return dict(quantize_activation.launches_by_shape)


def _calib_batches(tmp: Path) -> list:
    """The int8 calibration batches: the 16 synthetic test patches."""
    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        calib_batches_from_dir,
    )

    return calib_batches_from_dir(str(tmp / "data" / "test"), TILE)


def _quantized_step(tmp: Path, model: str, act_storage: str = "int8"):
    """``model``'s phase-5 ``best.pth`` on the card, calibrated on the test
    patches: ``(cfg, bf16 model, int8 step)``."""
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized as q,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        load_serving_state,
    )

    _, cfg_d, _ = _train_config(tmp, model, epochs=3)
    cfg = Config.from_dict(cfg_d)
    net, _ = load_serving_state(
        cfg, str(tmp / f"train_{_tag(model)}_out" / "pth" / "best.pth"),
        "cuda")
    sd = net.state_dict()
    bundle, forward = q.quantize_from_config(cfg, sd, _calib_batches(tmp))
    step = q.make_quantized_infer_step(sd, bundle, TILE, forward,
                                       act_storage=act_storage)
    return cfg, net, step


def _seeded_int8_step(model: str):
    """``model`` on resnet18 with seeded weights on the card, calibrated on
    8 seeded tiles: its int8 step."""
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized as q,
    )

    cfg = Config(model=model, img_size=TILE)
    sd = {k: v.cuda() for k, v in _seeded(model, "resnet18", seed=60).items()}
    bundle, forward = q.quantize_from_config(cfg, sd, [_tiles(8, seed=61)])
    return q.make_quantized_infer_step(sd, bundle, TILE, forward)


def _record_int8_sites(step, x) -> dict:
    """One forward of ``step`` with every int8 kernel call recorded: its
    operands and epilogue, one per launch key (``ops.int8_conv.launch_key``:
    shapes, epilogue, load path), in call order."""
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized as q,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
        launch_key,
    )

    original = q.int8_conv
    calls = {}

    def recorder(xq, sx, kq, sw, stride=1, pad=0, dilation=1, **kw):
        calls.setdefault(launch_key(xq, kq, stride, pad, dilation, **kw),
                         (xq, sx, kq, sw, stride, pad, dilation, kw))
        return original(xq, sx, kq, sw, stride, pad, dilation, **kw)

    q.int8_conv = recorder
    try:
        step(x)
        torch.cuda.synchronize()
    finally:
        q.int8_conv = original
    return calls


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def _axis_reads(size: int, k: int, stride: int, pad, dil: int,
                out: int) -> tuple:
    """Along one axis of a convolution: ``(input positions that some output
    reads, (output, tap) pairs that land inside the input)``.  A 1×1
    stride-2 site reads every other position; a padded tap reads none.
    ``pad`` an int or ``(low, high)``."""
    lo = pad if isinstance(pad, int) else pad[0]
    inside = [o * stride - lo + i * dil for o in range(out)
              for i in range(k)]
    inside = [t for t in inside if 0 <= t < size]
    return len(set(inside)), len(inside)


def _int8_row(model: str, key: tuple, operands: tuple,
              quick: bool = False) -> dict:
    """The int8 kernel against its plain version at one recorded site,
    bitwise (int32 sums and the epilogue's output), and its row: ``ms`` by
    CUDA events, ``device_ms`` by the profiler (not with ``quick``), the
    plain version's ms, the bound and two yardsticks the port never calls:
    ``torch._int_mm`` on the same int8 bytes for the 1×1 sites
    (``library_ms``), cuDNN's bf16 ``F.conv2d`` of the same shape for every
    site (``cudnn_bf16_ms``).  The bound is the function's: the input
    pixels some output reads and the taps that land inside the input, of
    the convolution the key computes (:func:`_site_shape`: for the
    space-to-depth stem the 3-channel 7×7/2 convolution, neither its zero
    channel nor its zero taps).  ``quick`` times fewer calls: the rows at
    the main paths' other batches."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
        int8_conv,
        int8_conv_reference,
        output_size,
    )

    xq, sx, kq, sw, stride, pad, dil, kw = operands
    n, h, w, c = xq.shape
    f, kh, kwd, _ = kq.shape
    oh, ow = (output_size(h, kh, stride, pad, dil),
              output_size(w, kwd, stride, pad, dil))
    args = (xq, sx, kq, sw, stride, pad, dil)
    got = int8_conv(*args, **kw)
    want = int8_conv_reference(*args, **kw)
    sums = int8_conv(*args, out_dtype=torch.int32)
    sums_ref = int8_conv_reference(*args, out_dtype=torch.int32)
    torch.cuda.synchronize()
    if not (_bitwise(got, want) and _bitwise(sums, sums_ref)):
        raise AssertionError(
            f"int8_conv {key}: kernel differs from the plain version (output "
            f"max |Δ| {float((got.float() - want.float()).abs().max())}, "
            f"int32 sums equal {_bitwise(sums, sums_ref)})")
    del want, sums_ref
    timing = dict(warmup=2, iters=5, windows=3) if quick else {}
    ms = cuda_ms(lambda: int8_conv(*args, **kw), **timing)
    dev = None if quick else device_ms(
        lambda: int8_conv(*args, **kw), kernels=1,
        names=("int8_conv_kernel",))
    plain = cuda_ms(lambda: int8_conv_reference(*args, **kw),
                    **(dict(warmup=0, iters=1, windows=1) if quick
                       else dict(warmup=1, iters=2, windows=3)))
    _, sh, swd, sc, _, skh, skw, ss, sp, _ = _site_shape(key)
    rows_h, taps_h = _axis_reads(sh, skh, ss, sp, dil, oh)
    rows_w, taps_w = _axis_reads(swd, skw, ss, sp, dil, ow)
    lo, hi = (pad, pad) if isinstance(pad, int) else pad
    res = kw.get("residual")
    nbytes = (n * rows_h * rows_w * sc + f * skh * skw * sc + 4 * f * (
        1 + (kw.get("scale") is not None) + (kw.get("shift") is not None))
        + got.numel() * got.element_size()
        + (0 if res is None else res.numel() * res.element_size()))
    macs = n * taps_h * taps_w * sc * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = INT8_OPS_PER_MAC * macs / INT8_PEAK_OPS * 1e3
    xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
    if lo != hi:  # padded beforehand, outside the timed call
        xb, lo = torch.nn.functional.pad(xb, (lo, hi, lo, hi)), 0
    wb = kq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    cudnn = cuda_ms(lambda: torch.nn.functional.conv2d(
        xb, wb, stride=stride, padding=lo, dilation=dil), **timing)
    del xb
    library = None
    if kh == kwd == 1 and pad == 0 and c % 8 == 0 and f % 8 == 0:
        a = xq[:, ::stride, ::stride, :].reshape(-1, c).contiguous()
        b = kq.view(f, c).t()
        if not torch.equal(torch._int_mm(a, b).view(n, oh, ow, f), sums):
            raise AssertionError(f"_int_mm differs at {key}")
        library = cuda_ms(lambda: torch._int_mm(a, b), **timing)
    return {
        "name": "int8_conv", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES, "model": model,
        "shape": [n, h, w, c, f, kh, kwd, stride, pad, dil],
        "epilogue": dict(zip(("scale", "shift", "residual", "bias_last",
                              "relu", "out", "nchw", "piece"), key[10:])),
        "key": list(key), "max_abs_err": 0.0, "ms": ms, "device_ms": dev,
        "mma_sync_ms": _mma_sync_ms(key),
        "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library, "cudnn_bf16_ms": cudnn, "macs": macs,
        "bytes": nbytes}


def _log_int8_row(row: dict) -> None:
    log(f"[int8-kernel] {row['model']} {row['shape']} {row['epilogue']}: "
        f"bitwise (sums and output); {row['ms']:.4f} ms (mma.sync design "
        f"{_ms_text(row['mma_sync_ms'])}; device "
        f"{_ms_text(row['device_ms'])}), bound {row['bound_ms']:.4f} "
        f"({row['bound_by']}), plain {row['plain_ms']:.3f}, cuDNN bf16 "
        f"{row['cudnn_bf16_ms']:.4f}, _int_mm {_ms_text(row['library_ms'])}")


def phase_int8_kernels() -> list:
    """The int8 convolution kernel against its plain version on the card,
    bitwise, at every site of FPN/resnet18's int8 forward at 512² and batch
    32 (real operands, recorded from one forward of a seeded model: the
    shapes are the main paths'), then the sites the other three models add
    (DeepLabV3+'s dilated stage and ASPP, ResUNet's decoder halves,
    PSPNet's bottleneck).  It runs with phase 3, before the later phases'
    long profiles, after which the profiler records none of this kernel's
    launches; :func:`phase_int8_launched` adds the main paths' other
    batches."""
    set_tf32(False)
    warm_card()
    x = torch.from_numpy(_tiles(INT8_BATCH, seed=51)).cuda()
    rows = {}
    for model in INT8_MODELS:
        step = _seeded_int8_step(model)
        calls = _record_int8_sites(step, x)
        del step
        for key, operands in calls.items():
            if key not in rows:
                rows[key] = _int8_row(model, key, operands)
                _log_int8_row(rows[key])
        del calls
        torch.cuda.empty_cache()
    rows = list(rows.values())
    log(f"[int8-kernel] {len(rows)} site keys of {INT8_MODELS} at batch "
        f"{INT8_BATCH}, all bitwise; kernel {sum(r['ms'] for r in rows):.3f} "
        f"ms in all against a bound of "
        f"{sum(r['bound_ms'] for r in rows):.3f} ms")
    return rows


def _int8_path_model(path: str) -> str:
    """The model an int8 main path ran: ``{model}_int8`` or FPN."""
    return path[:-len("_int8")] if path[:-len("_int8")] in INT8_MODELS \
        else "fpn"


def phase_int8_launched(int8_paths: dict, rows: list) -> list:
    """Every key the int8 main paths launched the kernel at and
    :func:`phase_int8_kernels` did not check (the buckets 1 and 8, the
    slides' batch 128 and their last, partial batches, ResUNet's 512):
    the path's model with seeded weights is recorded at that batch and each
    such site checked bitwise and timed (``quick``).  Fails if a launched
    key is left without a row."""
    set_tf32(False)
    have = {tuple(r["key"]) for r in rows}
    need = {}
    for path, by_shape in int8_paths.items():
        for key in by_shape:
            if key not in have:
                need.setdefault(_int8_path_model(path), {}).setdefault(
                    key[0], set()).add(key)
    tiles = torch.from_numpy(_tiles(INT8_BATCH, seed=51)).cuda()
    new = []
    for model, by_batch in need.items():
        step = _seeded_int8_step(model)
        for n, keys in sorted(by_batch.items()):
            x = tiles.repeat(-(-n // INT8_BATCH), 1, 1, 1)[:n]
            calls = _record_int8_sites(step, x)
            for key in [k for k in calls if k in keys]:
                new.append(_int8_row(model, key, calls[key], quick=True))
                _log_int8_row(new[-1])
            del calls, x
            torch.cuda.empty_cache()
        del step
    missing = ({k for b in need.values() for ks in b.values() for k in ks}
               - {tuple(r["key"]) for r in new})
    if missing:
        raise AssertionError(f"int8_conv launched at {len(missing)} keys "
                             f"with no bitwise row: {sorted(missing)}")
    log(f"[int8-kernel] {len(new)} more site keys at the main paths' other "
        f"batches {sorted({n for b in need.values() for n in b})}, all "
        f"bitwise")
    return new


def _quantize_input(key: tuple, gen: torch.Generator) -> torch.Tensor:
    """A float input on the card in the layout of a quantize launch key
    (``ops.int8_conv.quantize_key``), with values on the rounding ties and
    past the clip: ``nhwc``, ``s2d`` and ``strided`` with Cout > C (a
    channel-padded input) contiguous NHWC, ``strided`` with C = Cout the
    NHWC view of NCHW memory."""
    n, h, w, c, cout, dtype, layout = key
    x = torch.randn((n, h, w, c), generator=gen, device="cuda") * 3
    x.view(-1)[:4] = torch.tensor([0.5, 1.5, -2.5, 900.0],
                                  device="cuda") * 0.25
    x = x.to(getattr(torch, dtype))
    if layout == "strided" and cout == c:
        return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return x


def phase_quantize_rows(paths: dict) -> list:
    """The quantize kernel against its plain version on the card, bitwise,
    at every key the int8 main paths launched it under (shape, output
    channels, dtype, layout), with ``ms`` by CUDA events, the plain version's
    ms and the byte bound (it reads each input element once and writes one
    byte for each; the zero channels and edges it adds are not counted; a
    divide and a convert an element are far below the float rate).  No
    single PyTorch call rounds half to even and clamps to
    ±127, so no library time.  Launches are the paths' own."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
        quantize_activation,
        quantize_activation_reference,
    )

    keys = sorted({k for by_shape in paths.values() for k in by_shape},
                  key=str)
    gen = torch.Generator(device="cuda").manual_seed(71)
    rows = []
    for key in keys:
        x = _quantize_input(key, gen)
        kw = dict(channels=key[4], space_to_depth=key[6] == "s2d")
        got = quantize_activation(x, 0.25, **kw)
        want = quantize_activation_reference(x, 0.25, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"quantize {key}: kernel differs from the "
                                 "plain version")
        ms = cuda_ms(lambda: quantize_activation(x, 0.25, **kw))
        plain = cuda_ms(lambda: quantize_activation_reference(x, 0.25, **kw),
                        warmup=1, iters=3, windows=3)
        nbytes = x.numel() * (x.element_size() + 1)
        by_path = {p: by_shape.get(key, 0) for p, by_shape in paths.items()}
        rows.append({
            "name": "quantize_activation", "route": "cuda",
            "source": QUANTIZE_SOURCE, "replaces": QUANTIZE_REPLACES,
            "shape": list(key[:4]), "key": list(key),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "bytes": nbytes})
        log(f"[quantize] {key}: bitwise; {ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} (bytes), plain {plain:.4f}; "
            f"launches {rows[-1]['launches']}")
        del x, got, want
    torch.cuda.empty_cache()
    for path, by_shape in paths.items():
        if not sum(by_shape.values()):
            raise AssertionError(f"quantize_activation was not launched on "
                                 f"the {path} path")
        log(f"[quantize] {path}: {sum(by_shape.values())} launches at "
            f"{len(by_shape)} keys; kernel "
            f"{sum(v * r['ms'] for r in rows for k, v in by_shape.items() if tuple(r['key']) == k):.3f}"
            f" ms in all against a bound of "
            f"{sum(v * r['bound_ms'] for r in rows for k, v in by_shape.items() if tuple(r['key']) == k):.3f} ms")
    return rows


def phase_int8_serving(tmp: Path, card: str) -> dict:
    """FPN/resnet18 int8, a main path: ``cli.export --int8 --calib_path``
    on phase 5's ``best.pth`` (the 16 test patches calibrate on the card)
    → the daemon at buckets 1/8/32 with the float path's requests; the
    int8 kernel's counters set to 0 before the daemon starts and read after
    the last response (7 GN launches a forward too, f32).  Then direct
    calls and the profiled bucket-32 forward; card vs CPU int8 masks
    ≥ 99.9% (CPU: the plain versions); int8 vs the bf16 artifact's masks
    > 98%; the artifact ≤ 0.4 x the float one."""
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        export as cli_export,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        load_serving_artifact,
    )

    set_tf32(False)
    cfg_path, _, _ = _train_config(tmp, "fpn", epochs=3)
    pth = str(tmp / "train_fpn_out" / "pth" / "best.pth")
    paths = {k: tmp / f"fpn_{k}.pdacpt" for k in ("int8", "bf16")}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_export.main(["--config", str(cfg_path), "--pth_path", pth,
                         "--out", str(paths["int8"]), "--int8",
                         "--calib_path", str(tmp / "data" / "test"),
                         "--device", "cuda"])
    export_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        cli_export.main(["--config", str(cfg_path), "--pth_path", pth,
                         "--out", str(paths["bf16"])])
    size = {k: p.stat().st_size for k, p in paths.items()}
    art = load_serving_artifact(str(paths["int8"]), device="cuda")
    if not art.meta.get("int8") or size["int8"] > 0.4 * size["bf16"]:
        raise AssertionError(f"int8 artifact {art.meta}, sizes {size}")
    served = _serve_http(art)
    launches, by_shape = served["int8_launches"], served["int8_by_shape"]
    stats = served["stats"]
    forwards = stats["batches"] + stats["warmups"]
    if not launches or launches % forwards or not stats.get("int8") \
            or served["launches"] != 7 * forwards:
        raise AssertionError(
            f"int8 serving: {launches} int8 launches, {served['launches']} "
            f"GN launches over {forwards} forwards; stats {stats}")
    log(_serve_log("fpn/resnet18 int8", served)
        + f"; int8 kernel launches {launches} = {launches // forwards} x "
        f"{forwards} forwards, GN {served['launches']} (f32); artifact "
        f"{size['int8'] / 1e6:.2f} MB vs bf16 {size['bf16'] / 1e6:.2f} MB "
        f"({size['int8'] / size['bf16']:.3f}); export with calibration "
        f"{export_s:.1f} s")
    direct = _direct_and_profile(art, "fpn/resnet18 int8", card)
    tiles = _tiles(8, seed=52)
    p8 = art(tiles)
    cpu = load_serving_artifact(str(paths["int8"]), device="cpu")(tiles)
    p16 = load_serving_artifact(str(paths["bf16"]), device="cuda")(tiles)
    cpu_agree = float(((p8 >= 0.5) == (cpu >= 0.5)).mean())
    bf16_agree = float(((p8 >= 0.5) == (p16 >= 0.5)).mean())
    if cpu_agree < 0.999 or bf16_agree <= 0.98 or not np.isfinite(p8).all():
        raise AssertionError(f"int8 masks: card vs CPU {cpu_agree}, vs bf16 "
                             f"{bf16_agree}")
    log(f"[int8] fpn/resnet18 int8 card vs CPU (plain versions), 8x{TILE}²:"
        f" masks equal {cpu_agree:.6f} (gate 0.999), max |Δp| "
        f"{float(np.abs(p8 - cpu).max()):.3g}; int8 vs bf16 masks "
        f"{bf16_agree:.6f} (gate > 0.98), max |Δp| "
        f"{float(np.abs(p8 - p16).max()):.3g}")
    return {**direct, "latency_ms_p50": stats.get("latency_ms_p50"),
            "latency_ms_p99": stats.get("latency_ms_p99"),
            "artifact_bytes": size, "launches": launches,
            "by_shape": by_shape,
            "quantize_by_shape": served["quantize_by_shape"],
            "gn_by_variant": served["by_variant"],
            "card_vs_cpu_masks": cpu_agree, "vs_bf16_masks": bf16_agree}


def phase_int8_models(tmp: Path, card: str) -> dict:
    """ResUNet int8 at batch 512 (the bench's tile→mask batch) and the
    DeepLabV3+ and PSPNet int8 forwards at bucket 32, each from its phase-5
    ``best.pth`` calibrated on the test patches, a main path each: the
    int8 counters set to 0 just before the timed calls and read after; ms
    by CUDA events, peak memory, masks against the bf16 model.  The bf16
    forward of the same ``best.pth`` (``make_infer_step``) is timed right
    after, on the same input, with its peak memory."""
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        make_infer_step,
    )

    set_tf32(False)
    out = {}
    for model, batch in (("unet", UNET_INFER_BATCH), ("deeplabv3+", 32),
                         ("pspnet", 32)):
        _, net, step = _quantized_step(tmp, model)
        x = torch.from_numpy(_tiles(32, seed=53)).cuda().repeat(
            batch // 32, 1, 1, 1)
        _int8_counts(reset=True)
        step(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(x), warmup=1, iters=4, windows=3)
        peak = torch.cuda.max_memory_allocated()
        launches, by_shape = _int8_counts()
        quantize_by_shape = _quantize_counts()
        bf16 = make_infer_step(net, TILE)
        bf16(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms16 = cuda_ms(lambda: bf16(x), warmup=1, iters=4, windows=3)
        peak16 = torch.cuda.max_memory_allocated()
        p8 = step(x[:32]).float()
        p16 = bf16(x[:32]).float()
        agree = float(((p8 >= 0.5) == (p16 >= 0.5)).float().mean())
        if not launches or not torch.isfinite(p8).all():
            raise AssertionError(f"{model} int8: {launches} launches")
        out[model] = {"batch": batch, "ms": ms, "tiles_per_s":
                      batch * 1e3 / ms, "peak_bytes": peak,
                      "bf16_ms": ms16, "bf16_peak_bytes": peak16,
                      "launches": launches, "by_shape": by_shape,
                      "quantize_by_shape": quantize_by_shape,
                      "vs_bf16_masks": agree}
        log(f"[int8] {model}/resnet18 int8 forward at batch {batch}, input "
            f"on the card: {ms:.3f} ms by CUDA events, "
            f"{batch * 1e3 / ms:.1f} tiles/s, peak {peak / 2 ** 30:.2f} GiB;"
            f" bf16 forward of the same best.pth right after {ms16:.3f} ms, "
            f"peak {peak16 / 2 ** 30:.2f} GiB; int8 kernel launches "
            f"{launches}; masks vs bf16 {agree:.6f}; on {card}")
        del net, step, bf16, x
        torch.cuda.empty_cache()
    return out


def phase_int8_overlay(tmp: Path) -> dict:
    """``cli.overlay --int8 --banded --device cuda`` with phase 5's FPN
    ``best.pth`` on a 2048² JPEG TIFF (stride 256, hann, the config's
    batch), a main path: the int8 and GN counters set to 0 just before it
    and read just after."""
    import yaml
    from PIL import Image

    set_tf32(False)
    slide = _wsi_slide(OVERLAY_SLIDE, seed=45)
    path = tmp / "wsi" / "slide_int8.tiff"
    path.parent.mkdir(exist_ok=True)
    Image.fromarray(slide).save(path, compression="jpeg", quality=90)
    _, cfg, _ = _train_config(tmp, "fpn", 3)
    cfg_path = tmp / "wsi" / "overlay_int8.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(cfg, batch_size=CONFIG_BATCH)))
    out = tmp / "wsi" / "out_int8"
    # -- the main path: launches counted from here ...
    _int8_counts(reset=True)
    _gn_forward_counts(reset=True)
    result, _, frac = _run_cli_overlay([
        "--config", str(cfg_path), "--device", "cuda", "--pth_path",
        str(tmp / "train_fpn_out" / "pth" / "best.pth"), "--slide",
        str(path), "--banded", "--stride", str(WSI_STRIDE), "--blend",
        "hann", "--int8", "--save_path", str(out)])
    launches, by_shape = _int8_counts()
    quantize_by_shape = _quantize_counts()
    gn = _gn_forward_counts()
    # -- ... to here
    prob = _check_prob_map("int8 overlay", out / "probability_map.npy",
                           (OVERLAY_SLIDE, OVERLAY_SLIDE), np.float16)
    windows = _windows(OVERLAY_SLIDE, WSI_STRIDE) ** 2
    high, low = float((prob >= 0.5).mean()), float((prob > 0.5).mean())
    if result["n_tiles"] != windows or not launches or not gn[0] \
            or not low - 1e-12 <= result["tumor_fraction"] <= high + 1e-12:
        raise AssertionError(f"int8 overlay: {result}, int8 launches "
                             f"{launches}, GN {gn[0]}")
    log(f"[wsi] fpn/resnet18 --int8 --banded: {OVERLAY_SLIDE}² JPEG TIFF, "
        f"{windows} windows in {result['seconds']:.1f} s (calibration "
        f"included), tumor fraction {result['tumor_fraction']:.6f} (printed "
        f"{frac}); int8 kernel launches {launches}, GN {gn[0]} (f32, "
        f"calibration's included)")
    return {"seconds": result["seconds"], "launches": launches,
            "by_shape": by_shape, "quantize_by_shape": quantize_by_shape,
            "gn_by_variant": gn[2]}


def _he_tiles(n: int, seed: int, size: int = TILE) -> np.ndarray:
    """H&E-like uint8 tiles by Beer-Lambert: smooth gamma-distributed
    hematoxylin and eosin concentrations on the reference stain basis,
    jittered per tile, a fifth of each tile glass, and noise.  Their
    optical densities lie near a stain plane, which Macenko's fit
    presumes."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.stain import (
        REFERENCE_STAIN_BASIS,
    )

    rng = np.random.default_rng(seed)
    tiles = []
    for _ in range(n):
        # concentrations that keep every pixel above black: a saturated
        # pixel's optical density is all noise
        coarse = torch.from_numpy(rng.gamma(2.0, 0.2, (1, 2, 16, 16))
                                  .astype(np.float32))
        conc = torch.nn.functional.interpolate(
            coarse, size=(size, size), mode="bilinear",
            align_corners=False)[0].numpy().transpose(1, 2, 0)
        glass = np.kron(rng.random((size // 32, size // 32)) < 0.2,
                        np.ones((32, 32), bool))
        conc[glass] *= 0.02
        basis = REFERENCE_STAIN_BASIS + rng.normal(0, 0.05, (3, 2))
        rgb = 255.0 * np.power(10.0, -(conc @ basis.T))
        tiles.append(np.clip(rgb + rng.normal(0, 2, rgb.shape), 0, 255))
    return np.stack(tiles).astype(np.uint8)


def phase_stain_serving(tmp: Path, card: str) -> dict:
    """A ``stain: macenko`` FPN artifact (f32, TF32 off) from phase 5's
    ``best.pth``, served by the daemon on the card (GN 7 a forward), then
    card vs CPU on 8 H&E-like tiles and on the 8 first synthetic test
    patches (colour noise and a tinted disc: no stain plane): the stained
    pixels and the probabilities within 5e-4 (the f32 model's bound) and
    masks ≥ 99.9% equal; the stain must change the probabilities.  The
    stained patches in float64 too, card vs CPU within 1e-8: a fault of
    the card's eigh, sort or percentile path would show there whatever
    float32 rounds."""
    import yaml

    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        export as cli_export,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        load_serving_artifact,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops.stain import (
        apply_stain_batch,
    )

    set_tf32(False)
    _, cfg, _ = _train_config(tmp, "fpn", 3)
    arts = {}
    for stain in ("macenko", "none"):
        cfg_path = tmp / f"stain_{stain}.yaml"
        cfg_path.write_text(yaml.safe_dump(dict(
            cfg, stain=stain, compute_dtype="float32")))
        arts[stain] = tmp / f"fpn_{stain}.pdacpt"
        with contextlib.redirect_stdout(io.StringIO()):
            cli_export.main(["--config", str(cfg_path), "--pth_path",
                             str(tmp / "train_fpn_out" / "pth" / "best.pth"),
                             "--out", str(arts[stain])])
    art = load_serving_artifact(str(arts["macenko"]), device="cuda")
    served = _serve_http(art)
    forwards = served["stats"]["batches"] + served["stats"]["warmups"]
    if served["launches"] != 7 * forwards:
        raise AssertionError(f"stain serving GN launches {served['launches']}"
                             f" over {forwards} forwards")
    log(_serve_log("fpn/resnet18 stain macenko f32", served))
    cpu_art = load_serving_artifact(str(arts["macenko"]), device="cpu")
    plain_art = load_serving_artifact(str(arts["none"]), device="cuda")

    def gap(a, b):  # per image, max |Δ| over pixels and channels
        return (a.double() - b.double()).abs().amax(dim=(1, 2, 3))

    out = {"latency_ms_p50": served["stats"].get("latency_ms_p50"),
           "gn_by_variant": served["by_variant"]}
    patches = np.concatenate(_calib_batches(tmp))[:8]
    for what, tiles in (("he_tiles", _he_tiles(8, seed=54)),
                        ("patches", patches)):
        x01 = torch.from_numpy(tiles).float() / 255.0
        pix = gap(apply_stain_batch(x01.cuda(), "macenko").cpu(),
                  apply_stain_batch(x01, "macenko"))
        x64 = x01.double()
        pix64 = gap(apply_stain_batch(x64.cuda(), "macenko").cpu(),
                    apply_stain_batch(x64, "macenko"))
        card, cpu = art(tiles), cpu_art(tiles)
        err = float(np.abs(card - cpu).max())
        agree = float(((card >= 0.5) == (cpu >= 0.5)).mean())
        moved = float(np.abs(card - plain_art(tiles)).max())
        if float(pix.max()) > 5e-4 or float(pix64.max()) > 1e-8 \
                or err > 5e-4 or agree < 0.999 or moved < 1e-3:
            raise AssertionError(
                f"stain artifact card vs CPU on the {what}: stained pixels "
                f"{pix.tolist()} (float64 {pix64.tolist()}), max |Δp| {err},"
                f" masks {agree}; vs no stain {moved}")
        log(f"[stain] macenko FPN artifact, f32, TF32 off, 8 "
            f"{what.replace('_', ' ')}: card vs CPU stained pixels max |Δ| "
            f"{float(pix.max()):.3g} (bound 5e-4; float64 "
            f"{float(pix64.max()):.3g}, bound 1e-8), max |Δp| {err:.3g} "
            f"(bound 5e-4), masks equal {agree:.6f} (gate 0.999); vs the "
            f"stainless artifact max |Δp| {moved:.3g}")
        out[what] = {"pixels_max": float(pix.max()),
                     "pixels_f64_max": float(pix64.max()),
                     "card_vs_cpu_max": err, "masks": agree}
    return out


def phase_wsi_device(tmp: Path, card: str, int8: bool) -> dict:
    """The timed 40,960² slide (stride 256, hann, 25,281 windows) from
    ``DeviceSlideSource``: the bands are made on the card and nothing is
    uploaded; FPN/resnet18 from phase 5's ``best.pth``, batch 128, bf16 or
    (``int8``) int8 calibrated on the slide's first 16 windows.  A main
    path: the counters set to 0 just before the run and read just after;
    profiled for the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
        DeviceSlideSource,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized as q,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        load_serving_state,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
        BandedSlidingWindow,
    )

    set_tf32(False)
    _, cfg_d, _ = _train_config(tmp, "fpn", epochs=3)
    cfg = Config.from_dict(dict(cfg_d, batch_size=CONFIG_BATCH))
    model, _ = load_serving_state(
        cfg, str(tmp / "train_fpn_out" / "pth" / "best.pth"), "cuda")
    source = DeviceSlideSource(WSI_TIMED_SIDE, tile=TILE, stride=WSI_STRIDE,
                               seed=41, device="cuda")
    infer_step = None
    if int8:
        sd = model.state_dict()
        calib = np.stack([source.get(i)[0] for i in range(16)])
        bundle, forward = q.quantize_from_config(cfg, sd, [calib])
        infer_step = q.make_quantized_infer_step(sd, bundle, TILE, forward)
    runner = BandedSlidingWindow(model, tile=TILE, batch_size=CONFIG_BATCH,
                                 blend="hann", num_workers=cfg.num_worker,
                                 infer_step=infer_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: launches counted from here ...
    _gn_forward_counts(reset=True)
    _int8_counts(reset=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prob, mask = runner.run(source)
        wall = time.perf_counter() - t0
    gn = _gn_forward_counts()
    launches, by_shape = _int8_counts()
    quantize_by_shape = _quantize_counts()
    # -- ... to here
    peak = torch.cuda.max_memory_allocated()
    tag = "int8" if int8 else "bf16"
    stats = runner.last_run
    if stats["band_upload_bytes"] or not gn[0] or bool(launches) != int8:
        raise AssertionError(f"device slide {tag}: {stats}, GN {gn[0]}, "
                             f"int8 launches {launches}")
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    copies = sum(ev.self_device_time_total for ev in events
                 if ev.key.startswith(("Memcpy", "Memset"))) / 1e6
    kernels = sum(ev.self_device_time_total for ev in events) / 1e6 - copies
    n = len(source)
    sample = prob[::97, ::89].astype(np.float32)
    if prob.shape != (WSI_TIMED_SIDE,) * 2 or not np.isfinite(sample).all() \
            or sample.min() < 0 or sample.max() > 1:
        raise AssertionError(f"device slide {tag}: maps {prob.shape}")
    out = {"windows": n, "wall_s": wall, "windows_per_s": n / wall,
           "kernel_s": kernels, "copy_s": copies,
           "busy_share": kernels / wall, "peak_bytes": peak,
           "upload_bytes": stats["band_upload_bytes"],
           "band_make_s": stats["band_upload_s"],
           "read_s": stats["band_read_s"], "bands": stats["bands"],
           "gn_launches": gn[0], "int8_launches": launches,
           "tumor_fraction": float(mask[::7, ::7].mean())}
    log(f"[wsi-40k-device] {WSI_TIMED_SIDE}² DeviceSlideSource, stride "
        f"{WSI_STRIDE}, hann, FPN/resnet18 {tag}, batch {CONFIG_BATCH}: {n} "
        f"windows in {wall:.2f} s wall = {n / wall:.1f} windows/s; device "
        f"kernels {kernels:.2f} s, busy share {kernels / wall:.3f}; copies "
        f"{copies:.2f} s; peak {peak / 2 ** 30:.2f} GiB; {stats['bands']} "
        f"bands made on the card in {stats['band_upload_s']:.3f} s of "
        f"device time, 0 bytes uploaded; GN launches {gn[0]}, int8 "
        f"{launches}; on {card}")
    del prob, mask
    return {"summary": out, "by_variant": gn[2], "by_shape": by_shape,
            "quantize_by_shape": quantize_by_shape}


# -- phase 11: every training option ------------------------------------------

# BASELINE.json config #2: U-Net at 512² with full augmentation and
# stain-normalization preprocessing, multi-class PDAC regions
CONFIG_2 = {"num_classes": 3, "stain": "macenko", "loss": "dice"}
# config #3: the deeper variant (U-Net++ on a ResNet encoder) with weighted
# Dice + CE
CONFIG_3 = {"num_classes": 3, "loss": "dice_ce",
            "class_weights": [1.0, 2.0, 2.0]}
# the JAX package's way to the config's batch 128 on one chip for the
# widest encoder (its train/steps.py:59-72)
REMAT_ACCUM = {"remat": True, "grad_accum_steps": 4}
OPTION_PATHS = {
    "train_unet_3class_macenko": ("unet", "resnet18", CONFIG_2),
    "train_unet++_3class_dice_ce": ("unet++", "resnet18", CONFIG_3),
    "train_fpn_nonfused": ("fpn", "resnet18", {"fused_augment": False}),
    "train_fpn_parity": ("fpn", "resnet18", {"parity_mode": True}),
    f"train_fpn_{B7}_remat_accum4": ("fpn", B7, REMAT_ACCUM),
}


def phase_class_data(tmp: Path) -> None:
    """Synthetic 512² PNG patches with class ids 0..2 (a circle per class),
    the splits of phase 5's sizes, under ``tmp / "data3"``."""
    t0 = time.perf_counter()
    for split, n, seed in (("train", N_TRAIN, 40), ("val", N_VAL, 41),
                           ("test", N_TEST, 42)):
        _write_patches(tmp / "data3" / split, n, seed, classes=3)
    log(f"[data] {N_TRAIN} + {N_VAL} + {N_TEST} 3-class {TILE}² PNG patches "
        f"in {time.perf_counter() - t0:.1f} s")


def _option_path(tmp: Path, name: str, epochs: int, resume_epochs: int = 0,
                 batch: int = TRAIN_BATCH, data: str = "data",
                 resume_extra: dict | None = None) -> dict:
    """The main path ``name`` of :data:`OPTION_PATHS`: ``cli.train`` for
    ``epochs``, then, with ``resume_epochs``, a rerun (with
    ``resume_extra``) that must resume; the launch counters set to 0 just
    before and read just after, and held to
    :func:`_expected_train_launches`."""
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        can_fuse_augment,
    )

    model, backbone, extra = OPTION_PATHS[name]
    tag = name.removeprefix("train_")
    cfg_path, cfg, cuts = _train_config(tmp, model, epochs, backbone,
                                        name=tag, batch=batch, data=data,
                                        **extra)
    out = tmp / f"train_{tag}_out"
    log(f"[options] {tag}: configs/train_config.yaml ({model}/{backbone}, "
        f"{cfg['compute_dtype']}) with {extra}, the cuts "
        + ", ".join(f"{k} {a} -> {b}" for k, (a, b) in cuts.items()))
    # -- the main path: launches counted from here ...
    _train_counters(reset=True)
    results = [_run_cli_train(cfg_path, out)]
    if resume_epochs:
        _train_config(tmp, model, resume_epochs, backbone, name=tag,
                      batch=batch, data=data, **extra, **(resume_extra or {}))
        results.append(_run_cli_train(cfg_path, out))
    counts = _train_counters()
    # -- ... to here
    printed = results[-1][1]
    if resume_epochs and f"resumed from epoch {epochs - 1}" not in printed:
        raise AssertionError(f"{tag}: the rerun did not resume")
    history = sum((r[0]["history"] for r in results), [])
    if [h["epoch"] for h in history] != list(range(resume_epochs or epochs)) \
            or not all(np.isfinite([h["train_loss"], h["train_score"],
                                    h["val_loss"], h["val_score"]]).all()
                       for h in history):
        raise AssertionError(f"{tag}: training history {history}")
    n_epochs = resume_epochs or epochs
    steps = n_epochs * -(-N_TRAIN // batch)
    evals = n_epochs * -(-N_VAL // batch)
    dtype = getattr(torch, cfg["compute_dtype"])
    fused = bool(cfg.get("fused_augment", True)) and can_fuse_augment(
        (batch, TILE, TILE, 3), cfg["img_size"], bool(cfg.get("parity_mode")),
        cfg.get("stain", "none"), dtype)
    want, want_shapes = _expected_train_launches(
        steps, evals, batch, batch, fused, model == "fpn",
        micro=int(cfg.get("grad_accum_steps", 1)),
        remat=bool(cfg.get("remat")))
    got = {k: v[0] for k, v in counts.items()}
    if got != want or any(counts[k][1] != want_shapes[k] for k in want):
        raise AssertionError(f"{tag}: launches {counts}, expected {want} "
                             f"{want_shapes}")
    for k in ("gn_forward", "gn_backward"):
        _all_cluster(f"{tag} {k}", counts[k][2], counts[k][1])
    seconds = [r[2] for r in results]
    log(f"[options] {tag}: {n_epochs} epochs in "
        f"{' + '.join(f'{t:.1f}' for t in seconds)} s, losses "
        f"{[round(h['train_loss'], 4) for h in history]}, val scores "
        f"{[round(h['val_score'], 4) for h in history]}; launches {got} "
        f"({steps} steps, {evals} eval batches, fused {fused})")
    return {"counts": counts, "history": history, "printed": printed,
            "out": out, "cfg_path": cfg_path, "seconds": seconds}


def _check_profile(tag: str, out: Path, epochs: int) -> list:
    """``profile_epoch``'s trace under ``log_dir/profile`` with CUDA
    kernels in it, and the four scalar tags for every epoch."""
    from pdac_pathological_image_segmentation_tpu_torch.utils.profiling import (
        device_op_summary,
    )

    traces = sorted((out / "log_dir" / "profile").glob("*.pt.trace.json"))
    rows = device_op_summary(str(out / "log_dir" / "profile"), top=5)
    if not traces or not rows:
        raise AssertionError(f"{tag}: no profile trace or no kernel in it")
    raw = json.loads(traces[-1].read_text())
    if not any(e.get("cat") == "kernel" for e in raw.get("traceEvents", [])):
        raise AssertionError(f"{tag}: the trace holds no CUDA kernel")
    lines = (out / "log_dir" / "scalars.csv").read_text().splitlines()
    epochs_seen = sorted({int(r.split(",")[0]) for r in lines})
    if epochs_seen != list(range(1, epochs + 1)) or len(lines) != 4 * epochs:
        raise AssertionError(f"{tag}: scalars.csv rows {lines}")
    log(f"[options] {tag}: profile_epoch trace {traces[-1].name}, top "
        "kernels " + "; ".join(f"{us / 1e3:.3f} ms {name[:50]}"
                               for us, name, _ in rows[:3])
        + f"; scalars.csv 4 tags x {epochs} epochs")
    return [[us, name] for us, name, _ in rows]


def _stain_ms(n: int = CONFIG_BATCH) -> float:
    """Macenko on ``n`` tiles of 512² as the bf16 train chain hands them
    over (bf16 on [0, 1], NHWC), by CUDA events."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.stain import (
        apply_stain_batch,
    )

    x = (torch.from_numpy(_tiles(n, seed=8)).cuda().to(torch.bfloat16)
         / 255.0)
    return cuda_ms(lambda: apply_stain_batch(x, "macenko"), warmup=2,
                   iters=2, windows=3)


def _ulps_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| in bf16 units in the last place of ``b``."""
    ulp = torch.exp2(torch.floor(torch.log2(b.float().abs().clamp_min(
        2.0 ** -126))) - 7)
    return (a.float() - b.float()).abs() / ulp


def phase_chain_card_vs_cpu(n: int = 8) -> list:
    """The non-fused chain on the card against the CPU with one generator
    state, default and parity mode: f32 images within 1e-6, bf16 within
    one ulp with at least 99.9% bit-identical, masks bitwise."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
        train_transform,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        step_generator,
    )

    set_tf32(False)
    images = torch.from_numpy(_tiles(n, seed=21))
    masks = torch.from_numpy(_masks(n, seed=21, classes=3))
    rows = []
    for parity in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            out = {}
            for dev in ("cpu", "cuda"):
                img, msk = train_transform(
                    images.to(dev), masks.to(dev), TILE,
                    step_generator(5, 0, int(parity)),
                    parity_mode=parity, dtype=dtype)
                out[dev] = (img.cpu(), msk.cpu())
            (ci, cm), (gi, gm) = out["cpu"], out["cuda"]
            what = (f"{'parity' if parity else 'default'} chain "
                    f"{str(dtype).split('.')[-1]}")
            if not torch.equal(cm, gm):
                raise AssertionError(f"{what}: masks differ card vs CPU")
            diff = float((gi.float() - ci.float()).abs().max())
            same = float((gi == ci).float().mean())
            if dtype == torch.float32:
                ok = diff <= 1e-6
                bound = "1e-6"
            else:
                ok = same >= 0.999 and float(_ulps_bf16(gi, ci).max()) <= 1
                bound = "one ulp, >= 99.9% bit-identical"
            log(f"[chain] {what}, {n}x{TILE}², card vs CPU: max |Δ| "
                f"{diff:.3g}, bit-identical {same:.6f} ({bound}); masks "
                "bitwise")
            if not ok:
                raise AssertionError(f"{what}: card vs CPU beyond {bound}")
            rows.append({"chain": what, "max_abs": diff,
                         "bit_identical": same})
    return rows


def phase_remat_equivalence() -> dict:
    """FPN/efficientnet-b7 at the smoke's training batch (32): one k = 4
    step with remat against the same step without, from one seeded state
    and one generator, cuDNN deterministic, beside a second plain step as
    the control.  The forward must be the same: loss within 1e-5, BN buffers
    within 1e-5, ``num_batches_tracked`` equal; the GN forward kernel runs
    twice as often (the recompute).  The backward is not deterministic on
    the card (the logits' bilinear resize sums its gradient with atomics,
    and bf16 rounding carries that everywhere), so the gradients are held
    against the control: each tensor's |g_remat − g_plain| / |g_plain|
    within the larger of 5e-3 and twice the worst such distance of the two
    plain steps, and their median within 1.5 times the control's plus
    5e-3; every parameter within 2·lr after Adam.  Each parameter's
    distance after Adam over its update's norm is reported for both."""
    import yaml

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
    # at the smoke's training batch (4 microbatches of 8): three b7 steps
    # at the config's 128 with cuDNN's deterministic algorithms take the
    # card about 40 s
    raw.update(model="fpn", backbone=B7, batch_size=TRAIN_BATCH,
               **REMAT_ACCUM)
    n, lr = raw["batch_size"], float(raw["lr"])
    model = build_model(Config.from_dict(raw))
    names = [k for k, _ in model.named_parameters()]
    sd = seeded_state_dict(model, seed=7)
    del model
    images = torch.from_numpy(_tiles(n, seed=8)).cuda()
    masks = torch.from_numpy(_masks(n, seed=8)).cuda()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    res = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for run, remat in (("plain", False), ("plain_again", False),
                           ("remat", True)):
            net, step = _train_setup(Config.from_dict(dict(raw, remat=remat)),
                                     sd, "cuda")
            torch.cuda.synchronize()
            fwd0 = _train_counters()["gn_forward"][0]
            loss, _ = step(images, masks, valid, step_generator(1, 0, 0))
            torch.cuda.synchronize()
            res[run] = {"loss": float(loss),
                        "state": {k: v.cpu() for k, v in
                                  net.state_dict().items()},
                        "grads": {k: p.grad.float().cpu()
                                  for k, p in net.named_parameters()},
                        "gn_forward": _train_counters()["gn_forward"][0]
                        - fwd0}
            del net, step
            torch.cuda.empty_cache()
    plain = res["plain"]

    def grad_dist(run: str) -> dict:
        g = res[run]["grads"]
        return {k: float((g[k] - plain["grads"][k]).norm())
                / max(float(plain["grads"][k].norm()), 1e-30) for k in names}

    def update_dist(run: str) -> float:
        st = res[run]["state"]
        return max(float((st[k] - plain["state"][k]).norm()) / max(
            float((plain["state"][k] - sd[k]).norm()), 1e-30) for k in names)

    g_control, g_remat = grad_dist("plain_again"), grad_dist("remat")
    bound = max(5e-3, 2 * max(g_control.values()))
    median = float(np.median(list(g_remat.values())))
    median_bound = 1.5 * float(np.median(list(g_control.values()))) + 5e-3
    worst = max(g_remat, key=g_remat.get)
    within_2lr = max(float((res["remat"]["state"][k] - plain["state"][k])
                           .abs().max()) for k in names) <= 2 * lr * 1.001
    worst_bn = max(float((res["remat"]["state"][k].double()
                          - plain["state"][k].double()).abs().max())
                   for k in sd if k not in names)
    tracked = all(torch.equal(res["remat"]["state"][k], plain["state"][k])
                  for k in sd if k.endswith("num_batches_tracked"))
    d_loss = abs(res["remat"]["loss"] - plain["loss"])
    f0, f1 = plain["gn_forward"], res["remat"]["gn_forward"]
    log(f"[remat] fpn_{B7} k=4 step at batch {n}: remat vs plain |Δloss| "
        f"{d_loss:.3g} (1e-5), BN buffers max |Δ| {worst_bn:.3g} (1e-5), "
        f"num_batches_tracked equal {tracked}; gradients |Δg|/|g| worst "
        f"{g_remat[worst]:.3g} ({worst}), median {median:.3g}, against "
        f"two plain steps worst {max(g_control.values()):.3g}, median "
        f"{float(np.median(list(g_control.values()))):.3g} (bounds "
        f"{bound:.3g}, {median_bound:.3g}); after Adam every parameter within 2·lr: "
        f"{within_2lr}, worst |Δp|/|update| {update_dist('remat'):.3g} "
        f"(two plain steps {update_dist('plain_again'):.3g}); GN forward "
        f"launches {f1} vs {f0} (twice: the recompute)")
    if d_loss > 1e-5 or worst_bn > 1e-5 or not tracked \
            or g_remat[worst] > bound or median > median_bound \
            or not within_2lr or f1 != 2 * f0 \
            or not np.isfinite(plain["loss"]):
        raise AssertionError("remat step differs from the plain step")
    return {"d_loss": d_loss, "worst_bn": worst_bn,
            "grad_rel_worst": g_remat[worst], "grad_rel_median": median,
            "grad_rel_control_worst": max(g_control.values()),
            "update_rel": update_dist("remat"),
            "update_rel_control": update_dist("plain_again"),
            "gn_forward": [f0, f1]}


def phase_train_options(tmp: Path, card: str, steps: dict) -> dict:
    """Phase 11: BASELINE.json configs #2 and #3, the non-fused train chain
    (``fused_augment: false``, ``parity_mode``) and ``remat`` with
    ``grad_accum_steps`` on the widest encoder, each a main path through
    ``cli.train`` with its launches counted; the timed steps at the
    config's batch; card vs CPU for the new step and chain."""
    out = {"paths": {}, "steps": {}}
    # -- 11a: config #2, stain forces the non-fused chain
    name = "train_unet_3class_macenko"
    run = _option_path(tmp, name, 2, 3, data="data3",
                       resume_extra={"profile_epoch": 2, "debug_nans": True})
    if "profile of epoch 2" not in run["printed"]:
        raise AssertionError(f"{name}: profile_epoch printed no summary")
    out["profile_top"] = _check_profile(name, run["out"], 3)
    out["paths"][name] = run["counts"]
    res = _run_cli_test(run["cfg_path"], run["out"] / "pth",
                        tmp / "test_unet_3class_out", "cuda")
    rows = (tmp / "test_unet_3class_out" / "metrics.csv").read_text() \
        .splitlines()
    if "dice_c2" not in rows[0] or len(rows) != 1 + N_TEST + 2 \
            or "best_threshold" in res or not np.isfinite(res["test_score"]):
        raise AssertionError(f"cli.test 3-class: {res}, {rows[0]}")
    log(f"[options] cli.test 3-class on the card: test_score "
        f"{res['test_score']:.6f}, per-class metrics.csv columns "
        f"{len(rows[0].split(',')) - 2} (6 metrics x 3 classes), no sweep")
    out["test_3class"] = {"test_score": res["test_score"],
                          "metrics": res["metrics"]}
    model, backbone, extra = OPTION_PATHS[name]
    out["steps"][name] = phase_timed_step(card, model, backbone, extra,
                                          tag=name)
    stain_ms = _stain_ms()
    share = stain_ms / out["steps"][name]["ms_per_step"]
    log(f"[options] Macenko on {CONFIG_BATCH}x{TILE}² bf16 tiles: "
        f"{stain_ms:.2f} ms, {100 * share:.1f}% of the 3-class step")
    out["macenko_ms"], out["macenko_share"] = stain_ms, share
    phase_train_card_vs_cpu(model, backbone, extra=extra, tag=name)
    # -- 11b: config #3, 3 classes without stain: fused
    name = "train_unet++_3class_dice_ce"
    out["paths"][name] = _option_path(tmp, name, 2, 3,
                                      data="data3")["counts"]
    model, backbone, extra = OPTION_PATHS[name]
    out["steps"][name] = phase_timed_step(card, model, backbone, extra,
                                          tag=name)
    # -- 11c: FPN's non-fused and parity chains beside its fused one
    for key, extra in (("fpn_fused", {}),
                       ("train_fpn_nonfused", {"fused_augment": False}),
                       ("train_fpn_parity", {"parity_mode": True})):
        out["steps"][key] = phase_timed_step(card, "fpn", extra=extra,
                                             tag=key)
    out["chain"] = phase_chain_card_vs_cpu()
    out["paths"]["train_fpn_nonfused"] = _option_path(
        tmp, "train_fpn_nonfused", 2)["counts"]
    run = _option_path(tmp, "train_fpn_parity", 2, 3)
    if "best=0.0000" not in run["printed"]:
        raise AssertionError("parity_mode: the best did not reset on resume")
    out["paths"]["train_fpn_parity"] = run["counts"]
    # -- 11d: the widest encoder at the config's batch
    out["remat"] = phase_remat_equivalence()
    name = f"train_fpn_{B7}_remat_accum4"
    out["steps"][name] = phase_timed_step(card, "fpn", B7, REMAT_ACCUM,
                                          tag=name, iters=2, warmup=1)
    out["paths"][name] = _option_path(tmp, name, 2,
                                      batch=CONFIG_BATCH)["counts"]
    for key, base in (("train_fpn_nonfused", "fpn_fused"),
                      ("train_fpn_parity", "fpn_fused"),
                      (name, _tag("fpn", B7))):
        got, ref = out["steps"][key], (out["steps"].get(base)
                                       or steps.get(base))
        if ref:
            log(f"[options] {key} step at batch {got['batch']}: "
                f"{got['ms_per_step']:.2f} ms, {got['patches_per_s']:.1f} "
                f"patches/s, peak {got['peak_bytes'] / 2 ** 30:.2f} GiB; "
                f"{base} at batch {ref['batch']}: {ref['ms_per_step']:.2f} "
                f"ms, {ref['patches_per_s']:.1f} patches/s, peak "
                f"{ref['peak_bytes'] / 2 ** 30:.2f} GiB")
    return out


# -- phase 12: the tools and the host data path -----------------------------

N_SYNTH = 128  # 12a's patches: one batch of the config's size
DECODE_BATCH, DECODE_EPOCHS = 32, 3
# the trainer fed by its loader: 12a's pairs listed 6 times (6 steps of the
# config's batch an epoch), a native warm-up epoch, then the two decoders in
# turn
FED_REPEAT, FED_ORDER = 6, ("native", "pil", "pil", "native")
# bench.py --mode serve (bench.py:345-401): 32 closed-loop clients, 640 raw
# uint8 requests, buckets 1/8/32, a 5 ms batching window
LOAD_CLIENTS, LOAD_REQUESTS, LOAD_WAIT_MS = 32, 640, 5.0
SWEEP_SLIDES = ((4096, 4096, 50), (3072, 5120, 51))  # (h, w, seed)


def phase_synthetic_patches(tmp: Path) -> tuple:
    """12a: the port's ``generate_synthetic_patches`` at the config's patch
    size, timed; every file there.  Returns the directory and the
    readings."""
    from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
        generate_synthetic_patches,
    )

    out = tmp / "synth"
    t0 = time.perf_counter()
    n = generate_synthetic_patches(str(out), n=N_SYNTH, size=TILE, seed=0)
    seconds = time.perf_counter() - t0
    want = sorted(f"patch_{i:04d}{s}.png" for i in range(N_SYNTH)
                  for s in ("", "-labelled"))
    if n != (N_SYNTH, N_SYNTH) or sorted(p.name for p in out.iterdir()) \
            != want:
        raise AssertionError(f"generate_synthetic_patches wrote {n}")
    mb = sum(p.stat().st_size for p in out.iterdir()) / 1e6
    log(f"[synthetic] generate_synthetic_patches(n={N_SYNTH}, size={TILE}, "
        f"seed=0): {2 * N_SYNTH} PNGs ({mb:.1f} MB) in {seconds:.2f} s, "
        f"{N_SYNTH / seconds:.1f} pairs/s")
    return out, {"seconds": seconds, "pairs_per_s": N_SYNTH / seconds}


def phase_decoder(synth: Path, fpn_step: dict, card: str) -> dict:
    """12b: ``PatchLoader`` over 12a's patches on the card at batch 32 with
    the config's ``num_worker`` threads, through the native decoder and
    through PIL's ``decode_pair``, ``DECODE_EPOCHS`` epochs each way: the
    host decode alone (``host_batches``) and decode plus upload
    (``epoch``, up to the card), timed; every batch bitwise equal between
    the two ways, the native one in pinned memory, and no PNG through the
    decoder's PIL path.  Its rates beside phase 6's FPN step at 128."""
    import os

    import yaml

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.data import (
        native_loader,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
        discover_split,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
        PatchDataset,
        PatchLoader,
    )

    workers = int(yaml.safe_load(
        (ROOT / "configs" / "train_config.yaml").read_text())["num_worker"])
    ds = PatchDataset(*discover_split(str(synth)),
                      Config(model="fpn", img_size=TILE))
    loaders = {way: PatchLoader(ds, DECODE_BATCH, shuffle=True,
                                device="cuda", num_workers=workers)
               for way in ("native", "pil")}
    loaders["pil"].native_hw = None
    if loaders["native"].native_hw != (TILE, TILE):
        raise AssertionError(f"the loader's native_hw is "
                             f"{loaders['native'].native_hw}")
    pil_before = native_loader.decode_batch.pil_decodes
    host_s = dict.fromkeys(loaders, 0.0)
    full_s = dict.fromkeys(loaders, 0.0)
    batches: dict = {way: [] for way in loaders}
    pinned = []
    for epoch in range(DECODE_EPOCHS):
        for way, loader in loaders.items():
            t0 = time.perf_counter()
            for images, masks, _ in loader.host_batches(epoch):
                if way == "native":
                    pinned.append(images.is_pinned() and masks.is_pinned())
            host_s[way] += time.perf_counter() - t0
        for way, loader in loaders.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = list(loader.epoch(epoch))
            torch.cuda.synchronize()
            full_s[way] += time.perf_counter() - t0
            batches[way] += got
    pil_decodes = native_loader.decode_batch.pil_decodes - pil_before
    if pil_decodes or not all(pinned):
        raise AssertionError(f"the native path: {pil_decodes} PNGs through "
                             f"PIL, pinned {pinned}")
    n_batches = DECODE_EPOCHS * -(-N_SYNTH // DECODE_BATCH)
    if not len(batches["native"]) == len(batches["pil"]) == n_batches:
        raise AssertionError("the two ways gave different batch counts")
    for k, (a, b) in enumerate(zip(batches["native"], batches["pil"])):
        if not (a.image.is_cuda and all(torch.equal(x, y)
                                        for x, y in zip(a, b))):
            raise AssertionError(f"batch {k}: native and PIL decode differ")
    del batches
    pairs = N_SYNTH * DECODE_EPOCHS
    cores = len(os.sched_getaffinity(0))
    out = {"threads": workers, "host_cores": cores,
           **{f"{w}_decode_pairs_per_s": pairs / s for w, s in host_s.items()},
           **{f"{w}_decode_upload_pairs_per_s": pairs / s
              for w, s in full_s.items()},
           "fpn_step_patches_per_s": fpn_step["patches_per_s"],
           "fpn_step_batch": fpn_step["batch"]}
    out["native_over_step"] = (out["native_decode_upload_pairs_per_s"]
                               / fpn_step["patches_per_s"])
    out["pil_over_step"] = (out["pil_decode_upload_pairs_per_s"]
                            / fpn_step["patches_per_s"])
    log(f"[decode] {N_SYNTH} pairs of {TILE}² PNGs x {DECODE_EPOCHS} epochs "
        f"at batch {DECODE_BATCH}, {workers} threads, {cores} host cores: "
        f"native {out['native_decode_pairs_per_s']:.1f} pairs/s decode, "
        f"{out['native_decode_upload_pairs_per_s']:.1f} decode + upload; PIL "
        f"{out['pil_decode_pairs_per_s']:.1f} decode, "
        f"{out['pil_decode_upload_pairs_per_s']:.1f} decode + upload; every "
        f"batch bitwise equal, 0 PNGs through the decoder's PIL path; the "
        f"FPN step at {fpn_step['batch']} eats "
        f"{fpn_step['patches_per_s']:.1f} patches/s (phase 6): native/step "
        f"{out['native_over_step']:.3f}, PIL/step {out['pil_over_step']:.3f},"
        f" on {card}")
    return out


def phase_fed_trainer(tmp: Path, synth: Path, card: str) -> dict:
    """12b: the trainer's own epoch (``Trainer._train_epoch``, FPN on the
    config: batch 128, bf16, ``num_worker`` threads) fed by its
    ``PatchLoader`` over 12a's pairs listed ``FED_REPEAT`` times, through
    the native decoder and through PIL in turn (``FED_ORDER``, after a
    native warm-up epoch); then the same step on one batch already on the
    card, as many steps as an epoch has.  One run, so the decode shares
    the host's cores with the step as it does in training."""
    import yaml

    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
        discover_split,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
        PatchDataset,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.loop import (
        Trainer,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
        step_generator,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.profiling import (
        StepTimer,
    )

    set_tf32(False)
    raw = yaml.safe_load((ROOT / "configs" / "train_config.yaml").read_text())
    raw.pop("train_path"), raw.pop("val_path"), raw.pop("test_path")
    cfg = Config.from_dict(raw)
    imgs, masks = discover_split(str(synth))
    ds = PatchDataset(list(imgs) * FED_REPEAT, list(masks) * FED_REPEAT,
                      cfg)
    trainer = Trainer(cfg, str(tmp / "fed_out"), ds, ds, device="cuda")
    loader = trainer.train_loader
    native_hw = loader.native_hw
    if native_hw != (TILE, TILE):
        raise AssertionError(f"the trainer's loader: native_hw {native_hw}")
    pairs, steps = len(ds), len(loader)
    seconds: dict = {"native": [], "pil": []}
    timer = StepTimer()
    for epoch, way in enumerate(("native",) + FED_ORDER):
        loader.native_hw = native_hw if way == "native" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, score, n = trainer._train_epoch(epoch, timer)
        elapsed = time.perf_counter() - t0
        if n != pairs or not np.isfinite([loss, score]).all():
            raise AssertionError(f"fed epoch {epoch} ({way}): {n} samples, "
                                 f"loss {loss}, score {score}")
        if epoch:  # the first is the warm-up
            seconds[way].append(elapsed)
    loader.native_hw = native_hw
    batch = loader._to_device(next(loader.host_batches(0)))
    gens = [step_generator(cfg.seed, 99, i) for i in range(steps + 2)]
    for gen in gens[:2]:
        trainer.train_step(*batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for gen in gens[2:]:
        loss, score = trainer.train_step(*batch, gen)
    torch.cuda.synchronize()
    on_card_s = time.perf_counter() - t0
    if not np.isfinite([float(loss), float(score)]).all():
        raise AssertionError(f"on-card steps: loss {loss}, score {score}")
    out = {"pairs_per_epoch": pairs, "steps_per_epoch": steps,
           "batch": cfg.batch_size, "threads": cfg.num_worker,
           "order": list(FED_ORDER),
           **{f"{w}_epoch_s": v for w, v in seconds.items()},
           **{f"{w}_patches_per_s": pairs * len(v) / sum(v)
              for w, v in seconds.items()},
           "on_card_patches_per_s": steps * cfg.batch_size / on_card_s}
    for w in seconds:
        out[f"{w}_over_on_card"] = (out[f"{w}_patches_per_s"]
                                    / out["on_card_patches_per_s"])
    log(f"[fed] the trainer's epoch, FPN at batch {cfg.batch_size} "
        f"({steps} steps, {pairs} pairs of {TILE}² PNGs, {cfg.num_worker} "
        f"threads), epochs {' '.join(FED_ORDER)} after a native warm-up: "
        f"native {out['native_patches_per_s']:.1f} patches/s (epochs "
        f"{', '.join(f'{x:.3f}' for x in seconds['native'])} s), PIL "
        f"{out['pil_patches_per_s']:.1f} (epochs "
        f"{', '.join(f'{x:.3f}' for x in seconds['pil'])} s); the same step "
        f"with its batch on the card {out['on_card_patches_per_s']:.1f} "
        f"patches/s: native/on-card {out['native_over_on_card']:.3f}, "
        f"PIL/on-card {out['pil_over_on_card']:.3f}, on {card}")
    return out


def phase_extract(tmp: Path, slide_path: Path, geojson_path: Path) -> dict:
    """12c: ``cli.extract`` on phase 9's tiled pyramidal TIFF with phase 9's
    own GeoJSON, at downsample 1 and at ``--slide_mpp 0.25`` (downsample
    2): the file names, every pair read back through ``PatchLoader``'s
    native path, every label tile ``rasterize_shapes`` of the same shapes at
    its window and, where the level is read as it is, every image tile
    ``TiffSlide.read_region`` of its window."""
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        extract as cli_extract,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data import (
        native_loader,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
        parse_geojson,
        rasterize_shapes,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
        PatchDataset,
        PatchLoader,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.tiffslide import (
        TiffSlide,
    )

    shapes = parse_geojson(str(geojson_path), label_map={"Tumor": 1},
                           default_label=None)
    # each shape's level-0 bounding box: the gate rasterizes a window with
    # the shapes that reach it, in their order (the others paint none of
    # it), where the CLI takes them all
    pts = [np.concatenate(rings)[:, :2] for _, rings in shapes]
    boxes = np.asarray([(*q.min(0), *q.max(0)) for q in pts],
                       np.float64).reshape(-1, 4)

    def window_shapes(x: int, y: int, side: int) -> list:
        near = ((boxes[:, 0] <= x + side) & (boxes[:, 2] >= x)
                & (boxes[:, 1] <= y + side) & (boxes[:, 3] >= y))
        return [shapes[k] for k in np.flatnonzero(near)]

    out: dict = {}
    with TiffSlide(str(slide_path)) as slide:
        w0, h0 = slide.dimensions(0)
        for argv, ds in ((["--downsample", "1"], 1.0),
                         (["--slide_mpp", "0.25"], 2.0)):
            dest = tmp / "extract" / f"d{ds:g}"
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = cli_extract.main(
                    ["--slide", str(slide_path), "--annotations",
                     str(geojson_path), "--out", str(dest), "--tile",
                     str(TILE), *argv])
            seconds = time.perf_counter() - t0
            for line in buf.getvalue().splitlines():
                log(f"[extract]   {line}")
            # the QuPath exporter's names, in level-0 coordinates
            side = int(round(TILE * ds))
            windows = {}
            for ey in range(0, int(h0 / ds) - TILE + 1, TILE):
                for ex in range(0, int(w0 / ds) - TILE + 1, TILE):
                    x, y = int(round(ex * ds)), int(round(ey * ds))
                    windows[f"{slide_path.stem} [d={ds:g},x={x},y={y},"
                            f"w={side},h={side}]"] = (x, y)
            names = sorted(f"{k}{s}.png" for k in windows
                           for s in ("", "-labelled"))
            if res["downsample"] != ds or res["written"] != len(windows) \
                    or sorted(p.name for p in dest.iterdir()) != names:
                raise AssertionError(f"cli.extract {argv}: {res}")
            level = res["level"]
            level_ds = w0 / slide.dimensions(level)[0]
            exact = level_ds == ds  # else the residual bilinear resize
            ds_ = PatchDataset([str(dest / f"{k}.png") for k in windows],
                               [str(dest / f"{k}-labelled.png")
                                for k in windows],
                               Config(model="fpn", img_size=TILE),
                               pre_shuffle=False)
            loader = PatchLoader(ds_, DECODE_BATCH, shuffle=False,
                                 device="cuda", num_workers=8)
            if loader.native_hw != (TILE, TILE):
                raise AssertionError(f"extracted pairs: native_hw "
                                     f"{loader.native_hw}")
            pil_before = native_loader.decode_batch.pil_decodes
            coords = list(windows.values())
            i = labelled = 0
            for batch in loader.epoch(0):
                images, masks = batch.image.cpu().numpy(), batch.mask.cpu(
                ).numpy()
                for k in range(int(batch.valid.sum())):
                    x, y = coords[i]
                    want = rasterize_shapes(window_shapes(x, y, side), TILE,
                                            TILE, scale=ds,
                                            offset=(float(x), float(y)))
                    if not np.array_equal(masks[k], want):
                        raise AssertionError(f"label tile at ({x}, {y}), "
                                             f"downsample {ds:g}")
                    if exact and not np.array_equal(images[k],
                                                    slide.read_region(
                                                        level,
                                                        int(x / level_ds),
                                                        int(y / level_ds),
                                                        TILE, TILE)):
                        raise AssertionError(f"image tile at ({x}, {y}), "
                                             f"downsample {ds:g}")
                    labelled += bool(want.any())
                    i += 1
            if i != len(coords) or \
                    native_loader.decode_batch.pil_decodes != pil_before:
                raise AssertionError(f"read back {i} of {len(coords)} pairs")
            how = (f"level {level} read as it is" if exact else
                   f"level {level} (downsample {level_ds:g}) and a bilinear "
                   "resize")
            log(f"[extract] downsample {ds:g} ({' '.join(argv)}): "
                f"{res['written']} pairs of {TILE}² in {seconds:.2f} s "
                f"({res['written'] / seconds:.1f} pairs/s), from {how}; names "
                f"as the QuPath exporter's, {labelled} with tumor; every label "
                f"tile equal to rasterize_shapes of {len(shapes)} shapes"
                + (", every image tile equal to read_region" if exact else "")
                + "; read back through the loader's native path")
            out[f"downsample_{ds:g}"] = {
                "pairs": res["written"], "seconds": seconds, "level": level,
                "level_read_as_is": exact, "with_tumor": labelled}
    return out


def phase_loadtest(tmp: Path, card: str) -> dict:
    """12d: ``serve_and_loadtest`` at ``bench.py --mode serve``'s settings on
    phase 4's FPN artifact (raw float32 responses, then ``;repr=u8``) and
    phase 4b's ResUNet artifact, each a main path: the GN counters set to 0
    before the daemon starts and read after it stops, the FPN's launches
    7 per device forward (the daemon's batches and its warm-ups, counted
    on the artifact's step), per shape, all cluster; ResUNet's none."""
    import collections

    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        load_serving_artifact,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.loadtest import (
        serve_and_loadtest,
    )

    set_tf32(False)
    runs = (("fpn", "fpn512", "application/octet-stream"),
            ("fpn_u8", "fpn512", "application/octet-stream;repr=u8"),
            ("unet", "unet512", "application/octet-stream"))
    out: dict = {"by_variant": {}}
    for tag, name, accept in runs:
        artifact = load_serving_artifact(str(tmp / f"{name}.pdacpt"),
                                         device="cuda")
        forwards: collections.Counter = collections.Counter()
        step = artifact.step

        def counted(images, step=step, forwards=forwards):
            forwards[int(images.shape[0])] += 1
            return step(images)

        artifact.step = counted
        # -- the main path: launches counted from here ...
        _gn_forward_counts(reset=True)
        res = serve_and_loadtest(
            artifact, buckets=BUCKETS, max_wait_ms=LOAD_WAIT_MS,
            concurrency=LOAD_CLIENTS, n_requests=LOAD_REQUESTS,
            accept=accept)
        counts = _gn_forward_counts()
        # -- ... to here
        if res["errors"] or res["requests"] != LOAD_REQUESTS or not (
                0 < res["latency_ms_p50"] <= res["latency_ms_p90"]
                <= res["latency_ms_p99"]):
            raise AssertionError(f"load test {tag}: {res}")
        # the measured batches, the warm-up client's and one per bucket
        if sum(forwards.values()) < res["device_batches"] + len(BUCKETS) + 1:
            raise AssertionError(f"load test {tag}: {dict(forwards)} "
                                 f"forwards, {res['device_batches']} batches")
        if tag.startswith("fpn"):
            _check_forwards(f"load test {tag}", counts, dict(forwards))
            _add_counts(out["by_variant"], counts[2])
        elif counts[0]:
            raise AssertionError(f"load test {tag}: {counts[0]} GN launches")
        log(f"[loadtest] {tag}: {res['requests']} requests from "
            f"{res['concurrency']} closed-loop clients in {res['wall_s']} s: "
            f"{res['requests_per_s']} requests/s, p50 "
            f"{res['latency_ms_p50']} ms, p90 {res['latency_ms_p90']} ms, p99 "
            f"{res['latency_ms_p99']} ms; {res['device_batches']} device "
            f"batches, mean batch {res['mean_batch_size']}, bucket occupancy "
            f"{res['mean_bucket_occupancy']}; GN launches {counts[0]} over "
            f"{sum(forwards.values())} forwards {dict(sorted(forwards.items()))}"
            f"; {accept}, on {card}")
        out[tag] = res
    return out


def phase_sweep(tmp: Path, cfg_path: Path, pth: Path, tiled: Path) -> dict:
    """12e: ``run_sweep`` with phase 5's FPN ``best.pth`` on the config
    (bf16, batch 128, stride = tile, hann, GeoJSON, ``out_dir``) over two
    seeded numpy slides and phase 9's tiled TIFF as a ``TiffSlideSource``,
    a main path: GN launches 7 per tile batch, all cluster; each slide's
    files read back and its maps against a direct
    ``SlidingWindowInference.run`` on the same source; ``sharded=True``
    raises."""
    import collections

    from pdac_pathological_image_segmentation_tpu_torch import load_config
    from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
        parse_geojson,
        rasterize_shapes,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
        SyntheticSlideSource,
    )
    from pdac_pathological_image_segmentation_tpu_torch.data.tiffslide import (
        TiffSlide,
        TiffSlideSource,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        load_serving_state,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.sweep import (
        run_sweep,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
        GridTiler,
        SlidingWindowInference,
    )

    set_tf32(False)
    cfg = load_config(str(cfg_path))
    model, _ = load_serving_state(cfg, str(pth), device="cuda")
    batch = cfg.batch_size
    cohort = [SyntheticSlideSource(max(h, w), tile=TILE, seed=seed)
              .read_region(0, 0, h, w) for h, w, seed in SWEEP_SLIDES]
    out_dir = tmp / "sweep"
    with TiffSlide(str(tiled)) as slide:
        cohort.append(TiffSlideSource(slide, level=0, tile=TILE))
        sources = [GridTiler(s, tile=TILE, stride=TILE)
                   if isinstance(s, np.ndarray) else s for s in cohort]
        forwards: collections.Counter = collections.Counter()
        for s in sources:
            forwards[batch] += len(s) // batch
            if len(s) % batch:
                forwards[len(s) % batch] += 1
        # -- the main path: launches counted from here ...
        _gn_forward_counts(reset=True)
        t0 = time.perf_counter()
        recs = run_sweep(model, cohort, tile=TILE, stride=TILE,
                         batch_size=batch, blend="hann", geojson=True,
                         out_dir=str(out_dir))
        wall = time.perf_counter() - t0
        counts = _gn_forward_counts()
        # -- ... to here
        _check_forwards("sweep", counts, dict(forwards))
        rows = []
        for rec, source in zip(recs, sources):
            i = rec["slide"]
            shape = tuple(source.canvas_hw)
            prob = _check_prob_map(f"sweep slide {i}",
                                   out_dir / f"slide_{i:04d}_prob.npy", shape,
                                   np.float32)
            mask = np.load(out_dir / f"slide_{i:04d}_mask.npy")
            p, m = SlidingWindowInference(model, tile=TILE, batch_size=batch,
                                          blend="hann").run(source)
            d = float(np.abs(prob - p).max())
            agree = float((mask == m).mean())
            gj = out_dir / f"slide_{i:04d}_annotations.geojson"
            fc = json.loads(gj.read_text())
            back = rasterize_shapes(parse_geojson(fc), *shape)
            if rec["n_tiles"] != len(source) or mask.shape != shape \
                    or d > 5e-4 or agree < 0.999 \
                    or len(fc["features"]) != rec["n_regions"] \
                    or not np.array_equal(back.astype(bool),
                                          mask.astype(bool)):
                raise AssertionError(f"sweep slide {i}: {rec}, max |Δp| {d}, "
                                     f"masks {agree}")
            rows.append({"slide": i, "hw": shape, "windows": rec["n_tiles"],
                         "seconds": rec["seconds"],
                         "windows_per_s": rec["n_tiles"] / rec["seconds"],
                         "tumor_fraction": rec["tumor_fraction"],
                         "regions": rec["n_regions"]})
            log(f"[sweep] slide {i} ({shape[0]}x{shape[1]}, "
                f"{type(source).__name__}): {rec['n_tiles']} windows in "
                f"{rec['seconds']:.2f} s ({rows[-1]['windows_per_s']:.1f} "
                f"windows/s), tumor fraction {rec['tumor_fraction']:.6f}, "
                f"{rec['n_regions']} GeoJSON regions rasterized back equal "
                f"to the mask; vs a direct SlidingWindowInference.run max "
                f"|Δp| {d:.3g}, masks {agree:.6f} equal")
    try:
        run_sweep(model, [], sharded=True)
    except NotImplementedError as exc:
        if "4.5" not in str(exc):
            raise
    else:
        raise AssertionError("run_sweep(sharded=True) did not raise")
    log(f"[sweep] {len(recs)} slides in {wall:.2f} s; GN launches "
        f"{counts[0]} = 7 x {sum(forwards.values())} tile batches "
        f"{dict(forwards)}, all cluster; sharded=True raises naming ROADMAP "
        "Queue 1 item 4.5")
    return {"slides": rows, "seconds": wall, "by_variant": counts[2]}


def _seeded(model: str, backbone: str, seed: int) -> dict:
    from pdac_pathological_image_segmentation_tpu_torch import Config
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    return seeded_state_dict(build_model(Config(
        model=model, backbone=backbone, img_size=TILE)), seed=seed)


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
    t_start = _PHASE_CLOCK[0] = time.perf_counter()
    card = phase_environment()
    phase_done("1 environment")
    phase_build()
    phase_done("2 build")
    kernels = phase_kernels()
    phase_done("3 GN forward rows")
    kernels += phase_gn_backward_kernels()
    phase_done("3 GN backward rows")
    kernels += phase_augment_kernels()
    phase_done("3 augmentation rows")
    int8_rows = phase_int8_kernels()
    phase_done("3 int8 rows at batch 32")
    enc_tags = [_tag(m, b) for m, b in ENCODER_PATHS]
    b7_tag = _tag("fpn", B7)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        sd, serve_by_variant, _ = phase_serving(tmp, card)
        phase_done("4 serving fpn")
        sd_b7, serve_b7_by_variant, serve_b7 = phase_serving(tmp, card, B7)
        phase_done(f"4 serving {b7_tag}")
        unet = phase_unet_serving(tmp, card)
        phase_done("4b serving unet")
        served = {m: phase_model_serving(tmp, card, m) for m in NEW_MODELS}
        served[_tag("deeplabv3+", MNV2)] = phase_model_serving(
            tmp, card, "deeplabv3+", MNV2)
        served[b7_tag] = dict(serve_b7, sd=sd_b7)
        phase_done("4c serving the other models")
        phase_dilations_artifact(tmp)
        phase_data(tmp)
        phase_done("4c dilations artifact, 5 data")
        train = phase_training(tmp, "fpn", pretrained=True)
        train_unet = phase_training(tmp, "unet")
        train_new = {m: phase_training(tmp, m) for m in NEW_MODELS}
        train_new.update({_tag(m, b): phase_training(tmp, m, b,
                                                     pretrained=True)
                          for m, b in ENCODER_PATHS})
        phase_done("5 training")
        evaluation = phase_evaluation(tmp)
        phase_done("5c evaluation")
        steps = {m: phase_timed_step(card, m) for m in MODELS}
        steps.update({_tag(m, b): phase_timed_step(card, m, b)
                      for m, b in ENCODER_PATHS})
        phase_done("6 timed steps")
        dropout = phase_aspp_dropout()
        phase_done("6b ASPP dropout")
        for m in MODELS:
            phase_train_card_vs_cpu(m)
        log(f"[card-vs-cpu] {b7_tag}: the train step at {B7_CPU_TILE}², cut "
            f"from {TILE}² to keep its CPU runs short")
        phase_train_card_vs_cpu("fpn", B7, B7_CPU_TILE)
        phase_train_card_vs_cpu("deeplabv3+", MNV2)
        phase_done("7 train step card vs CPU")
        sds = {"fpn": sd, "unet": unet["sd"],
               **{m: served[m]["sd"] for m in NEW_MODELS + tuple(enc_tags)}}
        runs = ([(m, "resnet18") for m in MODELS] + list(ENCODER_PATHS)
                + [("pspnet", MNV2), ("unet++", "efficientnet-b0")])
        sds[_tag("pspnet", MNV2)] = _seeded("pspnet", MNV2, seed=13)
        sds[_tag("unet++", "efficientnet-b0")] = _seeded(
            "unet++", "efficientnet-b0", seed=14)
        for m, b in runs:
            phase_card_vs_cpu(sds[_tag(m, b)], m, b)
        phase_done("7 forward card vs CPU")
        for m, b in [(m, "resnet18") for m in MODELS] + list(ENCODER_PATHS):
            phase_bf16_vs_f32(sds[_tag(m, b)], m,
                              head="bfloat16" if m == "unet" else "float32",
                              backbone=b)
        phase_done("8 bf16 vs f32")
        # last: its long profiled run must not disturb the phases' profiles
        wsi = phase_wsi_cli(tmp, card)
        phase_done("9 cli.overlay")
        overlays = {"deeplabv3+": phase_model_overlay(tmp, "deeplabv3+"),
                    b7_tag: phase_model_overlay(tmp, "fpn", B7)}
        phase_done("9b cli.overlay, other models")
        wsi_timed = phase_wsi_timed(tmp, card)
        _add_counts(wsi, wsi_timed["by_variant"])
        phase_done("9 the 40,960² slide from the host")
        phase_wsi_card_vs_cpu(tmp)
        phase_done("9 slides card vs CPU")
        int8_serve = phase_int8_serving(tmp, card)
        phase_done("10 int8 serving")
        int8_models = phase_int8_models(tmp, card)
        phase_done("10 int8 models")
        int8_overlay = phase_int8_overlay(tmp)
        phase_done("10 cli.overlay --int8")
        stain = phase_stain_serving(tmp, card)
        phase_done("10 stain")
        wsi_device = {tag: phase_wsi_device(tmp, card, tag == "int8")
                      for tag in ("bf16", "int8")}
        phase_done("10 the 40,960² slide from the card")
        phase_class_data(tmp)
        options = phase_train_options(tmp, card, steps)
        phase_done("11 training options")
        synth_dir, synth = phase_synthetic_patches(tmp)
        phase_done("12a synthetic patches")
        decode = phase_decoder(synth_dir, steps["fpn"], card)
        phase_done("12b the decoder")
        decode["trainer_fed"] = phase_fed_trainer(tmp, synth_dir, card)
        phase_done("12b the trainer fed by its loader")
        wsi_dir = tmp / "wsi"
        extracted = phase_extract(tmp, wsi_dir / "slide_tiled.tiff",
                                  wsi_dir / "out_jpeg" / "annotations.geojson")
        phase_done("12c cli.extract")
        loadtests = phase_loadtest(tmp, card)
        phase_done("12d the load test")
        sweep = phase_sweep(tmp, wsi_dir / "overlay.yaml",
                            tmp / "train_fpn_out" / "pth" / "best.pth",
                            wsi_dir / "slide_tiled.tiff")
        phase_done("12e the sweep")
    train_runs = {"train": train, "train_unet": train_unet,
                  **{f"train_{m}": run for m, run in train_new.items()}}
    # the GN kernels' launches on each main path, by launch key
    gn_by_path = {
        "group_norm_relu": {
            "serve": serve_by_variant,
            "serve_int8": int8_serve["gn_by_variant"],
            "overlay_int8": int8_overlay["gn_by_variant"],
            "serve_stain": stain["gn_by_variant"],
            **{f"wsi_device_{t}": run["by_variant"]
               for t, run in wsi_device.items()},
            "train": train["gn_forward"][2],
            "eval": evaluation["by_variant"]["fpn"],
            "wsi": wsi,
            f"serve_{b7_tag}": serve_b7_by_variant,
            f"train_{b7_tag}": train_new[b7_tag]["gn_forward"][2],
            f"eval_{b7_tag}": evaluation["by_variant"][b7_tag],
            f"wsi_{b7_tag}": overlays[b7_tag]["by_variant"],
            **{p: run["gn_forward"][2]
               for p, run in options["paths"].items()},
            "loadtest_fpn": loadtests["by_variant"],
            "sweep": sweep["by_variant"]},
        "group_norm_relu_backward": {
            "train": train["gn_backward"][2],
            f"train_{b7_tag}": train_new[b7_tag]["gn_backward"][2],
            **{p: run["gn_backward"][2]
               for p, run in options["paths"].items()}}}
    kernels += phase_gn_launched(kernels, gn_by_path)
    phase_done("3 GN rows at the paths' other keys")
    # one augmentation row per launch key takes the key's launches: the one
    # on the trainer's own draws where a key has two
    aug_rows = {}
    for row in kernels:
        if row["name"] == "fused_train_transform":
            key = (row["shape"][0], row["shape"][1])
            if key not in aug_rows or row["tables"] == "trainer":
                aug_rows[key] = row
    for row in kernels:
        # launches on the main paths, by variant and shape: 0 for rows off
        # them
        if row["name"] == "fused_train_transform":
            key = (row["shape"][0], row["shape"][1])
            paths = {path: run["augment"][1].get(key, 0)
                     if aug_rows[key] is row else 0
                     for path, run in {**train_runs,
                                       **options["paths"]}.items()}
        else:
            by_path = gn_by_path[row["name"]]
            paths = {p: by_variant.get(_gn_key(row), 0)
                     for p, by_variant in by_path.items()}
        row["launches"] = sum(paths.values())
        row["launches_by_path"] = paths
    int8_paths = {"serve_int8": int8_serve["by_shape"],
                  "overlay_int8": int8_overlay["by_shape"],
                  "wsi_device_int8": wsi_device["int8"]["by_shape"],
                  **{f"{m}_int8": r["by_shape"]
                     for m, r in int8_models.items()}}
    for path, by_shape in int8_paths.items():
        if not sum(by_shape.values()):
            raise AssertionError(f"int8_conv was not launched on the {path} "
                                 "path")
    int8_rows += phase_int8_launched(int8_paths, int8_rows)
    phase_done("10 int8 rows at the paths' other keys")
    quantize_rows = phase_quantize_rows(
        {"serve_int8": int8_serve["quantize_by_shape"],
         "overlay_int8": int8_overlay["quantize_by_shape"],
         "wsi_device_int8": wsi_device["int8"]["quantize_by_shape"],
         **{f"{m}_int8": r["quantize_by_shape"]
            for m, r in int8_models.items()}})
    phase_done("10 quantize rows")
    for row in int8_rows:
        # launches on the int8 main paths under the row's key (one key, one
        # row)
        key = tuple(row["key"])
        row["launches_by_path"] = {p: by_shape.get(key, 0)
                                   for p, by_shape in int8_paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    for path in int8_paths:
        on = [(r["launches_by_path"][path], r) for r in int8_rows
              if r["launches_by_path"][path]]
        before = sum(k * r["mma_sync_ms"] for k, r in on
                     if r["mma_sync_ms"] is not None)
        log(f"[int8-kernel] {path}: {sum(k for k, _ in on)} launches at "
            f"{len(on)} keys; kernel {sum(k * r['ms'] for k, r in on):.3f} ms"
            f" in all (the mma.sync design {before:.3f} ms at the "
            f"{sum(1 for _, r in on if r['mma_sync_ms'] is not None)} keys "
            f"it had) against a bound of "
            f"{sum(k * r['bound_ms'] for k, r in on):.3f} ms")
    batch32 = [r for r in int8_rows if r["key"][0] == INT8_BATCH]
    log(f"[int8-kernel] the {len(batch32)} batch-{INT8_BATCH} keys: kernel "
        f"{sum(r['ms'] for r in batch32):.3f} ms (the mma.sync design "
        f"{sum(r['mma_sync_ms'] or 0.0 for r in batch32):.3f} ms), bound "
        f"{sum(r['bound_ms'] for r in batch32):.3f} ms")
    # the mma.sync design's times are PR 10's, logged above and not
    # readings of this run: they stay out of the kernels line
    kernels += [{k: v for k, v in r.items() if k != "mma_sync_ms"}
                for r in int8_rows] + quantize_rows
    # each kernel of the paths ran on them, and on each new path
    gn_paths = ("serve", "eval", "wsi", f"serve_{b7_tag}", f"eval_{b7_tag}",
                f"wsi_{b7_tag}", "serve_int8", "overlay_int8", "serve_stain",
                "wsi_device_bf16", "wsi_device_int8", "loadtest_fpn",
                "sweep")
    fused_paths = list(train_runs) + ["train_unet++_3class_dice_ce",
                                      f"train_fpn_{B7}_remat_accum4"]
    gn_train_paths = ["train", f"train_{b7_tag}", "train_fpn_nonfused",
                      "train_fpn_parity", f"train_fpn_{B7}_remat_accum4"]
    for name, path in ([("fused_train_transform", p) for p in fused_paths]
                       + [("group_norm_relu", p) for p in gn_paths]
                       + [(k, p) for p in gn_train_paths
                          for k in ("group_norm_relu",
                                    "group_norm_relu_backward")]):
        if not sum(r["launches_by_path"][path] for r in kernels
                   if r["name"] == name
                   and r.get("variant", "cluster") == "cluster"):
            raise AssertionError(f"{name} was not launched on the {path} "
                                 "path")
    # the non-fused paths: no augmentation kernel at all
    for path in ("train_unet_3class_macenko", "train_fpn_nonfused",
                 "train_fpn_parity"):
        if sum(r["launches_by_path"][path] for r in kernels
               if r["name"] == "fused_train_transform"):
            raise AssertionError(f"the augmentation kernel ran on {path}")
    print(json.dumps({"models": {
        m: {"serving": {k: v for k, v in served[m].items() if k != "sd"},
            "step": steps[m], "test_score": evaluation["scores"][m]}
        for m in NEW_MODELS + tuple(enc_tags)},
        "steps": steps, "aspp_dropout": dropout,
        "overlays": {k: {f: v for f, v in o.items() if f != "by_variant"}
                     for k, o in overlays.items()},
        "int8": {"fpn_serving": {k: v for k, v in int8_serve.items()
                                 if k not in ("by_shape", "quantize_by_shape",
                                              "gn_by_variant")},
                 **{m: {k: v for k, v in r.items()
                        if k not in ("by_shape", "quantize_by_shape")}
                    for m, r in int8_models.items()},
                 "overlay_s": int8_overlay["seconds"]},
        "stain": {k: v for k, v in stain.items() if k != "gn_by_variant"},
        "train_options": {k: v for k, v in options.items() if k != "paths"},
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"tools": {
        "synthetic_patches": synth, "decode": decode, "extract": extracted,
        "loadtest": {k: v for k, v in loadtests.items()
                     if k != "by_variant"},
        "sweep": {k: v for k, v in sweep.items() if k != "by_variant"}}}),
        flush=True)
    print(json.dumps({"wsi_host": wsi_timed["summary"],
                      "wsi_40k_device": {t: r["summary"] for t, r
                                         in wsi_device.items()}}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sweep the cluster size K and the threads per block of the port's cluster
GroupNorm kernels (``csrc/group_norm_relu.cu``) on one NVIDIA GPU.

    python3 scripts/torch_gn_cluster_sweep.py

At the FPN@512 sites that carry most of the GN time (C=128, G=32, bf16,
H=W in 64 and 128, N in 32 and 128), each (K, threads) that fits one
block's shared memory is held against the plain version and timed by
CUDA events (median of five windows of 20 back-to-back calls), beside the
streaming design and one elementwise PyTorch call that moves the same
bytes.  The row the launch plan (``ops/group_norm.py::group_norm_plan``)
takes is marked ``*``.  Needs a card: without one it exits 2.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pdac_pathological_image_segmentation_tpu_torch.ops import (  # noqa: E402
    group_norm as gn,
)

GROUPS, C = 32, 128
SHAPES = [(32, 64), (32, 128), (128, 64), (128, 128)]


def cuda_ms(fn, warmup: int = 5, iters: int = 20, windows: int = 5) -> float:
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


def configs(x: torch.Tensor, tensors: int):
    """Every (K, threads) whose block fits one block's shared memory."""
    n, c, h, w = x.shape
    share_bytes = (c // GROUPS) * h * w * x.element_size()
    for k in gn.CLUSTER_SIZES:
        for threads in (64, 128, 256):
            smem = gn.cluster_smem(share_bytes // k, c // GROUPS, threads,
                                   tensors)
            if share_bytes // k <= 8 * 16384 and smem <= gn.SMEM_LIMIT:
                yield gn.GNPlan("cluster", 8, k, threads, smem)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, hw in SHAPES:
        shape = (n, C, hw, hw)
        x = (torch.randn(shape, device="cuda", generator=gen) * 2.0
             + 0.5).bfloat16()
        dy = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        gamma = torch.rand(C, device="cuda", generator=gen) + 0.5
        beta = torch.randn(C, device="cuda", generator=gen) * 0.1
        stats = torch.empty(n, GROUPS, 2, device="cuda")
        out = gn.group_norm_relu(x, gamma, beta, GROUPS, 1e-5, True,
                                 stats=stats)
        ref_y = gn.group_norm_relu_reference(x, gamma, beta, GROUPS).float()
        ref_dx = gn.group_norm_relu_backward_reference(
            dy, x, gamma, out, stats, GROUPS)[0].float()
        sink = torch.empty_like(x)
        args = (n, C, hw * hw, GROUPS, 2, True, sm_count)
        for tensors, name in ((1, "forward"), (2, "backward")):
            plan = gn.group_norm_plan(*args, tensors=tensors)
            splan = gn.streaming_plan(*args)
            if tensors == 1:
                def run(p, launch):
                    return launch(x, gamma, beta, GROUPS, 1e-5, True, None,
                                  p)

                def close(y):
                    return torch.allclose(y.float(), ref_y, rtol=2 ** -7,
                                          atol=1e-5)

                launchers = (gn._forward_cluster, gn._forward_streaming)
                same_bytes = cuda_ms(lambda: sink.copy_(x))
            else:
                def run(p, launch):
                    return launch(dy, x, gamma, out, stats, GROUPS, True, p)[0]

                def close(d):
                    return torch.allclose(
                        d.float(), ref_dx, rtol=2 ** -7,
                        atol=1e-3 * float(ref_dx.abs().max()))

                launchers = (gn._backward_cluster, gn._backward_streaming)
                same_bytes = cuda_ms(
                    lambda: torch.addcmul(dy, x, out, out=sink))
            streaming = cuda_ms(lambda: run(splan, launchers[1]))
            print(f"{name} {shape} bf16: streaming {streaming:.4f} ms, "
                  f"same bytes by one elementwise call {same_bytes:.4f} ms")
            for p in configs(x, tensors):
                ok = close(run(p, launchers[0]))
                ms = cuda_ms(lambda: run(p, launchers[0]))
                mark = "*" if (p.cluster, p.threads) == (
                    plan.cluster, plan.threads) else " "
                print(f"  {mark} K={p.cluster} threads={p.threads:3d} smem "
                      f"{p.smem:6d}: {ms:.4f} ms, clusters/card "
                      f"{gn.cluster_occupancy(x, GROUPS, p, tensors == 2)}"
                      f"{'' if ok else ', DISAGREES'}", flush=True)
                if not ok:
                    return 1
        del x, dy, out, sink, ref_y, ref_dx
    return 0


if __name__ == "__main__":
    sys.exit(main())

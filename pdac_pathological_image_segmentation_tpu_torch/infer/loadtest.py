"""Closed-loop load test for the HTTP serving daemon (the JAX package's
``infer/loadtest.py``).

It drives :class:`~pdac_pathological_image_segmentation_tpu_torch.infer.server.SegmentationServer`
with N concurrent keep-alive clients in a closed loop (each client fires
its next request the moment the previous response lands) and reports:

* client-side latency percentiles (p50/p90/p99) per request,
* aggregate throughput (requests/s = tiles/s at tile granularity),
* the server's own dispatch stats (batches, mean bucket occupancy) from
  ``GET /v1/stats``, as differences over the run.

Payloads are raw uint8 tiles (``application/octet-stream`` both ways): the
point is to measure the batching and dispatch path, not the host's PNG
codec.  The result's keys and rounding are the JAX function's, so the two
readings line up.  Departures from the JAX module: ``serve_and_loadtest``
takes no ``aot`` (the port's daemon always runs one warm-up batch per
bucket before it serves), and the warm-up client dials ``host`` (the JAX
one dials ``127.0.0.1`` whatever ``host`` is).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Optional, Sequence

import numpy as np


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(len(sorted_vals) * q))
    return sorted_vals[idx]


class _Client(threading.Thread):
    """One closed-loop client on a persistent HTTP/1.1 connection."""

    def __init__(self, host: str, port: int, tiles: np.ndarray,
                 n_requests: int, start_evt: threading.Event,
                 accept: str = "application/octet-stream") -> None:
        super().__init__(daemon=True)
        self.host, self.port = host, port
        self.tiles = tiles
        self.n_requests = n_requests
        self.start_evt = start_evt
        self.accept = accept
        self.latencies: list = []
        self.errors = 0

    def run(self) -> None:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=120)
        headers = {
            "Content-Type": "application/octet-stream",
            "Accept": self.accept,
        }
        self.start_evt.wait()
        for i in range(self.n_requests):
            tile = self.tiles[i % len(self.tiles)]
            h, w, _ = tile.shape
            hdrs = dict(headers)
            hdrs["X-Image-Shape"] = f"{h},{w},3"
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/v1/segment", body=tile.tobytes(),
                             headers=hdrs)
                resp = conn.getresponse()
                resp.read()
                if resp.status != 200:
                    self.errors += 1
                else:
                    self.latencies.append(time.perf_counter() - t0)
            except Exception:
                self.errors += 1
                conn.close()
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=120)
        conn.close()


def fetch_stats(host: str, port: int) -> dict:
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def run_loadtest(host: str, port: int, *, tile: int, concurrency: int,
                 n_requests: int, seed: int = 0,
                 warmup_requests: Optional[int] = None,
                 accept: str = "application/octet-stream") -> dict:
    """Fire ``n_requests`` total across ``concurrency`` closed-loop
    clients at a running server; return latency/throughput/stats.

    ``accept``: response representation — the default raw float32, or
    ``"application/octet-stream;repr=u8"`` for the 4x-smaller uint8
    probabilities (the response-bytes lever on thin hosts)."""
    rng = np.random.default_rng(seed)
    # a small pool of distinct tiles so responses aren't byte-identical
    tiles = rng.integers(0, 256, (4, tile, tile, 3), dtype=np.uint8)

    warmup = (max(concurrency, 8)
              if warmup_requests is None else warmup_requests)
    if warmup:
        evt = threading.Event()
        w = _Client(host, port, tiles, warmup, evt, accept=accept)
        w.start()
        evt.set()
        w.join()

    per_client = max(1, n_requests // concurrency)
    start_evt = threading.Event()
    clients = [
        _Client(host, port, tiles, per_client, start_evt, accept=accept)
        for _ in range(concurrency)
    ]
    for c in clients:
        c.start()
    stats_before = fetch_stats(host, port)
    t0 = time.perf_counter()
    start_evt.set()
    for c in clients:
        c.join()
    wall = time.perf_counter() - t0
    stats_after = fetch_stats(host, port)

    lats = sorted(lat for c in clients for lat in c.latencies)
    errors = sum(c.errors for c in clients)
    done = len(lats)
    batches = stats_after.get("batches", 0) - stats_before.get("batches", 0)
    tiles_disp = (stats_after.get("batched_tiles", 0)
                  - stats_before.get("batched_tiles", 0))
    return {
        "concurrency": concurrency,
        "requests": done,
        "errors": errors,
        "wall_s": round(wall, 3),
        "requests_per_s": round(done / wall, 1) if wall > 0 else 0.0,
        "latency_ms_p50": round(1e3 * _percentile(lats, 0.50), 2),
        "latency_ms_p90": round(1e3 * _percentile(lats, 0.90), 2),
        "latency_ms_p99": round(1e3 * _percentile(lats, 0.99), 2),
        "device_batches": batches,
        "mean_batch_size": round(done / batches, 2) if batches else None,
        "mean_bucket_occupancy": (
            round(done / tiles_disp, 3) if tiles_disp else None),
    }


def serve_and_loadtest(artifact, *, buckets: Sequence[int] = (1, 8, 32),
                       max_wait_ms: float = 5.0, concurrency: int = 32,
                       n_requests: int = 640, seed: int = 0,
                       accept: str = "application/octet-stream") -> dict:
    """Start an in-process server on an ephemeral loopback port around
    ``artifact`` (a loaded ``ServingArtifact``, on its own device), run one
    load test against it, shut it down, and return the merged result."""
    from pdac_pathological_image_segmentation_tpu_torch.infer.server import (
        SegmentationServer,
    )

    server = SegmentationServer(
        ("127.0.0.1", 0), artifact, buckets=buckets,
        max_wait_ms=max_wait_ms)
    port = server.server_address[1]
    server.start(warmup=True)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    try:
        result = run_loadtest(
            "127.0.0.1", port, tile=artifact.tile,
            concurrency=concurrency, n_requests=n_requests, seed=seed,
            accept=accept)
    finally:
        server.shutdown()
        srv_thread.join(timeout=10)
        server.server_close()
    result["buckets"] = list(buckets)
    result["max_wait_ms"] = max_wait_ms
    result["accept"] = accept
    return result

"""HTTP serving of a port artifact (the JAX package's ``infer/server.py``,
with the same endpoints, headers and error codes).

* **fixed batch buckets** (default 1/8/32): every device batch is padded
  to the smallest bucket that covers it, and each bucket is run once on
  zeros at startup.
* **dynamic micro-batching**: handler threads enqueue requests; one
  dispatcher thread coalesces them (up to the largest bucket or
  ``max_wait_ms``, whichever first) and makes one device call per batch.
* **single device thread**: every CUDA call happens on the dispatcher (and,
  before it starts, in the warm-up), never on a handler thread.

Endpoints: ``GET /healthz``, ``GET /v1/metadata``, ``GET /v1/stats``,
``POST /v1/segment`` (PNG/JPEG/TIFF body, or raw uint8 with
``X-Image-Shape``; the response is an 8-bit probability PNG, raw float32
under ``Accept: application/octet-stream``, or raw uint8 with
``;repr=u8`` — flagged back via ``X-Prob-Repr`` — always with
``X-Tumor-Fraction``; ``Accept: application/geo+json`` gets the polygons of
``probs >= threshold`` in tile-local pixels as a QuPath FeatureCollection).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    ServingArtifact,
)

DEFAULT_BUCKETS = (1, 8, 32)


class _Pending:
    """One queued request: the tile and a completion event."""

    __slots__ = ("image", "event", "result", "error", "enqueued_at")

    def __init__(self, image: np.ndarray) -> None:
        self.image = image
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.monotonic()


class MicroBatcher:
    """Coalesce concurrent single-tile requests into bucket-sized device
    batches.

    ``submit`` blocks the calling (handler) thread until its tile's
    probabilities are ready; the dispatcher thread owns every device call.
    Padding tiles are zeros and their outputs are dropped.
    """

    def __init__(self, artifact: ServingArtifact,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0) -> None:
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self.artifact = artifact
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >=1, got {self.buckets}")
        self.max_batch = self.buckets[-1]
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._fns: dict = {}
        self._queue: "queue.SimpleQueue[_Pending]" = queue.SimpleQueue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_tiles": 0,  # includes padding
            "errors": 0,
            "warmups": 0,
        }
        self._latencies: deque = deque(maxlen=1024)  # seconds, per request

    # -- lifecycle ---------------------------------------------------------

    def start(self, warmup: bool = True) -> None:
        """Start the dispatcher thread, which first runs one zero batch per
        bucket (with ``warmup``); returns once the warm-up is done and
        raises what it raised."""
        ready = threading.Event()
        failure: list = []

        def run() -> None:
            try:
                for b in self.buckets:
                    if warmup:
                        self._fns[b] = self.artifact.aot(b)
                        self._stats["warmups"] += 1
                    else:
                        self._fns[b] = self.artifact
            except Exception as exc:  # noqa: BLE001 — re-raised in start()
                failure.append(exc)
                return
            finally:
                ready.set()
            self._run()

        self._thread = threading.Thread(
            target=run, name="pdac-batcher", daemon=True)
        self._thread.start()
        ready.wait()
        if failure:
            self._thread.join()
            self._thread = None
            raise failure[0]

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # fail anything still queued so handler threads don't hang
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError("server shutting down")
            p.event.set()

    # -- request path ------------------------------------------------------

    def submit(self, image: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        """Block until ``image``'s probability map is computed."""
        if self._stop.is_set() or self._thread is None:
            raise RuntimeError("batcher is not running")
        tile = self.artifact.tile
        if image.shape != (tile, tile, 3) or image.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 ({tile}, {tile}, 3) tile, got "
                f"{image.dtype} {image.shape}")
        p = _Pending(image)
        self._queue.put(p)
        # close the shutdown race: if stop() drained the queue between the
        # is_set() check and the put, nobody will serve this entry
        if self._stop.is_set() and not p.event.is_set():
            p.error = RuntimeError("server shutting down")
            p.event.set()
        if not p.event.wait(timeout):
            raise TimeoutError(f"inference not completed in {timeout}s")
        if p.error is not None:
            raise p.error
        with self._lock:
            self._stats["requests"] += 1
            self._latencies.append(time.monotonic() - p.enqueued_at)
        assert p.result is not None
        return p.result

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            lats = sorted(self._latencies)
        out["buckets"] = list(self.buckets)
        out["int8"] = bool(self.artifact.meta.get("int8"))
        if out["batches"]:
            out["mean_batch_occupancy"] = (
                out["requests"] / out["batched_tiles"]
                if out["batched_tiles"] else 0.0)
        if lats:
            out["latency_ms_p50"] = 1000.0 * lats[len(lats) // 2]
            out["latency_ms_p99"] = 1000.0 * lats[
                min(len(lats) - 1, int(len(lats) * 0.99))]
        return out

    # -- dispatcher --------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._dispatch(batch)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _dispatch(self, batch: list) -> None:
        bucket = self._bucket_for(len(batch))
        tile = self.artifact.tile
        arr = np.zeros((bucket, tile, tile, 3), np.uint8)
        for i, p in enumerate(batch[:bucket]):
            arr[i] = p.image
        try:
            probs = np.asarray(self._fns[bucket](arr), np.float32)
            for i, p in enumerate(batch[:bucket]):
                p.result = probs[i]
                p.event.set()
            with self._lock:
                self._stats["batches"] += 1
                self._stats["batched_tiles"] += bucket
        except Exception as exc:  # noqa: BLE001 — surfaced per request
            with self._lock:
                self._stats["errors"] += 1
            for p in batch[:bucket]:
                p.error = exc
                p.event.set()
        for p in batch[bucket:]:
            p.error = RuntimeError("batch overflow — check bucket config")
            p.event.set()


def _decode_body(body: bytes, content_type: str, shape_header: str,
                 tile: int) -> np.ndarray:
    """Request body → uint8 (tile, tile, 3), resized host-side if the image
    is another size."""
    content_type = (content_type or "").split(";")[0].strip().lower()
    if content_type in ("image/png", "image/jpeg", "image/tiff"):
        from PIL import Image

        img = Image.open(io.BytesIO(body)).convert("RGB")
        if img.size != (tile, tile):
            img = img.resize((tile, tile), Image.BILINEAR)
        return np.asarray(img, np.uint8)
    if content_type == "application/octet-stream":
        if not shape_header:
            raise ValueError("raw body needs X-Image-Shape: H,W,3")
        try:
            h, w, c = (int(v) for v in shape_header.split(","))
        except ValueError as exc:
            raise ValueError(
                f"bad X-Image-Shape {shape_header!r} (want H,W,3)") from exc
        if c != 3:
            raise ValueError("raw body must be 3-channel RGB")
        if len(body) != h * w * c:
            raise ValueError(
                f"body is {len(body)} bytes, shape says {h * w * c}")
        arr = np.frombuffer(body, np.uint8).reshape(h, w, 3)
        if (h, w) != (tile, tile):
            from PIL import Image

            arr = np.asarray(
                Image.fromarray(arr).resize((tile, tile), Image.BILINEAR),
                np.uint8)
        return arr
    raise TypeError(
        f"unsupported Content-Type {content_type!r} (send image/png, "
        f"image/jpeg, or application/octet-stream + X-Image-Shape)")


class _Handler(BaseHTTPRequestHandler):
    """Routes; the batcher and artifact hang off the server object."""

    server_version = "pdac-serve-torch/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        batcher = self.server.batcher
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "platform": batcher.artifact.device.type,
                "device": str(batcher.artifact.device),
                "model": batcher.artifact.meta.get("model"),
            })
        elif self.path == "/v1/metadata":
            self._send_json(200, {
                "artifact": batcher.artifact.meta,
                "buckets": list(batcher.buckets),
                "max_wait_ms": batcher.max_wait_s * 1000.0,
            })
        elif self.path == "/v1/stats":
            self._send_json(200, batcher.stats())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/v1/segment":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        srv = self.server
        accept = (self.headers.get("Accept") or "").lower()
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            image = _decode_body(
                body, self.headers.get("Content-Type", ""),
                self.headers.get("X-Image-Shape", ""),
                srv.batcher.artifact.tile)
        except TypeError as exc:
            self._send_json(415, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — client error
            self._send_json(400, {"error": str(exc)})
            return
        try:
            probs = srv.batcher.submit(image)
        except Exception as exc:  # noqa: BLE001 — inference failure
            self._send_json(503, {"error": str(exc)})
            return

        tumor_fraction = float((probs >= srv.threshold).mean())
        if "application/octet-stream" in accept:
            if "repr=u8" in accept:
                payload = np.round(probs * 255.0).clip(0, 255).astype(
                    np.uint8).tobytes()
            else:
                payload = probs.astype(np.float32).tobytes()
            ctype = "application/octet-stream"
        elif "geo+json" in accept:
            # QuPath-importable annotation polygons in tile-local pixel
            # coordinates (exact pixel-boundary tracing, data/geojson.py)
            from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
                mask_to_polygons,
                polygons_to_geojson,
            )

            fc = polygons_to_geojson(
                mask_to_polygons(probs >= srv.threshold),
                measurements={"tumor_fraction": tumor_fraction})
            payload = json.dumps(fc).encode()
            ctype = "application/geo+json"
        else:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(
                np.round(probs * 255.0).clip(0, 255).astype(np.uint8),
                mode="L").save(buf, format="PNG")
            payload = buf.getvalue()
            ctype = "image/png"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        if ctype == "application/octet-stream":
            self.send_header("X-Prob-Repr",
                             "u8" if "repr=u8" in accept else "f32")
        self.send_header("X-Prob-Shape",
                         ",".join(str(s) for s in probs.shape))
        self.send_header("X-Tumor-Fraction", f"{tumor_fraction:.6f}")
        self.end_headers()
        self.wfile.write(payload)


class SegmentationServer(ThreadingHTTPServer):
    """HTTP server + micro-batcher around one serving artifact."""

    daemon_threads = True
    # absorb a connect burst (socketserver's default backlog is 5)
    request_queue_size = 128

    def __init__(self, addr, artifact: ServingArtifact, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, threshold: float = 0.5,
                 verbose: bool = False) -> None:
        super().__init__(addr, _Handler)
        self.batcher = MicroBatcher(artifact, buckets=buckets,
                                    max_wait_ms=max_wait_ms)
        self.threshold = float(threshold)
        self.verbose = verbose

    def start(self, warmup: bool = True) -> None:
        self.batcher.start(warmup=warmup)

    def shutdown(self) -> None:  # noqa: A003
        super().shutdown()
        self.batcher.stop()

"""The port's closed-loop load test (``infer/loadtest.py``) on a CPU
artifact at 64², the JAX file's two cases: micro-batched (no errors,
ordered positive percentiles, more than one tile a device batch, bucket
occupancy in (0, 1]) and single dispatch (batches == requests); the
result has the JAX function's keys; ``_percentile`` equals the JAX one on
seeded lists."""

import numpy as np
import pytest

from pdac_pathological_image_segmentation_tpu.infer import (
    loadtest as jax_loadtest,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.infer import loadtest
from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    export_serving_artifact,
    load_serving_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)

TILE = 64
KEYS = {"concurrency", "requests", "errors", "wall_s", "requests_per_s",
        "latency_ms_p50", "latency_ms_p90", "latency_ms_p99",
        "device_batches", "mean_batch_size", "mean_bucket_occupancy",
        "buckets", "max_wait_ms", "accept"}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = Config(model="unet", backbone="resnet18", img_size=TILE,
                 compute_dtype="float32")
    path = str(tmp_path_factory.mktemp("lt") / "model.pdacpt")
    export_serving_artifact(
        cfg, seeded_state_dict(build_model(cfg), seed=3), path)
    return load_serving_artifact(path, device="cpu")


def test_loadtest_micro_batched(artifact):
    res = loadtest.serve_and_loadtest(
        artifact, buckets=(1, 4), max_wait_ms=20.0, concurrency=4,
        n_requests=24)
    assert set(res) == KEYS
    assert res["errors"] == 0
    assert res["requests"] == 24
    assert res["requests_per_s"] > 0
    assert 0 < res["latency_ms_p50"] <= res["latency_ms_p90"]
    assert res["latency_ms_p90"] <= res["latency_ms_p99"]
    # the server's own counters, as differences over the run
    assert res["device_batches"] >= 1
    assert res["mean_batch_size"] >= 1.0
    assert 0 < res["mean_bucket_occupancy"] <= 1.0
    # 4 closed-loop clients and a 20 ms window: at least one dispatch
    # coalesced more than one tile
    assert res["mean_batch_size"] > 1.0
    assert res["buckets"] == [1, 4] and res["max_wait_ms"] == 20.0


def test_loadtest_single_dispatch(artifact):
    """No micro-batching: every request is its own batch of 1."""
    res = loadtest.serve_and_loadtest(
        artifact, buckets=(1,), max_wait_ms=0.0, concurrency=2,
        n_requests=10, accept="application/octet-stream;repr=u8")
    assert res["errors"] == 0 and res["requests"] == 10
    assert res["device_batches"] == res["requests"]
    assert res["mean_batch_size"] == 1.0
    assert res["mean_bucket_occupancy"] == 1.0
    assert res["accept"] == "application/octet-stream;repr=u8"


def test_serve_and_loadtest_takes_no_aot(artifact):
    with pytest.raises(TypeError, match="aot"):
        loadtest.serve_and_loadtest(artifact, aot=True)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 641])
def test_percentile_equals_jax(n):
    vals = sorted(np.random.default_rng(n).exponential(3.0, n).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        got, want = loadtest._percentile(vals, q), jax_loadtest._percentile(
            vals, q)
        assert got == want or (np.isnan(got) and np.isnan(want))

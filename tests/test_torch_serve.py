"""Serving of the PyTorch port (``infer/export.py``, ``infer/server.py``,
``cli/export.py``) on the CPU.

Pinned here, as ``tests/test_server.py`` pins the JAX daemon: the raw
float32 response is bit-equal to the direct artifact call, concurrent
requests coalesce into shared bucket batches, resize-on-ingest, the
error surface (415/400/404), and the ``Accept: application/geo+json``
response, equal to the JAX ``polygons_to_geojson`` of the same
probabilities.  Across packages: the port server and the JAX server
answer the same tile, from the same weights, within ``atol=5e-4``, and
each package's loader refuses the other's artifact.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.infer.export import (
    export_serving_artifact as jax_export_serving_artifact,
    load_serving_artifact as jax_load_serving_artifact,
)
from pdac_pathological_image_segmentation_tpu.infer.server import (
    SegmentationServer as JaxSegmentationServer,
)
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    export as cli_export,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    MAGIC,
    export_serving_artifact,
    load_serving_artifact,
    read_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.server import (
    MicroBatcher,
    SegmentationServer,
    _decode_body,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
)

TILE = 64
RAW = {"Content-Type": "application/octet-stream",
       "X-Image-Shape": f"{TILE},{TILE},3"}


def _cfg():
    return Config(model="fpn", backbone="resnet18", img_size=TILE,
                  compute_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(build_model(_cfg()), seed=9)


@pytest.fixture(scope="module")
def artifact_path(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "model.pdacpt")
    export_serving_artifact(_cfg(), weights, path)
    return path


@pytest.fixture(scope="module")
def artifact(artifact_path):
    return load_serving_artifact(artifact_path, device="cpu")


def _serve(srv):
    srv.start(warmup=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


@pytest.fixture(scope="module")
def server(artifact):
    srv = _serve(SegmentationServer(("127.0.0.1", 0), artifact,
                                    buckets=(1, 4), max_wait_ms=20.0))
    yield srv
    srv.shutdown()


def _url(server, path):
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(server, body, headers, path="/v1/segment"):
    req = urllib.request.Request(_url(server, path), data=body,
                                 headers=headers, method="POST")
    return urllib.request.urlopen(req, timeout=60)


def _raw_probs(resp):
    shape = tuple(int(v) for v in resp.headers["X-Prob-Shape"].split(","))
    return np.frombuffer(resp.read(), np.float32).reshape(shape)


def test_healthz_and_metadata(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "platform": "cpu", "device": "cpu",
                      "model": "fpn"}
    with urllib.request.urlopen(_url(server, "/v1/metadata"),
                                timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["artifact"]["tile"] == TILE
    assert meta["artifact"]["compute_dtype"] == "float32"
    assert meta["buckets"] == [1, 4]


def test_raw_roundtrip_bit_equal_to_artifact(server, artifact):
    img = np.random.default_rng(0).integers(0, 256, (TILE, TILE, 3),
                                            dtype=np.uint8)
    resp = _post(server, img.tobytes(),
                 {**RAW, "Accept": "application/octet-stream"})
    assert resp.headers["X-Prob-Repr"] == "f32"
    probs = _raw_probs(resp)
    direct = artifact(img[None])[0]
    assert direct.dtype == np.float32
    np.testing.assert_array_equal(probs, direct)
    frac = float(resp.headers["X-Tumor-Fraction"])
    assert frac == pytest.approx(float((direct >= 0.5).mean()), abs=1e-5)


def test_png_roundtrip(server, artifact):
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 256, (TILE, TILE, 3),
                                            dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    resp = _post(server, buf.getvalue(), {"Content-Type": "image/png"})
    assert resp.headers["Content-Type"] == "image/png"
    mask = np.asarray(Image.open(io.BytesIO(resp.read())))
    direct = artifact(img[None])[0]
    np.testing.assert_array_equal(
        mask, np.round(direct * 255.0).clip(0, 255).astype(np.uint8))


def test_resize_on_ingest(server, artifact):
    from PIL import Image

    big = np.random.default_rng(2).integers(0, 256, (2 * TILE, 2 * TILE, 3),
                                            dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(big).save(buf, format="PNG")
    resp = _post(server, buf.getvalue(), {
        "Content-Type": "image/png", "Accept": "application/octet-stream"})
    probs = _raw_probs(resp)
    assert probs.shape == (TILE, TILE)
    small = np.asarray(
        Image.fromarray(big).resize((TILE, TILE), Image.BILINEAR), np.uint8)
    np.testing.assert_allclose(probs, artifact(small[None])[0], atol=1e-6,
                               rtol=0)


def test_u8_response_repr(server, artifact):
    img = np.random.default_rng(3).integers(0, 256, (TILE, TILE, 3),
                                            dtype=np.uint8)
    resp = _post(server, img.tobytes(),
                 {**RAW, "Accept": "application/octet-stream;repr=u8"})
    assert resp.headers["X-Prob-Repr"] == "u8"
    u8 = np.frombuffer(resp.read(), np.uint8).reshape(TILE, TILE)
    direct = artifact(img[None])[0]
    np.testing.assert_array_equal(
        u8, np.round(direct * 255.0).clip(0, 255).astype(np.uint8))


def test_concurrent_requests_coalesce(server, artifact):
    """8 parallel clients over buckets (1, 4) finish in >=2 but <8 device
    batches."""
    before = server.batcher.stats()
    imgs = np.random.default_rng(4).integers(0, 256, (8, TILE, TILE, 3),
                                             dtype=np.uint8)
    results = [None] * 8
    errors = []

    def hit(i):
        try:
            resp = _post(server, imgs[i].tobytes(),
                         {**RAW, "Accept": "application/octet-stream"})
            results[i] = _raw_probs(resp)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    direct = artifact(imgs)
    for i in range(8):
        np.testing.assert_allclose(results[i], direct[i], atol=1e-6, rtol=0)
    n_batches = server.batcher.stats()["batches"] - before["batches"]
    assert 2 <= n_batches < 8, f"expected coalescing, got {n_batches} batches"


def test_error_surface(server):
    cases = [
        (b"bytes", {"Content-Type": "text/plain"}, "/v1/segment", 415),
        (b"short", RAW, "/v1/segment", 400),
        (b"x", {"Content-Type": "image/png"}, "/nope", 404),
        (b"not a png", {"Content-Type": "image/png"}, "/v1/segment", 400),
    ]
    for body, headers, path, code in cases:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, body, headers, path=path)
        assert e.value.code == code, (path, headers)


def test_geojson_response_matches_jax_polygons(server, artifact):
    """The polygons of ``probs >= threshold`` in tile-local pixels, with
    ``tumor_fraction`` in the measurements and ``X-Tumor-Fraction`` as on
    every response: equal to the JAX package's ``polygons_to_geojson`` of
    the direct call's probabilities."""
    from pdac_pathological_image_segmentation_tpu.data.geojson import (
        mask_to_polygons as jax_mask_to_polygons,
        polygons_to_geojson as jax_polygons_to_geojson,
    )

    img = np.random.default_rng(17).integers(0, 256, (TILE, TILE, 3),
                                             dtype=np.uint8)
    with _post(server, img.tobytes(),
               {**RAW, "Accept": "application/geo+json"}) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "application/geo+json"
        frac = float(resp.headers["X-Tumor-Fraction"])
        got = json.loads(resp.read())
    probs = artifact(img[None])[0]
    mask = probs >= server.threshold
    assert 0.0 < mask.mean() < 1.0
    assert frac == pytest.approx(float(mask.mean()), abs=1e-6)
    want = jax_polygons_to_geojson(
        jax_mask_to_polygons(mask),
        measurements={"tumor_fraction": float(mask.mean())})
    assert got["type"] == "FeatureCollection" and got["features"]
    for f in got["features"] + want["features"]:
        f.pop("id")  # a fresh uuid per feature
    assert got == json.loads(json.dumps(want))


def test_stats_shape(server):
    with urllib.request.urlopen(_url(server, "/v1/stats"), timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["batches"] >= 1
    assert stats["warmups"] == 2
    assert "latency_ms_p50" in stats


def test_decode_body_validation():
    with pytest.raises(ValueError, match="X-Image-Shape"):
        _decode_body(b"", "application/octet-stream", "", TILE)
    with pytest.raises(ValueError, match="3-channel"):
        _decode_body(b"\0" * 64, "application/octet-stream", "4,4,4", TILE)
    with pytest.raises(TypeError, match="unsupported"):
        _decode_body(b"", "video/mp4", "", TILE)


def test_batcher_rejects_bad_tile_and_needs_start(artifact):
    b = MicroBatcher(artifact, buckets=(1,))
    with pytest.raises(RuntimeError, match="not running"):
        b.submit(np.zeros((TILE, TILE, 3), np.uint8))
    b.start(warmup=False)
    try:
        with pytest.raises(ValueError, match="expected uint8"):
            b.submit(np.zeros((TILE, TILE), np.uint8))
    finally:
        b.stop()
    assert not b._thread.is_alive()


def test_cli_export_matches_direct_export(weights, artifact, tmp_path):
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(
        {"model": "fpn", "backbone": "resnet18", "img_size": TILE,
         "compute_dtype": "float32"}))
    pth = tmp_path / "best.pth"
    torch.save({"model": {f"module.{k}": v for k, v in weights.items()}},
               pth)
    out = tmp_path / "cli.pdacpt"
    res = cli_export.main(["--config", str(cfg_path), "--pth_path", str(pth),
                           "--out", str(out)])
    assert res["bytes"] == out.stat().st_size
    again = load_serving_artifact(str(out), device="cpu")
    assert again.meta == artifact.meta
    img = np.random.default_rng(5).integers(0, 256, (2, TILE, TILE, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(again(img), artifact(img))


@pytest.mark.parametrize("flag", [["--batch", "8"],
                                  ["--platforms", "cuda"],
                                  ["--calib_path", "patches"]])
def test_cli_export_refuses_flags_it_cannot_honour(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_export.main(["--config", "cfg.yaml", "--pth_path", "best.pth",
                         "--out", str(tmp_path / "a.pdacpt"), *flag])
    assert exc.value.code == 2
    assert f"{flag[0]} is not supported" in capsys.readouterr().err


def test_int8_and_stain_raise(weights, tmp_path):
    """int8 export without calibration batches, at another tile than the
    one it calibrates at, or for a model with no int8 path raises; so does
    an unknown stain method."""
    with pytest.raises(ValueError, match="calibration batches"):
        export_serving_artifact(_cfg(), weights, str(tmp_path / "a"),
                                int8=True, device="cpu")
    calib = [np.zeros((2, TILE, TILE, 3), np.uint8)]
    with pytest.raises(ValueError, match="cfg.img_size"):
        export_serving_artifact(_cfg(), weights, str(tmp_path / "a"),
                                tile=2 * TILE, int8=True,
                                calib_batches=calib, device="cpu")
    cfg = Config(model="unet++", img_size=TILE, compute_dtype="float32")
    with pytest.raises(ValueError, match="no int8 path"):
        export_serving_artifact(
            cfg, seeded_state_dict(build_model(cfg), seed=1),
            str(tmp_path / "b"), int8=True, calib_batches=calib,
            device="cpu")
    cfg = _cfg()
    cfg.stain = "vahadane"
    with pytest.raises(ValueError, match="stain"):
        export_serving_artifact(cfg, weights, str(tmp_path / "c"))
        load_serving_artifact(str(tmp_path / "c"), device="cpu")
    assert not (tmp_path / "a").exists()


# -- int8 and stain artifacts -------------------------------------------------

CALIB = np.random.default_rng(21).integers(0, 256, (4, TILE, TILE, 3),
                                           dtype=np.uint8)


@pytest.fixture(scope="module")
def int8_artifact(weights, artifact_path, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("int8") / "model.pdacpt")
    size = export_serving_artifact(_cfg(), weights, path, int8=True,
                                   calib_batches=[CALIB], device="cpu")
    return path, size


def test_int8_artifact_equals_in_process_step(weights, int8_artifact,
                                              artifact_path):
    """Export → load gives the in-process quantized step bit for bit, the
    payload holds int8 kernels and none of their float copies, and the
    file is well under the float artifact's size."""
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized as q,
    )

    path, size = int8_artifact
    art = load_serving_artifact(path, device="cpu")
    assert art.meta["int8"] is True and art.meta["act_storage"] == "int8"
    model = build_model(_cfg())
    model.load_state_dict(weights, strict=True)
    sd = model.state_dict()
    bundle, forward = q.quantize_from_config(_cfg(), sd, [CALIB])
    tiles = np.random.default_rng(22).integers(0, 256, (3, TILE, TILE, 3),
                                               dtype=np.uint8)
    want = q.make_quantized_infer_step(sd, bundle, TILE, forward)(tiles)
    np.testing.assert_array_equal(art(tiles), want.numpy())
    meta, payload = read_artifact(path)
    sites = q.SITES["fpn"](sd)
    assert set(payload["qweights"]) == set(sites)
    assert all(kq.dtype == torch.int8
               for kq, _ in payload["qweights"].values())
    assert not {key for key, _ in sites.values()} & set(payload["state_dict"])
    assert size < 0.4 * len(open(artifact_path, "rb").read())


def test_int8_daemon_serves_the_artifact(int8_artifact):
    art = load_serving_artifact(int8_artifact[0], device="cpu")
    srv = _serve(SegmentationServer(("127.0.0.1", 0), art, buckets=(1, 2),
                                    max_wait_ms=5.0))
    try:
        img = np.random.default_rng(23).integers(0, 256, (TILE, TILE, 3),
                                                 dtype=np.uint8)
        headers = {**RAW, "Accept": "application/octet-stream"}
        got = _raw_probs(_post(srv, img.tobytes(), headers))
        with urllib.request.urlopen(_url(srv, "/v1/stats"), timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
    np.testing.assert_array_equal(got, art(img[None])[0])
    assert stats["int8"] is True and stats["requests"] == 1


def test_cli_export_int8_with_calib_path(weights, int8_artifact, tmp_path,
                                         capsys):
    """``cli.export --int8 --calib_path`` calibrates on the directory's
    first patches: the same artifact as the direct export on them."""
    from PIL import Image

    calib_dir = tmp_path / "calib"
    calib_dir.mkdir()
    for i, img in enumerate(CALIB):
        Image.fromarray(img).save(calib_dir / f"p{i}.png")
        Image.fromarray(np.zeros((TILE, TILE), np.uint8)).save(
            calib_dir / f"p{i}_labelled.png")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(
        {"model": "fpn", "backbone": "resnet18", "img_size": TILE,
         "compute_dtype": "float32", "test_path": str(tmp_path / "none")}))
    pth = tmp_path / "best.pth"
    torch.save({"model": dict(weights)}, pth)
    out = tmp_path / "cli.pdacpt"
    res = cli_export.main(["--config", str(cfg_path), "--pth_path", str(pth),
                           "--out", str(out), "--int8", "--calib_path",
                           str(calib_dir), "--device", "cpu"])
    assert "int8" in capsys.readouterr().out
    assert res["bytes"] == out.stat().st_size
    tiles = np.random.default_rng(24).integers(0, 256, (2, TILE, TILE, 3),
                                               dtype=np.uint8)
    np.testing.assert_array_equal(
        load_serving_artifact(str(out), device="cpu")(tiles),
        load_serving_artifact(int8_artifact[0], device="cpu")(tiles))


@pytest.mark.parametrize("method", ["reinhard", "macenko"])
def test_stain_artifact_serves_the_stained_step(weights, tmp_path, method):
    cfg = _cfg()
    cfg.stain = method
    path = str(tmp_path / "stain.pdacpt")
    export_serving_artifact(cfg, weights, path)
    art = load_serving_artifact(path, device="cpu")
    assert art.meta["stain"] == method
    model = build_model(_cfg())
    model.load_state_dict(weights, strict=True)
    tiles = np.random.default_rng(25).integers(0, 256, (2, TILE, TILE, 3),
                                               dtype=np.uint8)
    want = make_infer_step(model, TILE, stain=method)(torch.from_numpy(tiles))
    np.testing.assert_array_equal(art(tiles), want.numpy())


def test_loaders_refuse_each_others_artifacts(artifact_path, tmp_path):
    with open(artifact_path, "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC
    with pytest.raises(ValueError, match="bad magic"):
        jax_load_serving_artifact(artifact_path)
    jax_like = tmp_path / "jax.pdacsrv"
    jax_like.write_bytes(b"PDACSRV1" + b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        load_serving_artifact(str(jax_like), device="cpu")


def test_port_server_matches_jax_server(weights, server, tmp_path):
    """The same weights served by both daemons answer one tile within
    ``atol=5e-4``."""
    jcfg = JaxConfig(model="fpn", backbone="resnet18", img_size=TILE,
                     compute_dtype="float32")
    jmodel = jax_build_model(jcfg)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, TILE, TILE, 3)),
        train=False)
    params, batch_stats = convert_smp_fpn_state_dict(
        {k: v.numpy() for k, v in weights.items()},
        variables["params"], variables["batch_stats"])
    state = namedtuple("_State", "params batch_stats")(params, batch_stats)
    path = str(tmp_path / "model.pdacsrv")
    jax_export_serving_artifact(jcfg, state, path, platforms=("cpu",))
    jsrv = _serve(JaxSegmentationServer(
        ("127.0.0.1", 0), jax_load_serving_artifact(path), buckets=(1,),
        aot=False))
    try:
        img = np.random.default_rng(6).integers(0, 256, (TILE, TILE, 3),
                                                dtype=np.uint8)
        headers = {**RAW, "Accept": "application/octet-stream"}
        ours = _raw_probs(_post(server, img.tobytes(), headers))
        ref = _raw_probs(_post(jsrv, img.tobytes(), headers))
    finally:
        jsrv.shutdown()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-4)


def _unet(weights, head_dtype):
    model = build_model(Config.from_dict({
        "model": "unet", "img_size": TILE, "compute_dtype": "bfloat16",
        "head_dtype": head_dtype}))
    model.load_state_dict(weights, strict=True)
    return model


@pytest.fixture(scope="module")
def unet_weights():
    return seeded_state_dict(build_model(Config(model="unet", img_size=TILE)),
                             seed=12)


def test_unet_artifact_keeps_head_dtype(unet_weights, tmp_path):
    """Export → load → call: the metadata carries ``head_dtype`` and the
    served model is rebuilt with it; an artifact written without the field
    (before it existed) loads with an f32 head."""
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({
        "model": "unet", "img_size": TILE, "compute_dtype": "bfloat16",
        "head_dtype": "bfloat16"}))
    pth = tmp_path / "best.pth"
    torch.save({"model": {f"module.{k}": v for k, v in unet_weights.items()}},
               pth)
    out = tmp_path / "unet.pdacpt"
    cli_export.main(["--config", str(cfg_path), "--pth_path", str(pth),
                     "--out", str(out)])
    art = load_serving_artifact(str(out), device="cpu")
    assert art.meta["head_dtype"] == "bfloat16"
    tiles = np.random.default_rng(4).integers(0, 256, (2, TILE, TILE, 3),
                                              dtype=np.uint8)
    probs = art(tiles)
    direct = make_infer_step(_unet(unet_weights, "bfloat16"), TILE)(
        torch.from_numpy(tiles)).numpy()
    assert probs.dtype == np.float32 and probs.shape == (2, TILE, TILE)
    np.testing.assert_array_equal(probs, direct)

    meta, sd = read_artifact(str(out))
    del meta["head_dtype"]
    blob = json.dumps(meta).encode()
    buf = io.BytesIO()
    torch.save(sd, buf)
    old = tmp_path / "old.pdacpt"
    old.write_bytes(MAGIC + len(blob).to_bytes(4, "little") + blob
                    + buf.getvalue())
    old_art = load_serving_artifact(str(old), device="cpu")
    f32_head = make_infer_step(_unet(unet_weights, "float32"), TILE)(
        torch.from_numpy(tiles)).numpy()
    np.testing.assert_array_equal(old_art(tiles), f32_head)
    assert not np.array_equal(f32_head, probs)  # the head dtype did matter

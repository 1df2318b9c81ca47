"""Import boundaries and device rules of the PyTorch port.

The port imports torch, numpy, PIL and yaml, never ``jax`` nor any module
of the JAX package.  The port's own name starts with the JAX package's, so
every check compares module names exactly: the package itself or a name
starting with it plus a dot.  The import check runs in a subprocess,
because this test process has imported jax already (``conftest.py``).
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = "pdac_pathological_image_segmentation_tpu_torch"
JAX_PKG = "pdac_pathological_image_segmentation_tpu"


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("jax", JAX_PKG))


def test_name_check_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".config")
    assert not _forbidden(PORT) and not _forbidden(PORT + ".config")
    assert not _forbidden("jaxtyping")


_PROBE = """
import importlib, json, pkgutil, sys
import {port} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"imported": names, "modules": sorted(sys.modules)}}))
"""


def test_port_modules_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(port=PORT)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {f"{PORT}.{m}" for m in (
        "config", "ops.group_norm", "ops._build", "ops.resize",
        "models.resnet", "models.encoders", "models.fpn", "models.registry",
        "utils.torch_weights", "train.steps", "infer.export", "infer.server",
        "cli.export", "cli.serve", "ops.augment", "ops.fused_augment",
        "ops.dice", "train.objective", "train.state", "train.schedule",
        "train.checkpoint", "train.loop", "utils.meters", "data.discovery",
        "data.loader", "cli.train", "models.resunet", "ops.metrics",
        "infer.figures", "infer.evaluate", "cli.test", "ops.tissue",
        "ops.stitch", "data.tiffwriter", "data.tiffslide", "data.geojson",
        "data.synthetic", "infer.wsi", "cli.overlay", "models.dropout",
        "models.deeplabv3plus", "models.pspnet", "models.unetplusplus",
        "models.mobilenetv2", "models.efficientnet", "utils.profiling",
        "cli.extract", "data.native_build", "data.native_loader",
        "infer.loadtest", "infer.sweep", "parallel.mesh",
        "parallel.batchnorm", "train.gns", "infer.wsi_sharded")}
    assert expected <= set(out["imported"])
    assert [m for m in out["modules"] if _forbidden(m)] == []


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", [PORT, "chip_smoke.py"])
def test_no_source_names_jax(where):
    files = ([ROOT / where] if where.endswith(".py")
             else sorted((ROOT / where).rglob("*.py")))
    assert files
    bad = {f.name: n for f in files for n in _imported_names(f)
           if _forbidden(n)}
    assert bad == {}


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less "
                    "behaviour")
    from pdac_pathological_image_segmentation_tpu_torch import (
        Config,
        resolve_device,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        export_serving_artifact,
        load_serving_artifact,
    )
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )

    cfg = Config(model="fpn", img_size=64, compute_dtype="float32")
    path = str(tmp_path / "m.pdacpt")
    export_serving_artifact(cfg, build_model(cfg).state_dict(), path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_artifact(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert load_serving_artifact(path, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    # evaluation: the Evaluator and cli.test
    from pdac_pathological_image_segmentation_tpu_torch.cli import test
    from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
        Evaluator,
    )

    pth = tmp_path / "pth"
    pth.mkdir()
    torch.save({"model": build_model(cfg).state_dict()}, pth / "best.pth")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(cfg, str(pth))
    assert Evaluator(cfg, str(pth), device="cpu").device.type == "cpu"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(f"model: fpn\nimg_size: 64\ntest_path: {pth}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test.main(["--config", str(cfg_path), "--save_path",
                   str(tmp_path / "out"), "--pth_path", str(pth)])
    assert not (tmp_path / "out").exists()


def test_cli_overlay_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less "
                    "behaviour")
    from pdac_pathological_image_segmentation_tpu_torch.cli import overlay

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model: fpn\nimg_size: 64\n")
    argv = ["--config", str(cfg), "--save_path", str(tmp_path / "out"),
            "--pth_path", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        overlay.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        overlay.main(argv + ["--device", "cuda"])
    assert not (tmp_path / "out").exists()
    # the runners take the model's device, or the device they are given
    from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
        SlidingWindowInference,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlidingWindowInference(None, tile=64, infer_step=lambda x: x,
                               device="cuda")


def test_cuda_tensor_without_kernel_raises_not_falls_back():
    """A non-CPU tensor never takes the plain version: a meta tensor (the
    only non-CPU device this host has) is refused."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu,
    )

    x = torch.empty(1, 32, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_relu(x, torch.ones(32), torch.zeros(32))


def test_cli_train_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less "
                    "behaviour")
    from pdac_pathological_image_segmentation_tpu_torch.cli import train

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model: fpn\nimg_size: 64\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", str(cfg), "--save_path", str(tmp_path)])
    assert not (tmp_path / "pth").exists()


def test_train_kernels_raise_on_other_devices_not_fall_back():
    """The fused augmentation and the GroupNorm backward refuse a tensor
    that is neither on the CPU nor on a card (a meta tensor here)."""
    from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
        draw_augment_scalars,
        make_augment_tables,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops.fused_augment import (
        fused_train_transform,
    )
    from pdac_pathological_image_segmentation_tpu_torch.ops.group_norm import (
        group_norm_relu_backward,
    )

    tables = make_augment_tables(*draw_augment_scalars(
        2, torch.Generator().manual_seed(0))).to("meta")
    images = torch.empty(2, 8, 8, 3, dtype=torch.uint8, device="meta")
    masks = torch.empty(2, 8, 8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_train_transform(images, masks, tables)
    x = torch.empty(1, 32, 4, 4, device="meta")
    stats = torch.empty(1, 32, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_relu_backward(x, x, torch.ones(32), x, stats)

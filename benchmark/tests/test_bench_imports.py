"""What the benchmark imports, compared by whole top-level names."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted(sys.modules)))
"""


def modules_after(imports: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                            imports=imports)],
        capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.splitlines()[-1])


def test_forbidden_names_are_whole_top_level_names():
    held = harness.forbidden_modules([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "pdac_pathological_image_segmentation_tpu",
        "pdac_pathological_image_segmentation_tpu.ops.stitch",
        "pdac_pathological_image_segmentation_tpu_torch",
        "pdac_pathological_image_segmentation_tpu_torch.infer.wsi",
        "jaxtyping", "flaxen", "benchmark.harness"])
    assert held == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                    "pdac_pathological_image_segmentation_tpu",
                    "pdac_pathological_image_segmentation_tpu.ops.stitch"]


def test_a_run_imports_no_jax():
    """The harness, every driver and reader, and the program paths the
    drivers take hold none of the forbidden names."""
    readers = "\n".join(
        f"harness.load_module(harness.HERE / 'metrics' / '{m['name']}.py', "
        f"'m{i}')" for i, m in enumerate(harness.benchmark()["per_layer"]))
    held = modules_after(
        "import runpy\n"
        "from benchmark import harness, trace, weights\n"
        "from benchmark.drivers import slide, train\n"
        "import pdac_pathological_image_segmentation_tpu_torch.infer.wsi\n"
        "import pdac_pathological_image_segmentation_tpu_torch.infer."
        "quantized\n"
        "import pdac_pathological_image_segmentation_tpu_torch.train.steps\n"
        "runpy.run_path(str(harness.HERE / 'run.py'), run_name='probe')\n"
        + readers)
    assert "pdac_pathological_image_segmentation_tpu_torch" in held
    assert harness.forbidden_modules(held) == []


def test_the_reference_imports_nothing_of_the_program():
    held = modules_after(
        "from benchmark.reference import models, quant, slide, train\n"
        "from benchmark.counts import bytes, flops\n"
        "from benchmark import weights")
    assert not [m for m in held if m.split(".")[0].startswith("pdac")]
    assert harness.forbidden_modules(held) == []

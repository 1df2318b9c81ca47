"""The PyTorch port's DeepLabV3+ (``model: deeplabv3+``) against the JAX
package, on the CPU at 64², f32.

One seeded ``state_dict`` in smp's names feeds both sides (the JAX side
through ``convert_smp_deeplabv3plus_state_dict``):

* the eval-mode and train-mode (batch-statistics BN, dropout off) logits
  against flax at the golden bound (``rtol=2e-3, atol=5e-4``), and the
  ``deeplabv3plus_state_dict_from_jax`` round trip, bit-exact;
* one train step (``augment=False``, dropout off on both sides) against
  the JAX ``make_train_step``: loss, score, gradients, Adam, BN;
* the dilated layer4 at output stride 16 (resnet18/34/50) against the JAX
  encoder, and smp's ``replace_strides_with_dilation`` semantics;
* the ASPP dropout's law and where its mask comes from;
* a reference ``.pth`` of the smp twin in ``tests/test_deeplab_golden.py``:
  strict load, the twin's logits, ``cli.export``, ``cli.test`` against the
  JAX ``Evaluator``, ``cli.overlay`` against the JAX ``cli.overlay``, and a
  resume with every Adam moment on its own parameter; the port's own
  ``latest.pth`` read by the JAX ``load_reference_checkpoint_full``;
* an artifact exported with rates (6, 12, 18) rebuilds with them.
"""

import io
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pdac_pathological_image_segmentation_tpu.data.discovery import (
    discover_split as jax_discover_split,
)
from pdac_pathological_image_segmentation_tpu.data.loader import (
    PatchDataset as JaxPatchDataset,
)
from pdac_pathological_image_segmentation_tpu.data.synthetic import (
    generate_synthetic_patches,
)
from pdac_pathological_image_segmentation_tpu.infer.evaluate import (
    Evaluator as JaxEvaluator,
)
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.models.encoders import (
    build_encoder as jax_build_encoder,
)
from pdac_pathological_image_segmentation_tpu.parallel.mesh import create_mesh
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_deeplabv3plus_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    export as cli_export,
    overlay as cli_overlay,
    test as cli_test,
)
from pdac_pathological_image_segmentation_tpu_torch.data.tiffwriter import (
    write_tiff,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    MAGIC,
    export_serving_artifact,
    load_serving_artifact,
    read_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.deeplabv3plus import (
    DeepLabV3Plus,
)
from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
    Dropout,
)
from pdac_pathological_image_segmentation_tpu_torch.models.resnet import (
    ResNetEncoder,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    BN_BUFFERS,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
    step_generator,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    deeplabv3plus_state_dict_from_jax,
    load_reference_state_dict,
    seeded_state_dict,
)

from test_deeplab_golden import _randomize_stats, _TorchSmpDeepLabV3Plus
from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    SIZE,
    assert_cli_train_and_resume,
    assert_forward_matches,
    assert_port_checkpoint_loads_into_jax,
    assert_reference_resume,
    assert_round_trip,
    assert_step_adam,
    assert_step_batchnorm,
    assert_step_gradients,
    assert_step_loss_and_score,
    flax_dropout_off,
    jax_cfg,
    jax_variables,
    one_step,
    one_torch_thread,
    port_cfg,
    raw_cfg,
)

MODEL = "deeplabv3+"


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(build_model(port_cfg(MODEL)), seed=17)


@pytest.fixture(scope="module")
def jax_pair(weights):
    jmodel = jax_build_model(jax_cfg(MODEL))
    return jmodel, jax_variables(jmodel, weights,
                                 convert_smp_deeplabv3plus_state_dict)


def _port(sd, **kw):
    model = DeepLabV3Plus(output_size=SIZE, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50"])
def test_build_model_gives_deeplab_with_smp_names(backbone):
    """``deeplabv3+`` builds the port's model on each ResNet with the
    config's ``dilations`` as its atrous rates and smp's names."""
    model = build_model(port_cfg(MODEL, backbone=backbone,
                                 dilations="(6, 12, 18)"))
    assert isinstance(model, DeepLabV3Plus) and not model.training
    assert model.atrous_rates == (6, 12, 18)
    convs = model.decoder.aspp[0].convs
    assert [convs[i][0][0].dilation for i in (1, 2, 3)] == [
        (6, 6), (12, 12), (18, 18)]
    names = list(model.state_dict())
    for key in ("decoder.aspp.0.convs.0.0.weight",
                "decoder.aspp.0.convs.3.0.0.weight",
                "decoder.aspp.0.convs.4.2.running_var",
                "decoder.aspp.0.project.1.weight", "decoder.aspp.1.1.weight",
                "decoder.aspp.2.bias", "decoder.block1.1.running_mean",
                "decoder.block2.0.1.weight", "segmentation_head.0.bias"):
        assert key in names, key
    c5 = 2048 if backbone == "resnet50" else 512
    assert tuple(model.state_dict()[
        "decoder.aspp.0.convs.1.0.0.weight"].shape) == (c5, 1, 3, 3)


def test_eval_forward_matches_flax(weights, jax_pair):
    assert_forward_matches(_port(weights), *jax_pair, train=False, seed=0)


def test_train_forward_with_batch_statistics_matches_flax(weights, jax_pair):
    """Train mode, dropout off on both sides: BN takes the batch's
    statistics (flax ``train=True``)."""
    with flax_dropout_off():
        assert_forward_matches(_port(weights, dropout=0.0), *jax_pair,
                               train=True, seed=1, n=4)


def test_state_dict_round_trip_through_jax_is_bit_exact(weights, jax_pair):
    assert_round_trip(weights, jax_pair[1], deeplabv3plus_state_dict_from_jax)


# -- one train step against JAX ------------------------------------------------

@pytest.fixture(scope="module")
def step(weights):
    return one_step(MODEL, _port(weights, dropout=0.0), weights,
                    convert_smp_deeplabv3plus_state_dict,
                    deeplabv3plus_state_dict_from_jax)


def test_train_step_loss_and_score_match_jax(step):
    assert_step_loss_and_score(step)


def test_train_step_gradients_match_jax_grad(step):
    assert sorted(step["grads"]) == sorted(step["jgrads"])
    assert_step_gradients(step)


def test_train_step_adam_update_matches_jax(step):
    assert_step_adam(step)


def test_train_step_batchnorm_stats_match_jax(step):
    """Every BatchNorm of the model runs, the ASPP pooling branch's over a
    1×1 plane, and each matches flax."""
    ran = assert_step_batchnorm(step)
    assert len(ran) == 20 + 9
    assert "decoder.aspp.0.convs.4.2" in ran


# -- the dilated encoder -------------------------------------------------------

@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50"])
def test_dilated_stage_matches_jax(backbone):
    """At output stride 16 every conv of layer4, block 0 and the
    downsample included, has stride 1 and dilation 2 with padding
    (k // 2)·2 (smp's ``replace_strides_with_dilation``), the other stages
    are untouched, and the feature shapes equal the JAX encoder's (its
    values are held through the whole model's logits above)."""
    enc = ResNetEncoder(backbone, output_stride=16).eval()
    for name, mod in enc.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and name.startswith("layer4"):
            k = mod.kernel_size[0]
            assert (mod.stride, mod.dilation, mod.padding) == (
                (1, 1), (2, 2), ((k // 2) * 2,) * 2), name
        elif isinstance(mod, torch.nn.Conv2d):
            assert mod.dilation == (1, 1), name
    x = np.random.default_rng(4).normal(size=(1, 3, SIZE, SIZE)).astype(
        np.float32)
    with torch.no_grad():
        ours = [f.numpy() for f in enc(torch.from_numpy(x))]
    jenc = jax_build_encoder(backbone, output_stride=16, dtype=jnp.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    shapes = jax.eval_shape(
        lambda a: jenc.apply(jenc.init(jax.random.PRNGKey(0), a), a), xj)
    assert [f.shape for f in ours] == [
        (s.shape[0], s.shape[3], s.shape[1], s.shape[2]) for s in shapes]
    assert [f.shape[-1] for f in ours] == [SIZE // s
                                           for s in (2, 4, 8, 16, 16)]


# -- the ASPP dropout ----------------------------------------------------------

def test_aspp_dropout_law_and_mask_source():
    """Elementwise: each element is zero or doubled, the kept share lies
    within 5σ of 0.5 over 524,288 elements, equal step generators give the
    same mask bitwise, another step another mask, and the step's generator
    gives up exactly one 64-bit draw (the mask itself comes from a
    generator on the activation's device).  Eval mode and p = 0 are the
    identity; train mode without a generator raises."""
    drop = Dropout(0.5).train()
    x = torch.rand(8, 256, 16, 16) + 0.5
    gen = step_generator(41, 0, 3)
    y = drop(x, gen)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * 2.0, rtol=0, atol=0)
    n = x.numel()
    assert abs(kept.float().mean().item() - 0.5) < 5 * (0.25 / n) ** 0.5
    assert torch.equal(drop(x, step_generator(41, 0, 3)), y)
    assert not torch.equal(drop(x, step_generator(41, 0, 4)), y)
    probe = step_generator(41, 0, 3)
    torch.randint(0, 2 ** 63 - 1, (), generator=probe)
    assert torch.equal(gen.get_state(), probe.get_state())
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    assert drop.eval()(x) is x
    assert Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="dropout p"):
        Dropout(1.0)


def test_train_mode_model_draws_its_aspp_mask_from_the_step(weights):
    """The model in train mode: the same step generator gives the same
    logits bitwise, another step other logits."""
    model = _port(weights).train()
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        a = model(x, step_generator(0, 1, 2))
        b = model(x, step_generator(0, 1, 2))
        c = model(x, step_generator(0, 1, 3))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- a reference checkpoint ------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A reference smp DeepLabV3+ ``best.pth`` (the golden test's twin),
    its twin, test and val splits and a config naming them."""
    root = tmp_path_factory.mktemp("deeplab_ref")
    torch.manual_seed(8)
    twin = _TorchSmpDeepLabV3Plus().eval()
    _randomize_stats(twin)
    pth = root / "pth" / "best.pth"
    pth.parent.mkdir()
    torch.save({"model": {f"module.{k}": v
                          for k, v in twin.state_dict().items()},
                "optimizer": {}, "epoch": 2, "previous_best": 0.5}, pth)
    data = root / "test"
    generate_synthetic_patches(str(data), n=8, size=SIZE, seed=9)
    slide = np.random.default_rng(10).integers(0, 256, (SIZE, 2 * SIZE, 3),
                                               dtype=np.uint8)
    write_tiff(str(root / "slide.tiff"), slide, tile=32, min_size=32)
    raw = raw_cfg(MODEL, batch_size=4, num_worker=2, test_path=str(data))
    (root / "cfg.yaml").write_text(yaml.safe_dump(raw))
    return {"root": root, "twin": twin, "pth": pth, "raw": raw}


def test_reference_pth_loads_strictly_and_matches_the_twin(reference):
    model = build_model(port_cfg(MODEL))
    model.load_state_dict(load_reference_state_dict(str(reference["pth"])),
                          strict=True)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(2, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(),
                                   reference["twin"](x).numpy(),
                                   rtol=1e-4, atol=1e-5)
    out = reference["root"] / "ref.pdacpt"
    cli_export.main(["--config", str(reference["root"] / "cfg.yaml"),
                     "--pth_path", str(reference["pth"]), "--out", str(out)])
    meta, sd = read_artifact(str(out))
    assert meta["model"] == MODEL and meta["dilations"] == [3, 6, 9]
    assert sorted(sd) == sorted(model.state_dict())


def test_cli_test_on_reference_pth_matches_jax_evaluator(reference):
    """``cli.test --device cpu`` and the JAX ``Evaluator`` on the same
    reference file: ``test_score`` within 1e-3
    (``tests/test_deeplab_golden.py``'s bound), the loss too."""
    root = reference["root"]
    ours = cli_test.main(["--config", str(root / "cfg.yaml"), "--save_path",
                          str(root / "eval"), "--pth_path",
                          str(reference["pth"]), "--max_figures", "0",
                          "--device", "cpu"])
    jcfg = jax_cfg(MODEL, **{k: v for k, v in reference["raw"].items()
                             if k not in ("model", "img_size",
                                          "compute_dtype", "lr")})
    ref = JaxEvaluator(jcfg, str(reference["pth"]),
                       mesh=create_mesh(1)).run(
        JaxPatchDataset(*jax_discover_split(jcfg.test_path), jcfg),
        verbose=False)
    assert ours["n_samples"] == 8
    assert abs(ours["test_score"] - ref["test_score"]) < 1e-3
    assert abs(ours["test_loss"] - ref["test_loss"]) < 1e-3


def test_cli_overlay_on_reference_pth(reference):
    """``cli.overlay --banded`` over a 64×128 slide at stride 32 with the
    reference file: a float16 map in [0, 1] of the slide's size, equal to
    the run through an artifact exported from the same file (the
    runners themselves are held against JAX in ``test_torch_wsi.py``)."""
    root = reference["root"]
    art = root / "ov.pdacpt"
    cli_export.main(["--config", str(root / "cfg.yaml"), "--pth_path",
                     str(reference["pth"]), "--out", str(art)])
    base = ["--config", str(root / "cfg.yaml"), "--slide",
            str(root / "slide.tiff"), "--stride", "32", "--banded",
            "--device", "cpu"]
    maps = []
    for name, src in (("pth", ["--pth_path", str(reference["pth"])]),
                      ("art", ["--artifact", str(art)])):
        res = cli_overlay.main(base + src + ["--save_path",
                                             str(root / f"ov_{name}")])
        assert res["n_tiles"] == 3
        maps.append(np.load(root / f"ov_{name}" / "probability_map.npy"))
    p = maps[0].astype(np.float32)
    assert maps[0].shape == (SIZE, 2 * SIZE) and maps[0].dtype == np.float16
    assert np.isfinite(p).all() and 0 <= p.min() and p.max() <= 1
    np.testing.assert_array_equal(maps[0], maps[1])


def test_reference_resume_puts_each_moment_on_its_parameter(weights,
                                                            tmp_path):
    """Resume from a reference ``latest.pth`` with Adam moments: the
    weights load strictly, each moment lands on the parameter that held it,
    as the JAX ``load_reference_checkpoint_full`` places it (bit-equal once
    mapped back), and the port keeps its own learning rate."""
    opt = assert_reference_resume(weights, tmp_path, MODEL,
                                  deeplabv3plus_state_dict_from_jax)
    assert len(opt.state_dict()["state"]) == len(
        [k for k in weights if not k.endswith(BN_BUFFERS)])


def test_port_latest_pth_loads_into_jax(step, tmp_path):
    """The port's ``latest.pth`` after one train step: the JAX
    ``load_reference_checkpoint_full`` reads it, with the port's weights,
    BN statistics and Adam moments, bit-equal once mapped back."""
    assert_port_checkpoint_loads_into_jax(step, tmp_path, MODEL,
                                          deeplabv3plus_state_dict_from_jax)


# -- the serving artifact ------------------------------------------------------

def test_artifact_keeps_the_atrous_rates(weights, tmp_path):
    """Exported with rates (6, 12, 18), the artifact rebuilds with them and
    serves what the ``.pth`` serves at those rates, which differs from the
    default rates' output on the same weights; an artifact written without
    the field loads with (3, 6, 9)."""
    cfg = port_cfg(MODEL, dilations=[6, 12, 18])
    out = tmp_path / "rates.pdacpt"
    export_serving_artifact(cfg, weights, str(out))
    art = load_serving_artifact(str(out), device="cpu")
    assert art.meta["dilations"] == [6, 12, 18]
    tiles = np.random.default_rng(12).integers(0, 256, (2, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    model = build_model(cfg)
    model.load_state_dict(weights, strict=True)
    want = make_infer_step(model, SIZE)(torch.from_numpy(tiles)).numpy()
    np.testing.assert_array_equal(art(tiles), want)
    default = _port(weights)
    other = make_infer_step(default, SIZE)(torch.from_numpy(tiles)).numpy()
    assert np.abs(other - want).max() > 1e-3

    meta, sd = read_artifact(str(out))
    del meta["dilations"]
    blob = json.dumps(meta).encode()
    buf = io.BytesIO()
    torch.save(sd, buf)
    old = tmp_path / "old.pdacpt"
    old.write_bytes(MAGIC + len(blob).to_bytes(4, "little") + blob
                    + buf.getvalue())
    np.testing.assert_array_equal(
        load_serving_artifact(str(old), device="cpu")(tiles), other)


def test_cli_train_two_epochs_then_resumes(tmp_path, capsys):
    """``model: deeplabv3+`` through ``cli.train`` (bf16, the ASPP dropout
    on): two finite epochs, then the resume."""
    assert_cli_train_and_resume(MODEL, tmp_path, capsys)

"""The PyTorch port's PSPNet (``model: pspnet``, also ``pspnet+``) against
the JAX package, on the CPU at 64², f32.

One seeded ``state_dict`` in smp's names feeds both sides (the JAX side
through ``convert_smp_pspnet_state_dict``):

* the eval-mode and train-mode (batch-statistics BN, dropout off) logits
  against flax at the golden bound (``rtol=2e-3, atol=5e-4``), and the
  ``pspnet_state_dict_from_jax`` round trip, bit-exact;
* one train step (``augment=False``, dropout off on both sides) against
  the JAX ``make_train_step``: loss, score, gradients, Adam, the BN
  statistics of every stage that runs; ``layer3``/``layer4``, built but
  not run, keep their weights and statistics, get no gradient and no Adam
  state (the JAX encoder runs them and moves their statistics: a known
  gap, ROADMAP Queue 3);
* ``Dropout2d``'s mask comes from the step's generator;
* a reference ``.pth`` of the smp twin in ``tests/test_pspnet_golden.py``:
  strict load, the twin's logits, ``cli.export``, ``cli.test`` against the
  JAX ``Evaluator``, ``cli.overlay``, and a resume with every Adam moment
  on its own parameter; the port's own ``latest.pth`` (with the unrun
  stages) read by the JAX ``load_reference_checkpoint_full``.
"""

import numpy as np
import pytest
import torch
import yaml

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
from pdac_pathological_image_segmentation_tpu.parallel.mesh import create_mesh
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_pspnet_state_dict,
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
    read_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
    Dropout2d,
)
from pdac_pathological_image_segmentation_tpu_torch.models.pspnet import (
    PSPNet,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    BN_BUFFERS,
    parameter_names,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    step_generator,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    load_reference_state_dict,
    pspnet_state_dict_from_jax,
    seeded_state_dict,
)

from test_pspnet_golden import _randomize_stats, _TorchSmpPSPNet
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

MODEL = "pspnet"
UNRUN = ("encoder.layer3.", "encoder.layer4.")


@pytest.fixture(scope="module")
def weights():
    # at seed 19 JAX's f32 gradients of layer1 lie 9.4e-3 of their scale
    # from a float64 step's, the port's 2.7e-6, the two float64 steps
    # 9.6e-7 apart (ROADMAP Queue 3); at this seed the f32 sides agree
    # within 1.3e-5
    return seeded_state_dict(build_model(port_cfg(MODEL)), seed=20)


@pytest.fixture(scope="module")
def jax_pair(weights):
    jmodel = jax_build_model(jax_cfg(MODEL))
    return jmodel, jax_variables(jmodel, weights,
                                 convert_smp_pspnet_state_dict)


def _port(sd, **kw):
    model = PSPNet(output_size=SIZE, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("name,backbone,branch", [
    ("pspnet", "resnet18", 32), ("pspnet+", "resnet34", 32),
    ("pspnet", "resnet50", 128)])
def test_build_model_gives_pspnet_with_smp_names(name, backbone, branch):
    """``pspnet`` and the reference ``test.py``'s ``pspnet+`` build the
    port's PSPNet with smp's names: branches of C/4 channels over c3, the
    1×1 bin with a bias and no BN; ``layer3``/``layer4`` built."""
    model = build_model(port_cfg(name, backbone=backbone))
    assert isinstance(model, PSPNet) and not model.training
    sd = model.state_dict()
    assert tuple(sd["decoder.psp.blocks.0.pool.1.0.weight"].shape)[0] == \
        branch
    assert "decoder.psp.blocks.0.pool.1.0.bias" in sd
    assert not any(k.startswith("decoder.psp.blocks.0.pool.1.1") for k in sd)
    assert "decoder.psp.blocks.3.pool.1.1.running_var" in sd
    assert {"decoder.conv.0.weight", "decoder.conv.1.weight",
            "segmentation_head.0.bias"} <= set(sd)
    assert any(k.startswith("encoder.layer4.") for k in sd)
    assert isinstance(model.decoder.dropout, Dropout2d)
    assert model.decoder.dropout.p == 0.2


def test_eval_forward_matches_flax(weights, jax_pair):
    assert_forward_matches(_port(weights), *jax_pair, train=False, seed=0)


def test_train_forward_with_batch_statistics_matches_flax(weights, jax_pair):
    with flax_dropout_off():
        assert_forward_matches(_port(weights, dropout=0.0), *jax_pair,
                               train=True, seed=1, n=4)


def test_state_dict_round_trip_through_jax_is_bit_exact(weights, jax_pair):
    assert_round_trip(weights, jax_pair[1], pspnet_state_dict_from_jax)


def test_encoder_stops_at_c3():
    """The encoder returns [c1, c2, c3] and never calls layer3/layer4."""
    model = build_model(port_cfg(MODEL))
    called = []
    for name in ("layer3", "layer4"):
        getattr(model.encoder, name).register_forward_hook(
            lambda *a, name=name: called.append(name))
    with torch.no_grad():
        feats = model.encoder(torch.zeros(1, 3, SIZE, SIZE))
    assert [f.shape[1] for f in feats] == [64, 64, 128] and called == []


# -- one train step against JAX ------------------------------------------------

@pytest.fixture(scope="module")
def step(weights):
    return one_step(MODEL, _port(weights, dropout=0.0), weights,
                    convert_smp_pspnet_state_dict, pspnet_state_dict_from_jax)


def test_train_step_loss_and_score_match_jax(step):
    assert_step_loss_and_score(step)


def test_train_step_gradients_match_jax_grad(step):
    """Every parameter that runs gets JAX's gradient; layer3/layer4 get
    none on the port, and a zero one in JAX (they reach no output)."""
    unrun = sorted(k for k in step["jgrads"] if k.startswith(UNRUN))
    assert unrun and sorted(step["grads"]) == sorted(
        k for k in step["jgrads"] if not k.startswith(UNRUN))
    for k in unrun:
        assert not step["jgrads"][k].any(), k
    assert_step_gradients(step)


def test_train_step_adam_update_matches_jax(step):
    """Adam moves what ran as JAX does, and holds no state for the unrun
    stages, whose weights stay as they were."""
    assert_step_adam(step)
    model, opt = step["model"], step["optimizer"]
    names = parameter_names(model)
    held = {names[i] for i in opt.state_dict()["state"]}
    assert held == {k for k in names if not k.startswith(UNRUN)}


def test_train_step_leaves_unrun_stages_alone(step):
    """Every BN that runs matches flax; layer3/layer4's parameters and BN
    buffers are bit-equal to the weights before the step (JAX moves their
    running statistics, which reach no output)."""
    ran = assert_step_batchnorm(step)
    assert not any(n.startswith(UNRUN) for n in ran)
    assert len(ran) == 10 + 4  # stem + layer1 + layer2, 3 bins + conv
    state, sd, jparams = step["model"].state_dict(), step["sd"], \
        step["jparams"]
    unrun = [k for k in state if k.startswith(UNRUN)]
    assert len(unrun) == 2 * 30  # per stage: 5 convs, 5 BNs of 5 entries
    for k in unrun:
        assert torch.equal(state[k], sd[k]), k
    assert not torch.equal(jparams["encoder.layer3.0.bn1.running_mean"],
                           sd["encoder.layer3.0.bn1.running_mean"])


# -- Dropout2d ---------------------------------------------------------------

def test_train_mode_model_draws_its_dropout_from_the_step(weights):
    """In train mode: the same step generator gives the same logits
    bitwise, another step others; the decoder's output has whole (n, c)
    planes zeroed."""
    model = _port(weights).train()
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 3, SIZE, SIZE)).astype(np.float32))
    planes = []
    model.decoder.register_forward_hook(
        lambda mod, inp, out: planes.append(out))
    with torch.no_grad():
        a = model(x, step_generator(0, 1, 2))
        b = model(x, step_generator(0, 1, 2))
        c = model(x, step_generator(0, 1, 3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    zero = (planes[0] == 0).flatten(2)
    dropped = zero.all(dim=2)
    assert dropped.any() and not dropped.all()


# -- a reference checkpoint ------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A reference smp PSPNet ``best.pth`` (the golden test's twin), its
    twin, a test split, a slide and a config naming them."""
    root = tmp_path_factory.mktemp("pspnet_ref")
    torch.manual_seed(12)
    twin = _TorchSmpPSPNet().eval()
    _randomize_stats(twin)
    pth = root / "pth" / "best.pth"
    pth.parent.mkdir()
    torch.save({"model": {f"module.{k}": v
                          for k, v in twin.state_dict().items()},
                "optimizer": {}, "epoch": 1, "previous_best": 0.4}, pth)
    data = root / "test"
    generate_synthetic_patches(str(data), n=8, size=SIZE, seed=13)
    slide = np.random.default_rng(14).integers(0, 256, (SIZE, 2 * SIZE, 3),
                                               dtype=np.uint8)
    write_tiff(str(root / "slide.tiff"), slide, tile=32, min_size=32)
    raw = raw_cfg("pspnet+", batch_size=4, num_worker=2, test_path=str(data))
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
    assert meta["model"] == MODEL
    assert sorted(sd) == sorted(model.state_dict())


def test_cli_test_on_reference_pth_matches_jax_evaluator(reference):
    """``cli.test --device cpu`` (config ``model: pspnet+``) and the JAX
    ``Evaluator`` on the same reference file: ``test_score`` within 1e-3
    (the golden tests' bound), the loss too."""
    root = reference["root"]
    ours = cli_test.main(["--config", str(root / "cfg.yaml"), "--save_path",
                          str(root / "eval"), "--pth_path",
                          str(reference["pth"]), "--max_figures", "0",
                          "--device", "cpu"])
    jcfg = jax_cfg(MODEL, batch_size=4, num_worker=2,
                   test_path=reference["raw"]["test_path"])
    ref = JaxEvaluator(jcfg, str(reference["pth"]),
                       mesh=create_mesh(1)).run(
        JaxPatchDataset(*jax_discover_split(jcfg.test_path), jcfg),
        verbose=False)
    assert ours["n_samples"] == 8
    assert abs(ours["test_score"] - ref["test_score"]) < 1e-3
    assert abs(ours["test_loss"] - ref["test_loss"]) < 1e-3


def test_cli_overlay_on_reference_pth(reference):
    """``cli.overlay`` over a 64×128 slide at stride 32 with the reference
    file: a map in [0, 1] of the slide's size, equal to the run through an
    artifact exported from the same file."""
    root = reference["root"]
    art = root / "ov.pdacpt"
    cli_export.main(["--config", str(root / "cfg.yaml"), "--pth_path",
                     str(reference["pth"]), "--out", str(art)])
    base = ["--config", str(root / "cfg.yaml"), "--slide",
            str(root / "slide.tiff"), "--stride", "32", "--device", "cpu"]
    maps = []
    for name, src in (("pth", ["--pth_path", str(reference["pth"])]),
                      ("art", ["--artifact", str(art)])):
        res = cli_overlay.main(base + src + ["--save_path",
                                             str(root / f"ov_{name}")])
        assert res["n_tiles"] == 3
        maps.append(np.load(root / f"ov_{name}" / "probability_map.npy"))
    assert maps[0].shape == (SIZE, 2 * SIZE)
    assert np.isfinite(maps[0]).all() and 0 <= maps[0].min() \
        and maps[0].max() <= 1
    np.testing.assert_array_equal(maps[0], maps[1])


def test_reference_resume_puts_each_moment_on_its_parameter(weights,
                                                            tmp_path):
    """A reference ``latest.pth`` whose unrun stages hold no moments: every
    other moment lands on its own parameter, as the JAX
    ``load_reference_checkpoint_full`` places it."""
    opt = assert_reference_resume(weights, tmp_path, MODEL,
                                  pspnet_state_dict_from_jax)
    n_run = len([k for k in weights if not k.endswith(BN_BUFFERS)
                 and not k.startswith(UNRUN)])
    assert len(opt.state_dict()["state"]) == n_run


def test_port_latest_pth_loads_into_jax(step, tmp_path):
    """The port's ``latest.pth`` after one train step holds layer3/layer4
    (as the reference's ``test.py`` expects), and the JAX
    ``load_reference_checkpoint_full`` reads it: weights, BN statistics
    and Adam moments bit-equal once mapped back, zero moments for the
    unrun stages."""
    assert_port_checkpoint_loads_into_jax(step, tmp_path, MODEL,
                                          pspnet_state_dict_from_jax)
    saved = torch.load(tmp_path / "latest.pth", weights_only=True)["model"]
    assert "module.encoder.layer4.1.bn2.running_var" in saved


def test_cli_train_two_epochs_then_resumes(tmp_path, capsys):
    """``model: pspnet+`` through ``cli.train`` (bf16, Dropout2d on): two
    finite epochs, then the resume, with the unrun stages' weights saved
    untouched."""
    assert_cli_train_and_resume("pspnet+", tmp_path, capsys)
    first = torch.load(tmp_path / "out" / "pth" / "latest.pth",
                       weights_only=True)["model"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(41)
        fresh = build_model(port_cfg(MODEL))
    for k, v in fresh.state_dict().items():
        if k.startswith(UNRUN):
            assert torch.equal(first[f"module.{k}"], v), k

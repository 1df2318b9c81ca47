"""The PyTorch port's EfficientNet encoders (``efficientnet-b0``…``b7``)
against the JAX package, on the CPU at 64², f32.

One seeded ``state_dict`` in efficientnet-pytorch's names (BN running
variances in 0.01-0.1, so a wrong BN eps shows) feeds both sides, the JAX
side through its ``convert_efficientnet_state_dict`` or the smp model
converters that dispatch to it:

* the scaling math, b0's block list as ``tests/test_efficientnet.py``
  hand-derives it, and b7's ``state_dict`` shapes against the JAX param
  tree from ``jax.eval_shape`` (no b7 compile);
* b0's features ``c1..c5`` at output strides 32 and 16 at the JAX
  encoder-golden bound (``rtol=atol=2e-4``), on an odd input size too,
  and the TF-SAME padding against flax's on odd and even inputs;
* FPN/efficientnet-b0 logits (eval and train mode) at the golden bound,
  its round trip bit-exact, one train step against the JAX step, the
  serving step (no normalize fold on this stem) against the JAX infer
  step; UNet++/efficientnet-b0's logits;
* a reference smp FPN/efficientnet-b0 ``.pth`` with the unrun
  ``encoder._conv_head``/``encoder._bn1``: strict load, ``cli.export``,
  ``cli.test`` against the JAX ``Evaluator``, a resume whose Adam moments
  equal the JAX ``load_reference_checkpoint_full``'s.
"""

from collections import OrderedDict

import flax.linen
import jax
import jax.numpy as jnp
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
from pdac_pathological_image_segmentation_tpu.models.efficientnet import (
    EfficientNetEncoder as JaxEfficientNetEncoder,
)
from pdac_pathological_image_segmentation_tpu.parallel.mesh import create_mesh
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_infer_step as jax_make_infer_step,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_efficientnet_state_dict,
    convert_encoder_state_dict,
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    export as cli_export,
    test as cli_test,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    read_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.efficientnet import (
    EfficientNetEncoder,
    SameConv2d,
    block_specs,
    feature_channels,
    stage_splits,
)
from pdac_pathological_image_segmentation_tpu_torch.models.encoders import (
    encoder_feature_channels,
)
from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    drop_unbuilt_keys,
    efficientnet_state_dict_from_jax,
    fpn_state_dict_from_jax,
    load_reference_state_dict,
    seeded_state_dict,
    unetplusplus_state_dict_from_jax,
)

from test_efficientnet import _B0_BLOCKS, _TorchEfficientNetB0
from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    SIZE,
    assert_forward_matches,
    assert_reference_resume,
    assert_round_trip,
    assert_step_adam,
    assert_step_batchnorm,
    assert_step_loss_and_score,
    f64_gradients,
    far_from_unit_stats,
    flax_dropout_off,
    jax_cfg,
    jax_variables,
    np_tree,
    one_step,
    one_torch_thread,
    port_cfg,
    raw_cfg,
    zero_variables,
)

B0 = "efficientnet-b0"
ENC_TOL = 2e-4  # tests/test_efficientnet.py:172


def _encoder_pair(output_stride: int, size: int = SIZE):
    """The port's b0 encoder on far-from-unit statistics, and the JAX one
    holding the same weights."""
    enc = EfficientNetEncoder(B0, output_stride).eval()
    sd = far_from_unit_stats(seeded_state_dict(enc, seed=1), seed=2)
    enc.load_state_dict(sd, strict=True)
    jenc = JaxEfficientNetEncoder(variant=B0, output_stride=output_stride)
    v = zero_variables(jenc, size)
    params, batch_stats = convert_efficientnet_state_dict(
        {k: t.numpy() for k, t in sd.items()}, v["params"], v["batch_stats"],
        encoder_key=None)
    return enc, sd, jenc, (params, batch_stats)


# -- the encoder -------------------------------------------------------------

def test_scaling_math_and_structure_match_jax():
    """The copied block list and splits equal the JAX package's and the
    hand-derived b0 list; BN eps 1e-3 and momentum 0.01 everywhere; the
    squeeze width is a quarter of the block's input channels."""
    from pdac_pathological_image_segmentation_tpu.models import (
        efficientnet as jax_eff,
    )

    for variant in jax_eff.VARIANTS:
        assert block_specs(variant) == jax_eff.block_specs(variant)
        assert stage_splits(variant) == jax_eff.stage_splits(variant)
        assert feature_channels(variant) == jax_eff.feature_channels(variant)
        assert encoder_feature_channels(variant) == feature_channels(variant)
    assert [(s["in_ch"], s["out_ch"], s["expand"], s["kernel"], s["stride"])
            for s in block_specs(B0)] == _B0_BLOCKS
    assert stage_splits("efficientnet-b7") == (11, 18, 38, 55)
    assert feature_channels("efficientnet-b7") == [64, 48, 80, 224, 640]
    enc = EfficientNetEncoder(B0)
    bns = [m for m in enc.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.eps == 1e-3 and m.momentum == 0.01 for m in bns)
    for block, (cin, _, _, _, _) in zip(enc._blocks, _B0_BLOCKS):
        assert block._se_reduce.out_channels == max(1, int(cin * 0.25))


def test_b7_state_dict_shapes_equal_the_jax_tree():
    """FPN/efficientnet-b7: the port's ``state_dict`` names and shapes equal
    the JAX model's parameter tree (from ``jax.eval_shape``, nothing
    compiled) carried through ``fpn_state_dict_from_jax``."""
    model = build_model(port_cfg("fpn", backbone="efficientnet-b7"))
    jmodel = jax_build_model(jax_cfg("fpn", backbone="efficientnet-b7"))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), train=False))

    def zeros(tree):
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
            tree)

    theirs = fpn_state_dict_from_jax(zeros(shapes["params"]),
                                     zeros(shapes["batch_stats"]))
    ours = model.state_dict()
    assert sorted(theirs) == sorted(ours)
    assert all(tuple(theirs[k].shape) == tuple(v.shape)
               for k, v in ours.items())
    assert len(model.encoder._blocks) == 55
    assert not any(k.startswith(("encoder._conv_head", "encoder._bn1."))
                   for k in ours)


def test_twin_loads_strictly_and_matches():
    """``tests/test_efficientnet.py``'s efficientnet-pytorch twin (b0):
    its ``state_dict`` loads strictly into the port's encoder and gives the
    same features."""
    torch.manual_seed(11)
    twin = _TorchEfficientNetB0().eval()
    enc = EfficientNetEncoder(B0).eval()
    enc.load_state_dict(twin.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        for ours, theirs in zip(enc(x), twin(x)):
            torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("output_stride,size", [(32, SIZE), (16, SIZE),
                                                (32, 45)])
def test_encoder_features_match_jax(output_stride, size):
    """``c1..c5`` against the JAX encoder at the encoder-golden bound; at
    output stride 16 c5 stays at stride 16 (its blocks dilated 2); an odd
    input size (45²) pads every stride-2 conv asymmetrically."""
    enc, _, jenc, (params, batch_stats) = _encoder_pair(output_stride, size)
    x = np.random.default_rng(3).normal(size=(2, 3, size, size)).astype(
        np.float32)
    with torch.no_grad():
        ours = [f.numpy() for f in enc(torch.from_numpy(x))]
    theirs = jax.jit(lambda v, a: jenc.apply(v, a, train=False))(
        {"params": params, "batch_stats": batch_stats},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    strides = (2, 4, 8, 16, 16 if output_stride == 16 else 32)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape[1] == feature_channels(B0)[i]
        assert a.shape[-1] == -(-size // strides[i])
        np.testing.assert_allclose(a, np.asarray(b).transpose(0, 3, 1, 2),
                                   rtol=ENC_TOL, atol=ENC_TOL,
                                   err_msg=f"c{i + 1}")
    dilated = [b._depthwise_conv.dilation[0] for b in enc._blocks]
    assert dilated == ([1] * 11 + [2] * 5 if output_stride == 16
                       else [1] * 16)


@pytest.mark.parametrize("kernel,stride,dilation,size", [
    (3, 2, 1, 33), (5, 2, 1, 33), (3, 2, 1, 32), (5, 2, 1, 32),
    (5, 1, 2, 31), (3, 2, 2, 33)])
def test_same_padding_matches_flax(kernel, stride, dilation, size):
    """TF "SAME" against flax's ``padding="SAME"``: (0, 1) for k=3 and
    (1, 2) for k=5 at stride 2 on an even input, symmetric on an odd one,
    the dilation counted in the effective kernel."""
    conv = SameConv2d(4, 4, kernel, stride, dilation, groups=4)
    x = np.random.default_rng(kernel + size).normal(
        size=(1, 4, size, size)).astype(np.float32)
    with torch.no_grad():
        ours = conv(torch.from_numpy(x)).numpy()
    jconv = flax.linen.Conv(4, (kernel, kernel), strides=stride,
                            padding="SAME", kernel_dilation=dilation,
                            feature_group_count=4, use_bias=False)
    kern = conv.weight.detach().numpy().transpose(2, 3, 1, 0)
    ref = jconv.apply({"params": {"kernel": jnp.asarray(kern)}},
                      jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert ours.shape[-1] == -(-size // stride)
    np.testing.assert_allclose(ours, np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)


def test_encoder_round_trip_is_bit_exact():
    _, sd, _, variables = _encoder_pair(32)
    back = efficientnet_state_dict_from_jax(*(np_tree(t) for t in variables))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_depth_stops_the_forward_and_builds_every_block():
    enc = EfficientNetEncoder(B0, depth=3).eval()
    assert len(enc._blocks) == 16
    with torch.no_grad():
        feats = enc(torch.zeros(1, 3, SIZE, SIZE))
    assert [f.shape[1] for f in feats] == feature_channels(B0)[:3]


# -- FPN/efficientnet-b0 ---------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    model = build_model(port_cfg("fpn", backbone=B0))
    return far_from_unit_stats(seeded_state_dict(model, seed=31), seed=32)


@pytest.fixture(scope="module")
def jax_pair(weights):
    jmodel = jax_build_model(jax_cfg("fpn", backbone=B0))
    return jmodel, jax_variables(jmodel, weights, convert_smp_fpn_state_dict)


def _fpn(sd, **kw):
    model = FPN(output_size=SIZE, backbone=B0, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_fpn_eval_forward_matches_flax(weights, jax_pair):
    assert_forward_matches(_fpn(weights), *jax_pair, train=False, seed=0)


def test_fpn_train_forward_with_batch_statistics_matches_flax(weights,
                                                              jax_pair):
    with flax_dropout_off():
        assert_forward_matches(_fpn(weights, dropout=0.0), *jax_pair,
                               train=True, seed=1, n=4)


def test_fpn_round_trip_through_jax_is_bit_exact(weights, jax_pair):
    assert_round_trip(weights, jax_pair[1], fpn_state_dict_from_jax)


def test_infer_step_without_the_fold_matches_jax(weights, jax_pair):
    """The serving step on the EfficientNet stem (3×3, no normalize fold:
    ``eval_images`` in the compute dtype, as the JAX step's
    ``eval_transform`` branch) against the JAX infer step at 5e-4, f32,
    at the tile size and from a larger tile."""
    from collections import namedtuple

    model = _fpn(weights).train()
    jmodel, (params, batch_stats) = jax_pair
    state = namedtuple("_S", "params batch_stats")(params, batch_stats)
    for size in (SIZE, 80):
        imgs = np.random.default_rng(size).integers(
            0, 256, (2, size, size, 3), dtype=np.uint8)
        ours = make_infer_step(model, SIZE)(torch.from_numpy(imgs)).numpy()
        ref = np.asarray(jax_make_infer_step(jmodel, SIZE)(
            state, jnp.asarray(imgs)))
        assert ours.shape == (2, SIZE, SIZE) and not model.training
        np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-4)


@pytest.fixture(scope="module")
def step(weights):
    return one_step("fpn", _fpn(weights, dropout=0.0), weights,
                    convert_smp_fpn_state_dict, fpn_state_dict_from_jax,
                    jax_grads=False, backbone=B0)


def test_train_step_loss_and_score_match_jax(step):
    assert_step_loss_and_score(step)


def test_train_step_gradients_match_jax_in_float64(step, weights, jax_pair):
    """The gradients in float64 on both sides at the ResUNet test's bound.
    In f32 the two sides agree but for gradients that are zero save for
    rounding (a block's last BN bias ahead of the next block's expand conv
    and batch-statistics BN: about 1e-8 on both sides, in different
    places, against a bound of 2e-3 of that noise), so they are compared
    in float64, as U-Net++'s are."""
    from pdac_pathological_image_segmentation_tpu.models.fpn import (
        FPN as JaxFPN,
    )

    ours, theirs = f64_gradients(
        "fpn", _fpn(weights, dropout=0.0),
        JaxFPN(output_size=SIZE, backbone=B0, use_pallas=False,
               dtype=jnp.float64),
        jax_pair[1], fpn_state_dict_from_jax)
    assert sorted(ours) == sorted(theirs) == sorted(step["grads"])
    for k, g in ours.items():
        want = theirs[k].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max() + 1e-9,
                                   err_msg=k)


def test_train_step_adam_update_matches_jax(step):
    """Every parameter within ``2·lr`` of JAX's after Adam, and within 1e-6
    where ``|g| > 1e-4`` (U-Net++'s bound): there Adam's step moves by at
    most ``lr·eps/g² = 1e-3`` of a gradient error, so the f32 gradients'
    rounding moves it by less than 1e-6."""
    assert_step_adam(step, clear_above=1e-4)


def test_train_step_batchnorm_stats_match_jax(step):
    """Every BatchNorm of the encoder runs (momentum 0.01) and matches
    flax: the stem's and 16 blocks' (the first without an expand conv)."""
    ran = assert_step_batchnorm(step)
    assert len(ran) == 1 + 15 * 3 + 2


def test_unetplusplus_eval_forward_matches_flax():
    """UNet++ on efficientnet-b0: the encoder through the JAX
    ``convert_encoder_state_dict``, the nodes by name."""
    from test_torch_unetplusplus import NODES
    from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
        _graft_bn,
        _graft_conv,
    )

    def to_flax(sd, params, batch_stats):
        params, batch_stats = convert_encoder_state_dict(
            {k[len("encoder."):]: v for k, v in sd.items()
             if k.startswith("encoder.")}, params, batch_stats)
        params, batch_stats = np_tree(params), np_tree(batch_stats)
        for i, j in NODES:
            name = f"x_{i}_{j}"
            for k in (0, 1):
                _graft_conv(sd, params[name][f"conv{k}"], f"{name}.conv{k}")
                _graft_bn(sd, params[name][f"bn{k}"],
                          batch_stats[name][f"bn{k}"], f"{name}.bn{k}")
        _graft_conv(sd, params["head"], "head", bias=True)
        return params, batch_stats

    model = build_model(port_cfg("unet++", backbone=B0))
    sd = far_from_unit_stats(seeded_state_dict(model, seed=33), seed=34)
    model.load_state_dict(sd, strict=True)
    jmodel = jax_build_model(jax_cfg("unet++", backbone=B0))
    variables = jax_variables(jmodel, sd, to_flax)
    assert_forward_matches(model, jmodel, variables, train=False, seed=5)
    assert_round_trip(sd, variables, unetplusplus_state_dict_from_jax)


# -- a reference smp checkpoint ----------------------------------------------

def smp_state_dict(sd, seed: int = 35) -> OrderedDict:
    """smp's FPN/EfficientNet ``state_dict`` for the port's ``sd``: the
    encoder keeps efficientnet-pytorch's ``_conv_head`` and ``_bn1``
    (1280·w channels) after its blocks, which smp never runs."""
    rng = np.random.default_rng(seed)
    cin = sd["encoder._blocks.15._project_conv.weight"].shape[0]
    head = OrderedDict()
    head["encoder._conv_head.weight"] = torch.from_numpy(
        rng.normal(0, cin ** -0.5, (1280, cin, 1, 1)).astype(np.float32))
    for leaf, v in (("weight", rng.uniform(0.5, 1.5, 1280)),
                    ("bias", rng.normal(0, 0.1, 1280)),
                    ("running_mean", rng.normal(0, 0.1, 1280)),
                    ("running_var", rng.uniform(0.5, 1.5, 1280))):
        head[f"encoder._bn1.{leaf}"] = torch.from_numpy(v.astype(np.float32))
    head["encoder._bn1.num_batches_tracked"] = torch.tensor(0)
    out = OrderedDict()
    for k, v in sd.items():
        if not k.startswith("encoder.") and head:
            out.update(head)
            head = {}
        out[k] = v
    return out


@pytest.fixture(scope="module")
def reference(weights, tmp_path_factory):
    root = tmp_path_factory.mktemp("effnet_ref")
    smp = smp_state_dict(weights)
    pth = root / "pth" / "best.pth"
    pth.parent.mkdir()
    torch.save({"model": {f"module.{k}": v for k, v in smp.items()},
                "optimizer": {}, "epoch": 2, "previous_best": 0.5}, pth)
    data = root / "test"
    generate_synthetic_patches(str(data), n=8, size=SIZE, seed=9)
    raw = raw_cfg("fpn", backbone=B0, batch_size=4, num_worker=2,
                  test_path=str(data))
    (root / "cfg.yaml").write_text(yaml.safe_dump(raw))
    return {"root": root, "pth": pth, "raw": raw, "smp": smp}


def test_reference_pth_with_the_unrun_head_loads_and_exports(reference,
                                                            weights):
    """The smp file's ``encoder._conv_head``/``encoder._bn1`` are dropped
    (not the blocks' own ``_bn1``) and the rest loads strictly;
    ``cli.export`` writes the port's names only."""
    model = build_model(port_cfg("fpn", backbone=B0))
    sd = load_reference_state_dict(str(reference["pth"]))
    assert "encoder._conv_head.weight" in sd
    model.load_state_dict(drop_unbuilt_keys(model, sd), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    assert "encoder._blocks.3._bn1.weight" in drop_unbuilt_keys(model, sd)
    out = reference["root"] / "ref.pdacpt"
    cli_export.main(["--config", str(reference["root"] / "cfg.yaml"),
                     "--pth_path", str(reference["pth"]), "--out", str(out)])
    meta, art = read_artifact(str(out))
    assert meta["backbone"] == B0 and sorted(art) == sorted(weights)


def test_cli_test_on_reference_pth_matches_jax_evaluator(reference):
    root = reference["root"]
    ours = cli_test.main(["--config", str(root / "cfg.yaml"), "--save_path",
                          str(root / "eval"), "--pth_path",
                          str(reference["pth"]), "--max_figures", "0",
                          "--device", "cpu"])
    jcfg = jax_cfg("fpn", **{k: v for k, v in reference["raw"].items()
                             if k not in ("model", "img_size",
                                          "compute_dtype", "lr")})
    ref = JaxEvaluator(jcfg, str(reference["pth"]),
                       mesh=create_mesh(1)).run(
        JaxPatchDataset(*jax_discover_split(jcfg.test_path), jcfg),
        verbose=False)
    assert ours["n_samples"] == 8
    assert abs(ours["test_score"] - ref["test_score"]) < 1e-3
    assert abs(ours["test_loss"] - ref["test_loss"]) < 1e-3


def test_reference_resume_puts_each_moment_on_its_parameter(reference,
                                                            tmp_path):
    """A reference ``latest.pth`` whose parameter list holds the unrun
    ``_conv_head``/``_bn1`` (no moments: they never had a gradient): every
    moment lands on the parameter whose name held it, as the JAX
    ``load_reference_checkpoint_full`` places it."""
    assert_reference_resume(reference["smp"], tmp_path, "fpn",
                            fpn_state_dict_from_jax, backbone=B0,
                            cold=("encoder._conv_head", "encoder._bn1."))

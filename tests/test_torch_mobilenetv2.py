"""The PyTorch port's MobileNetV2 encoder (``mobilenet_v2``) against the JAX
package, on the CPU at 64², f32.

One seeded ``state_dict`` in torchvision's names (BN running variances in
0.01-0.1, so a wrong BN eps shows) feeds both sides, the JAX side through
its ``convert_mobilenetv2_state_dict`` or the smp model converters that
dispatch to it:

* the names: ``tests/test_mobilenetv2.py``'s torchvision twin loads
  strictly and gives the same features;
* the features ``c1..c5`` at output strides 32 and 16 at the JAX
  encoder-golden bound (``rtol=atol=2e-4``), the dilated depthwise convs,
  and the round trip, bit-exact;
* DeepLabV3+/mobilenet_v2 (the stride-16 path): logits in eval and train
  mode at the golden bound, the round trip, one train step against the
  JAX step, the serving step (no normalize fold on this stem) against the
  JAX infer step, a reference resume with its Adam moments placed as the
  JAX ``load_reference_checkpoint_full`` places them;
* PSPNet/mobilenet_v2: logits, and the depth-3 cut (``features.7``-``18``
  built and saved, not run).
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.models.mobilenetv2 import (
    MobileNetV2Encoder as JaxMobileNetV2Encoder,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_infer_step as jax_make_infer_step,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_mobilenetv2_state_dict,
    convert_smp_deeplabv3plus_state_dict,
    convert_smp_pspnet_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.deeplabv3plus import (
    DeepLabV3Plus,
)
from pdac_pathological_image_segmentation_tpu_torch.models.encoders import (
    VALID_BACKBONES,
    build_encoder,
    encoder_feature_channels,
)
from pdac_pathological_image_segmentation_tpu_torch.models.mobilenetv2 import (
    MobileNetV2Encoder,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    parameter_names,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    deeplabv3plus_state_dict_from_jax,
    mobilenetv2_state_dict_from_jax,
    pspnet_state_dict_from_jax,
    seeded_state_dict,
)

from test_mobilenetv2 import _TorchMobileNetV2
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
    zero_variables,
)

MNV2 = "mobilenet_v2"
ENC_TOL = 2e-4  # tests/test_mobilenetv2.py:122


def _encoder_pair(output_stride: int):
    enc = MobileNetV2Encoder(output_stride).eval()
    sd = far_from_unit_stats(seeded_state_dict(enc, seed=1), seed=2)
    enc.load_state_dict(sd, strict=True)
    jenc = JaxMobileNetV2Encoder(output_stride=output_stride)
    v = zero_variables(jenc)
    params, batch_stats = convert_mobilenetv2_state_dict(
        {k: t.numpy() for k, t in sd.items()}, v["params"], v["batch_stats"],
        encoder_key=None)
    return enc, sd, jenc, (params, batch_stats)


# -- the encoder -------------------------------------------------------------

def test_valid_backbones_equal_the_jax_packages():
    from pdac_pathological_image_segmentation_tpu.models.encoders import (
        VALID_BACKBONES as JAX_BACKBONES,
        encoder_feature_channels as jax_channels,
    )

    assert VALID_BACKBONES == JAX_BACKBONES
    for backbone in VALID_BACKBONES:
        assert encoder_feature_channels(backbone) == jax_channels(backbone)
    with pytest.raises(ValueError, match="unknown backbone"):
        build_encoder("mobilenet_v3")


def test_twin_loads_strictly_and_matches():
    """The torchvision twin's ``features`` load strictly (torchvision's
    ``features.i.conv.j`` names) and give the same features; BN eps 1e-5,
    momentum 0.1, ReLU6 after every conv but the projections."""
    torch.manual_seed(7)
    twin = _TorchMobileNetV2().eval()
    enc = MobileNetV2Encoder().eval()
    enc.load_state_dict(twin.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        for ours, theirs in zip(enc(x), twin(x)):
            torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)
    bns = [m for m in enc.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.eps == 1e-5 and m.momentum == 0.1 for m in bns)
    assert sum(isinstance(m, torch.nn.ReLU6) for m in enc.modules()) == 35


@pytest.mark.parametrize("output_stride", [32, 16])
def test_encoder_features_match_jax(output_stride):
    """``c1..c5`` against the JAX encoder at the encoder-golden bound; at
    output stride 16 the depthwise convs of ``features.14``-``17`` take
    stride 1 and dilation 2 with padding 2, and c5 stays at stride 16."""
    enc, _, jenc, (params, batch_stats) = _encoder_pair(output_stride)
    x = np.random.default_rng(3).normal(size=(2, 3, SIZE, SIZE)).astype(
        np.float32)
    with torch.no_grad():
        ours = [f.numpy() for f in enc(torch.from_numpy(x))]
    theirs = jax.jit(lambda v, a: jenc.apply(v, a, train=False))(
        {"params": params, "batch_stats": batch_stats},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    strides = (2, 4, 8, 16, 16 if output_stride == 16 else 32)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape[1:] == (MobileNetV2Encoder.feature_channels()[i],
                               SIZE // strides[i], SIZE // strides[i])
        np.testing.assert_allclose(a, np.asarray(b).transpose(0, 3, 1, 2),
                                   rtol=ENC_TOL, atol=ENC_TOL,
                                   err_msg=f"c{i + 1}")
    for i, block in enumerate(enc.features):
        for name, mod in block.named_modules():
            if isinstance(mod, torch.nn.Conv2d) and mod.kernel_size == (3, 3):
                d = 2 if output_stride == 16 and 14 <= i <= 17 else 1
                stride = 2 if i in (0, 2, 4, 7) or (
                    i == 14 and output_stride == 32) else 1
                assert (mod.dilation, mod.padding, mod.stride) == (
                    (d, d), (d, d), (stride, stride)), (i, name)


def test_encoder_round_trip_is_bit_exact():
    _, sd, _, variables = _encoder_pair(32)
    back = mobilenetv2_state_dict_from_jax(*(np_tree(t) for t in variables))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


# -- DeepLabV3+/mobilenet_v2 ---------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    model = build_model(port_cfg("deeplabv3+", backbone=MNV2))
    return far_from_unit_stats(seeded_state_dict(model, seed=41), seed=42)


@pytest.fixture(scope="module")
def jax_pair(weights):
    jmodel = jax_build_model(jax_cfg("deeplabv3+", backbone=MNV2))
    return jmodel, jax_variables(jmodel, weights,
                                 convert_smp_deeplabv3plus_state_dict)


def _deeplab(sd, **kw):
    model = DeepLabV3Plus(output_size=SIZE, backbone=MNV2, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_deeplab_eval_forward_matches_flax(weights, jax_pair):
    assert_forward_matches(_deeplab(weights), *jax_pair, train=False, seed=0)


def test_deeplab_train_forward_with_batch_statistics_matches_flax(weights,
                                                                  jax_pair):
    with flax_dropout_off():
        assert_forward_matches(_deeplab(weights, dropout=0.0), *jax_pair,
                               train=True, seed=1, n=4)


def test_deeplab_round_trip_through_jax_is_bit_exact(weights, jax_pair):
    assert_round_trip(weights, jax_pair[1], deeplabv3plus_state_dict_from_jax)


def test_infer_step_without_the_fold_matches_jax(weights, jax_pair):
    """The serving step on torchvision's 3×3 MobileNetV2 stem (no normalize
    fold) against the JAX infer step at 5e-4, f32, from a train-mode
    model."""
    model = _deeplab(weights).train()
    jmodel, (params, batch_stats) = jax_pair
    state = namedtuple("_S", "params batch_stats")(params, batch_stats)
    imgs = np.random.default_rng(4).integers(0, 256, (3, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    ours = make_infer_step(model, SIZE)(torch.from_numpy(imgs)).numpy()
    ref = np.asarray(jax_make_infer_step(jmodel, SIZE)(state,
                                                       jnp.asarray(imgs)))
    assert not model.training
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-4)


@pytest.fixture(scope="module")
def step(weights):
    return one_step("deeplabv3+", _deeplab(weights, dropout=0.0), weights,
                    convert_smp_deeplabv3plus_state_dict,
                    deeplabv3plus_state_dict_from_jax, backbone=MNV2)


def test_train_step_loss_and_score_match_jax(step):
    assert_step_loss_and_score(step)


def test_train_step_gradients_match_jax_in_float64(step, weights, jax_pair):
    """MobileNetV2's f32 gradients at 64² are ill-conditioned, as
    U-Net++'s are: against a float64 step, the port's and JAX's f32
    gradients each miss by up to 6% of a tensor's largest
    (``features.15``-``17``, the dilated stage, through BN backward sums
    that nearly cancel), in different places.  So the two sides are
    compared in float64, where every gradient is held at the ResUNet
    test's bound (measured 5.8e-7 of a tensor's largest)."""
    from pdac_pathological_image_segmentation_tpu.models.deeplabv3plus import (
        DeepLabV3Plus as JaxDeepLabV3Plus,
    )

    ours, theirs = f64_gradients(
        "deeplabv3+", _deeplab(weights, dropout=0.0),
        JaxDeepLabV3Plus(output_size=SIZE, backbone=MNV2, dtype=jnp.float64),
        jax_pair[1], deeplabv3plus_state_dict_from_jax)
    assert sorted(ours) == sorted(theirs) == sorted(step["grads"])
    for k, g in ours.items():
        want = theirs[k].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max() + 1e-9,
                                   err_msg=k)


def test_train_step_adam_update_matches_jax(step):
    """Every parameter within ``2·lr`` of JAX's after Adam, and within 1e-6
    where both f32 gradients exceed 1e-4 (U-Net++'s bound) with one sign:
    the f32 rounding above moves a few gradients across 0 or towards it
    (the stem's, by up to 1.7e-3), and Adam's first step, about
    ``lr·sign(g)``, moves with them.  The elements this leaves out of the
    1e-6 check although JAX's ``|g|`` exceeds 1e-4 are at most 2e-3 of all
    (measured 3,822 of 4,378,513)."""
    assert_step_adam(step, clear_above=1e-4, both_sides=True)
    left_out = 0
    for k, g in step["grads"].items():
        ours, theirs = g.numpy(), step["jgrads"][k].numpy()
        left_out += int(((np.abs(theirs) > 1e-4) & (
            (np.abs(ours) <= 1e-4) | (np.sign(ours) != np.sign(theirs)))).sum())
    assert left_out <= 2e-3 * sum(g.numel() for g in step["grads"].values())


def test_train_step_batchnorm_stats_match_jax(step):
    """Every BatchNorm runs: the encoder's 52 and the decoder's 9."""
    assert len(assert_step_batchnorm(step)) == 52 + 9


def test_reference_resume_puts_each_moment_on_its_parameter(weights,
                                                            tmp_path):
    assert_reference_resume(weights, tmp_path, "deeplabv3+",
                            deeplabv3plus_state_dict_from_jax, backbone=MNV2)


# -- PSPNet/mobilenet_v2 -------------------------------------------------------

def test_pspnet_forward_matches_flax_and_stops_at_c3():
    """PSPNet's depth-3 encoder on MobileNetV2: the logits against flax,
    the round trip, and ``features.7``-``18`` built, saved and not run:
    no gradient reaches them."""
    model = build_model(port_cfg("pspnet", backbone=MNV2))
    sd = far_from_unit_stats(seeded_state_dict(model, seed=43), seed=44)
    model.load_state_dict(sd, strict=True)
    assert "encoder.features.18.1.running_var" in sd
    jmodel = jax_build_model(jax_cfg("pspnet", backbone=MNV2))
    variables = jax_variables(jmodel, sd, convert_smp_pspnet_state_dict)
    assert_forward_matches(model, jmodel, variables, train=False, seed=5)
    assert_round_trip(sd, variables, pspnet_state_dict_from_jax)
    model.train()
    out = model(torch.zeros(2, 3, SIZE, SIZE), torch.Generator())
    out.sum().backward()
    unrun = [k for k in parameter_names(model)
             if dict(model.named_parameters())[k].grad is None]
    assert unrun and all(k.startswith("encoder.features.") and
                         int(k.split(".")[2]) >= 7 for k in unrun)
    assert len({k.split(".")[2] for k in unrun}) == 12



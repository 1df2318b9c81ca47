"""The PyTorch port's U-Net++ (``model: unet++``) against the JAX package,
on the CPU at 64², f32.

U-Net++ has no reference checkpoint, so the JAX package has no ``.pth``
converter for it: this file carries one (:func:`_to_flax`, the torchvision
encoder through the JAX ``convert_resnet_state_dict``, the decoder by
name), and the port's ``unetplusplus_state_dict_from_jax`` is held as its
inverse, bit-exact.  Through it one seeded ``state_dict`` feeds both
sides:

* the eval-mode and train-mode (batch-statistics BN) logits against flax
  at the golden bound (``rtol=2e-3, atol=5e-4``);
* one train step (``augment=False``) against the JAX ``make_train_step``:
  loss, score, Adam, BN, and the gradients in float64 on both sides (f32
  gradients of this model at 64² carry several per cent of rounding on
  either side);
* ``cli.train`` two epochs and a resume; an artifact's round trip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.models.unetplusplus import (
    UNetPlusPlus as JaxUNetPlusPlus,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    _graft_bn,
    _graft_conv,
    convert_resnet_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    export_serving_artifact,
    load_serving_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.unetplusplus import (
    UNetPlusPlus,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    seeded_state_dict,
    unetplusplus_state_dict_from_jax,
)

from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    SIZE,
    assert_cli_train_and_resume,
    assert_forward_matches,
    assert_round_trip,
    assert_step_adam,
    assert_step_batchnorm,
    assert_step_loss_and_score,
    f64_gradients,
    jax_cfg,
    jax_variables,
    np_tree,
    one_step,
    one_torch_thread,
    port_cfg,
)

MODEL = "unet++"
NODES = [(i, j) for j in range(1, 5) for i in range(5 - j)]


def _to_flax(sd, params, batch_stats):
    """The port's ``state_dict`` (numpy) into the JAX UNetPlusPlus's
    variables."""
    params, batch_stats = convert_resnet_state_dict(
        {k[len("encoder."):]: v for k, v in sd.items()
         if k.startswith("encoder.")}, params, batch_stats)
    params, batch_stats = np_tree(params), np_tree(batch_stats)
    for i, j in NODES:
        name = f"x_{i}_{j}"
        for k in (0, 1):
            _graft_conv(sd, params[name][f"conv{k}"], f"{name}.conv{k}")
            _graft_bn(sd, params[name][f"bn{k}"], batch_stats[name][f"bn{k}"],
                      f"{name}.bn{k}")
    _graft_conv(sd, params["head"], "head", bias=True)
    return params, batch_stats


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(build_model(port_cfg(MODEL)), seed=21)


@pytest.fixture(scope="module")
def jax_pair(weights):
    jmodel = jax_build_model(jax_cfg(MODEL))
    return jmodel, jax_variables(jmodel, weights, _to_flax)


def _port(sd):
    model = UNetPlusPlus(output_size=SIZE)
    model.load_state_dict(sd, strict=True)
    return model.eval()


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("backbone,c1", [("resnet18", 64), ("resnet34", 64),
                                         ("resnet50", 64)])
def test_build_model_gives_unetplusplus_with_flax_names(backbone, c1):
    """``unet++`` builds the port's model on each ResNet: the flax tree's
    names, row widths ``(32, 64, 128, 256)`` for rows 0..3, each node's
    input the dense skips plus the upsampled node below, logits at the
    tile size."""
    model = build_model(port_cfg(MODEL, backbone=backbone))
    assert isinstance(model, UNetPlusPlus) and not model.training
    sd = model.state_dict()
    feats = {"resnet50": [64, 256, 512, 1024, 2048]}.get(
        backbone, [64, 64, 128, 256, 512])
    assert feats[0] == c1
    width = {(i, 0): c for i, c in enumerate(feats)}
    for i, j in NODES:
        width[i, j] = (256, 128, 64, 32)[max(3 - i, 0)]
        cin = sum(width[i, k] for k in range(j)) + width[i + 1, j - 1]
        assert tuple(sd[f"x_{i}_{j}.conv0.weight"].shape) == (
            width[i, j], cin, 3, 3), (i, j)
        assert f"x_{i}_{j}.bn1.running_var" in sd
    assert tuple(sd["head.weight"].shape) == (1, 32, 3, 3)
    assert "head.bias" in sd
    with torch.no_grad():
        out = model(torch.zeros(1, 3, SIZE, SIZE))
    assert tuple(out.shape) == (1, 1, SIZE, SIZE) and out.dtype == torch.float32


def test_eval_forward_matches_flax(weights, jax_pair):
    assert_forward_matches(_port(weights), *jax_pair, train=False, seed=0)


def test_train_forward_with_batch_statistics_matches_flax(weights, jax_pair):
    assert_forward_matches(_port(weights), *jax_pair, train=True, seed=1,
                           n=4)


def test_state_dict_round_trip_through_jax_is_bit_exact(weights, jax_pair):
    assert_round_trip(weights, jax_pair[1], unetplusplus_state_dict_from_jax)


# -- one train step against JAX ------------------------------------------------

@pytest.fixture(scope="module")
def step(weights):
    return one_step(MODEL, _port(weights), weights, _to_flax,
                    unetplusplus_state_dict_from_jax, jax_grads=False)


def test_train_step_loss_and_score_match_jax(step):
    assert_step_loss_and_score(step)


def test_train_step_gradients_match_jax_in_float64(step, weights,
                                                   jax_pair):
    """U-Net++'s f32 gradients at 64² are ill-conditioned: against a
    float64 step, the port's and JAX's f32 gradients each miss by up to
    7% of a tensor's largest (BN backward sums that nearly cancel), in
    different places, so the two f32 sides are compared in float64
    instead.  There every gradient is held at the ResUNet test's bound
    (2e-3 of the tensor's largest plus 2e-3 relative; measured 2.7e-7),
    and the port's f32 gradients within 2e-2 (L2, relative) of the
    float64 ones (measured up to 1.55e-2, JAX's f32 the same)."""
    ours, theirs = f64_gradients(
        MODEL, _port(weights), JaxUNetPlusPlus(output_size=SIZE,
                                               dtype=jnp.float64),
        jax_pair[1], unetplusplus_state_dict_from_jax)
    assert sorted(ours) == sorted(theirs) == sorted(step["grads"])
    for k, g in ours.items():
        want = theirs[k].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * scale + 1e-12, err_msg=k)
        assert g.abs().sum() > 0, k
        g32 = step["grads"][k].double()
        assert float((g32 - g).norm() / g.norm()) < 2e-2, k


def test_train_step_adam_update_matches_jax(step):
    """Every parameter within ``2·lr`` of JAX's after Adam, and within 1e-6
    where ``|g| > 1e-4``: there Adam's step moves by at most
    ``lr·eps/g² = 1e-3`` of a gradient error, so the f32 gradients'
    rounding (above) moves it by less than 1e-6."""
    assert_step_adam(step, clear_above=1e-4)


def test_train_step_batchnorm_stats_match_jax(step):
    ran = assert_step_batchnorm(step)
    assert len(ran) == 20 + 2 * len(NODES)


# -- the entry points ------------------------------------------------------------

def test_cli_train_two_epochs_then_resumes(tmp_path, capsys):
    assert_cli_train_and_resume(MODEL, tmp_path, capsys)


def test_artifact_serves_what_the_model_serves(weights, tmp_path):
    """Export → load → call equals the model's own infer step, bitwise."""
    out = tmp_path / "unetpp.pdacpt"
    export_serving_artifact(port_cfg(MODEL), weights, str(out))
    art = load_serving_artifact(str(out), device="cpu")
    tiles = np.random.default_rng(3).integers(0, 256, (2, SIZE, SIZE, 3),
                                              dtype=np.uint8)
    want = make_infer_step(_port(weights), SIZE)(torch.from_numpy(tiles))
    np.testing.assert_array_equal(art(tiles), want.numpy())
    assert art.meta["model"] == MODEL

"""Multi-class training and evaluation (BASELINE.json configs #2 and #3) in
the PyTorch port against the JAX package, on the CPU at 64², f32.

* The objectives of ``num_classes: 3``: softmax Dice (``loss: dice``) and
  Dice + CE (``loss: dice_ce``, default and custom ``dice_weight``/
  ``ce_weight``), each with and without ``class_weights`` and a
  wrap-padded sample: loss, macro hard Dice and the logits' gradients
  within 1e-6, the argmax equal.
* One 3-class train step (``augment=False``, dropout off) for ResUNet with
  Dice + CE and class weights, and for UNet++ with softmax Dice, against
  the JAX ``make_train_step`` at the binary steps' bounds (UNet++'s
  gradients in float64, as its binary test holds them).

``cli.train`` and ``cli.test`` on three classes are in
``tests/test_torch_multiclass_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.models.unetplusplus import (
    UNetPlusPlus as JaxUNetPlusPlus,
)
from pdac_pathological_image_segmentation_tpu.train.objective import (
    make_objective as jax_make_objective,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_resunet_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    resunet_state_dict_from_jax,
    seeded_state_dict,
    unetplusplus_state_dict_from_jax,
)

from test_torch_unetplusplus import _to_flax as unetplusplus_to_flax
from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    SIZE,
    assert_step_adam,
    assert_step_batchnorm,
    assert_step_gradients,
    assert_step_loss_and_score,
    f64_gradients,
    jax_cfg,
    jax_variables,
    one_step,
    one_torch_thread,
    port_cfg,
)

NC = 3
WEIGHTS = [1.0, 2.0, 2.0]
OBJECTIVES = {
    "dice": {"loss": "dice"},
    "dice_cw": {"loss": "dice", "class_weights": WEIGHTS},
    "dice_ce": {"loss": "dice_ce"},
    "dice_ce_cw": {"loss": "dice_ce", "class_weights": WEIGHTS},
    "dice_ce_weighted": {"loss": "dice_ce", "dice_weight": 0.7,
                         "ce_weight": 0.3, "class_weights": WEIGHTS},
}


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_multiclass_objective_matches_jax(name, with_valid):
    """NCHW logits on the port, NHWC on JAX: the loss, the score and the
    logits' gradients within 1e-6, the argmax equal."""
    rng = np.random.default_rng(len(name))
    logits = rng.normal(0, 2, (3, NC, 16, 16)).astype(np.float32)
    masks = rng.integers(0, NC, (3, 16, 16)).astype(np.float32)
    valid = np.array([True, False, True]) if with_valid else None
    raw = {"num_classes": NC, **OBJECTIVES[name]}
    ours = make_objective(Config.from_dict(raw))
    ref = jax_make_objective(JaxConfig.from_dict(raw))
    assert ours.num_classes == ref.num_classes == NC
    tv = None if valid is None else torch.from_numpy(valid)
    jv = None if valid is None else jnp.asarray(valid)
    x = torch.from_numpy(logits).requires_grad_()
    loss = ours.loss_fn(x, torch.from_numpy(masks), tv)
    loss.backward()
    jx = jnp.asarray(logits.transpose(0, 2, 3, 1))
    jloss, jgrad = jax.value_and_grad(
        lambda z: ref.loss_fn(z, jnp.asarray(masks), jv))(jx)
    assert abs(float(loss) - float(jloss)) < 1e-6
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jgrad), rtol=0, atol=1e-6)
    score = ours.score_fn(x.detach(), torch.from_numpy(masks), tv)
    jscore = ref.score_fn(jx, jnp.asarray(masks), jv)
    assert abs(float(score) - float(jscore)) < 1e-6
    np.testing.assert_array_equal(ours.predict_fn(x.detach()).numpy(),
                                  np.asarray(ref.predict_fn(jx)))


# -- one 3-class train step against JAX ------------------------------------------

RESUNET_CFG = {"num_classes": NC, "loss": "dice_ce",
               "class_weights": WEIGHTS}


@pytest.fixture(scope="module")
def resunet_step():
    model = build_model(port_cfg("unet", **RESUNET_CFG))
    sd = seeded_state_dict(model, seed=17)
    model.load_state_dict(sd, strict=True)
    return one_step("unet", model, sd, convert_resunet_state_dict,
                    resunet_state_dict_from_jax, cfg_kw=RESUNET_CFG)


def test_resunet_3class_step_matches_jax(resunet_step):
    assert resunet_step["model"].num_classes == NC
    assert_step_loss_and_score(resunet_step)
    assert_step_gradients(resunet_step)
    assert_step_adam(resunet_step)
    assert len(assert_step_batchnorm(resunet_step)) > 0


UNETPP_CFG = {"num_classes": NC, "loss": "dice"}


@pytest.fixture(scope="module")
def unetplusplus():
    model = build_model(port_cfg("unet++", **UNETPP_CFG))
    sd = seeded_state_dict(model, seed=19)
    model.load_state_dict(sd, strict=True)
    return model, sd


def test_unetplusplus_3class_step_matches_jax(unetplusplus):
    """Loss, score, Adam (where ``|g| > 1e-4``, as the binary UNet++ test)
    and BN against the JAX step; the gradients in float64 on both sides
    at the binary test's bound."""
    model, sd = unetplusplus
    fresh = build_model(port_cfg("unet++", **UNETPP_CFG))
    fresh.load_state_dict(sd, strict=True)
    step = one_step("unet++", model, sd, unetplusplus_to_flax,
                    unetplusplus_state_dict_from_jax, jax_grads=False,
                    cfg_kw=UNETPP_CFG)
    assert_step_loss_and_score(step)
    assert_step_adam(step, clear_above=1e-4)
    assert_step_batchnorm(step)
    jmodel = JaxUNetPlusPlus(output_size=SIZE, num_classes=NC,
                             dtype=jnp.float64)
    variables = jax_variables(
        jax_build_model(jax_cfg("unet++", **UNETPP_CFG)), sd,
        unetplusplus_to_flax)
    ours, theirs = f64_gradients("unet++", fresh.eval(), jmodel, variables,
                                 unetplusplus_state_dict_from_jax,
                                 cfg_kw=UNETPP_CFG)
    assert sorted(ours) == sorted(theirs)
    for k, g in ours.items():
        want = theirs[k].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * scale + 1e-12, err_msg=k)

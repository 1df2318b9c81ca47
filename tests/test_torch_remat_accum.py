"""``remat`` and ``grad_accum_steps`` in the PyTorch port's train step, on
the CPU at 64², f32.

* ``remat: true`` equals the plain step, to the bit here (bound 1e-6):
  loss, score, every gradient, the BatchNorm buffers with
  ``num_batches_tracked`` (the recompute's BN update is put back) and the
  parameters after Adam, for FPN (GroupNorm) and for DeepLabV3+ with its
  ASPP dropout on (the recompute draws the first run's masks), with one
  and with two microbatches; a checkpoint that does not restore the
  step's generator draws other masks and differs.
* ``grad_accum_steps: 2`` and ``remat: true`` each against the JAX
  ``make_train_step`` with the same option (FPN, dropout off): loss and
  score, gradients (JAX's: the mean of ``jax.grad`` over the
  microbatches), Adam and BN at the binary step's bounds, BN chained
  through the microbatches.  A batch that k does not divide raises.
"""

import copy

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    make_optimizer,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_train_step,
    step_generator,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    fpn_state_dict_from_jax,
    seeded_state_dict,
)

from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    LR,
    SIZE,
    _batch,
    assert_step_adam,
    assert_step_batchnorm,
    assert_step_gradients,
    assert_step_loss_and_score,
    one_step,
    one_torch_thread,
    port_cfg,
)


def _run(model, step_kw, images, masks, valid):
    """One step of a copy of ``model``: loss, score, gradients, buffers
    and parameters after it."""
    model = copy.deepcopy(model)
    cfg = port_cfg(model.name)
    step = make_train_step(model, make_optimizer(model, LR), SIZE,
                           make_objective(cfg), augment=False, **step_kw)
    loss, score = step(images, masks, valid, step_generator(0, 0, 0))
    return (float(loss), float(score),
            {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: v.clone() for k, v in model.state_dict().items()})


def _seeded(name):
    model = build_model(port_cfg(name))
    model.load_state_dict(seeded_state_dict(model, seed=13), strict=True)
    model.name = name
    return model


def _inputs():
    images, masks, valid = _batch(3)
    return (torch.from_numpy(images), torch.from_numpy(masks),
            torch.from_numpy(valid))


def _assert_same(a, b, tol=1e-6):
    assert abs(a[0] - b[0]) <= tol and abs(a[1] - b[1]) <= tol
    assert sorted(a[2]) == sorted(b[2])
    for k in a[2]:
        torch.testing.assert_close(a[2][k], b[2][k], rtol=0, atol=tol,
                                   msg=k)
    for k in a[3]:  # parameters, running statistics, num_batches_tracked
        torch.testing.assert_close(a[3][k], b[3][k], rtol=0, atol=tol,
                                   msg=k)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", ["fpn", "deeplabv3+"])
def test_remat_step_equals_the_plain_step(name, k):
    model = _seeded(name)
    inputs = _inputs()
    plain = _run(model, {"grad_accum_steps": k}, *inputs)
    remat = _run(model, {"grad_accum_steps": k, "remat": True}, *inputs)
    _assert_same(plain, remat)
    bn = "encoder.bn1.num_batches_tracked"
    assert int(remat[3][bn]) == int(model.state_dict()[bn]) + k


def test_a_checkpoint_without_the_generator_restore_draws_other_masks():
    """The ASPP dropout draws from the step's generator: recomputed under a
    bare ``torch.utils.checkpoint`` (which restores only the default
    generators) it takes other masks, and the gradients differ from the
    plain step's, which the remat step's do not."""
    model = _seeded("deeplabv3+").train()
    images, masks, valid = _inputs()
    x = images.permute(0, 3, 1, 2).float() / 255.0
    obj = make_objective(port_cfg("deeplabv3+"))
    grads = []
    for bare in (False, True):
        net = copy.deepcopy(model)
        gen = step_generator(0, 0, 0)
        out = (checkpoint(lambda t: net(t, gen), x, use_reentrant=False)
               if bare else net(x, gen))
        obj.loss_fn(out, masks, valid).backward()
        grads.append(net.segmentation_head[0].weight.grad)
    assert (grads[0] - grads[1]).abs().max() > 1e-4


@pytest.fixture(scope="module")
def fpn_weights():
    model = FPN(output_size=SIZE, dropout=0.0)
    return seeded_state_dict(model, seed=3)


def _fpn(sd):
    model = FPN(output_size=SIZE, dropout=0.0)
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("step_kw", [{"grad_accum_steps": 2},
                                     {"remat": True}])
def test_step_option_matches_the_jax_step(fpn_weights, step_kw):
    step = one_step("fpn", _fpn(fpn_weights), fpn_weights,
                    convert_smp_fpn_state_dict, fpn_state_dict_from_jax,
                    step_kw=step_kw)
    assert_step_loss_and_score(step)
    assert_step_gradients(step)
    assert_step_adam(step)
    assert_step_batchnorm(step, micro=step_kw.get("grad_accum_steps", 1))


def test_a_batch_the_microbatches_do_not_divide_raises():
    model = _seeded("fpn")
    step = make_train_step(model, make_optimizer(model, LR), SIZE,
                           make_objective(port_cfg("fpn")), augment=False,
                           grad_accum_steps=3)
    with pytest.raises(ValueError, match="grad_accum_steps=3"):
        step(*_inputs(), step_generator(0, 0, 0))
    with pytest.raises(ValueError, match=">= 1"):
        make_train_step(model, make_optimizer(model, LR), SIZE,
                        make_objective(port_cfg("fpn")), grad_accum_steps=0)

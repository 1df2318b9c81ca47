"""The PyTorch port's ResUNet (``model: unet``) against the JAX package.

On the CPU at 64², from one seeded ``state_dict`` in the reference's names
fed to both sides (the JAX side through ``convert_resunet_state_dict``):

* the eval-mode and train-mode (batch-statistics BN) forwards, f32;
* the bf16 serving path with ``head_dtype: bfloat16`` against the JAX
  infer step, and the ``resunet_state_dict_from_jax`` round trip;
* one train step (``augment=False``, batch 4 with one wrap-padded sample)
  against the JAX ``make_train_step``: loss, score, every gradient, the
  parameters after Adam, BN statistics; and the bf16 ``augment=False``
  step's model input and loss (ROADMAP Queue 3 item 2);
* reference-shaped checkpoints (``module.`` keys, ``encoder.fc.*``, Adam
  positions that count fc): served, and resumed with every moment on its
  own parameter, as the JAX ``load_reference_checkpoint_full`` places it.

``cli.train`` with ``model: unet`` is in ``tests/test_torch_train.py``, the
unet artifact in ``tests/test_torch_serve.py``.
"""

import math
from collections import OrderedDict, namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.ops.augment import (
    eval_transform as jax_eval_transform,
)
from pdac_pathological_image_segmentation_tpu.train.objective import (
    make_objective as jax_make_objective,
)
from pdac_pathological_image_segmentation_tpu.train.state import (
    create_train_state,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_infer_step as jax_make_infer_step,
    make_train_step as jax_make_train_step,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_resunet_state_dict,
    load_reference_checkpoint_full,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    export as cli_export,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.evaluate import (
    load_serving_state,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    read_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.resunet import (
    ResUNet,
)
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    restore_checkpoint,
)
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    BN_BUFFERS,
    make_optimizer,
    parameter_names,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
    make_train_step,
    step_generator,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    resunet_state_dict_from_jax,
    seeded_state_dict,
)

SIZE = 64
LR = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(dtype="float32", head="float32", **kw):
    return Config.from_dict({"model": "unet", "img_size": SIZE,
                             "compute_dtype": dtype, "head_dtype": head,
                             "lr": LR, **kw})


def _jax_cfg(dtype="float32", head="float32"):
    return JaxConfig.from_dict({"model": "unet", "img_size": SIZE,
                                "compute_dtype": dtype, "head_dtype": head,
                                "lr": LR})


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(build_model(_cfg()), seed=11)


def _jax_variables(sd, jmodel):
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, SIZE, SIZE, 3)),
        train=False)
    return convert_resunet_state_dict(
        {k: v.numpy() for k, v in sd.items()}, variables["params"],
        variables["batch_stats"])


def _port_model(sd, **kw):
    model = build_model(_cfg(**kw))
    model.load_state_dict(sd, strict=True)
    return model


# -- the model ---------------------------------------------------------------

def test_build_model_gives_resunet_with_reference_names():
    """``unet`` builds ResUNet on resnet18 whatever ``backbone`` says, with
    the reference's names (no ``encoder.fc``), and takes ``head_dtype``;
    ``layer1_barrier`` is accepted and changes nothing."""
    model = build_model(_cfg(backbone="resnet50", layer1_barrier=True))
    assert isinstance(model, ResUNet) and not model.training
    names = list(model.state_dict())
    assert names[0] == "encoder.conv1.weight"
    assert "encoder.layer4.1.bn2.running_var" in names
    assert not any(k.startswith("encoder.fc.") for k in names)
    assert names[-14:] == [f"{m}.{p}" for m in (
        "upconv1", "conv1", "upconv2", "conv2", "upconv3", "conv3", "conv4")
        for p in ("weight", "bias")]
    assert tuple(model.state_dict()["upconv1.weight"].shape) == (512, 256,
                                                                 2, 2)
    assert build_model(_cfg(head="bfloat16")).head_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="head_dtype"):
        build_model(_cfg(head="float16"))


def test_eval_forward_matches_flax(weights):
    """f32 eval mode against flax through ``convert_resunet_state_dict``, at
    ``tests/test_resunet_golden.py``'s bound."""
    jmodel = jax_build_model(_jax_cfg())
    params, batch_stats = _jax_variables(weights, jmodel)
    x = np.random.default_rng(0).normal(size=(2, 3, SIZE, SIZE)).astype(
        np.float32)
    with torch.no_grad():
        ours = _port_model(weights)(torch.from_numpy(x)).numpy()
    ref = jmodel.apply({"params": params, "batch_stats": batch_stats},
                       jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    assert ours.dtype == np.float32 and ours.shape == (2, 1, SIZE, SIZE)
    np.testing.assert_allclose(ours, np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-3, atol=2e-4)


def test_train_forward_with_batch_statistics_matches_flax(weights):
    """Train mode: BN normalizes with the batch's statistics on both sides
    (flax ``train=True``), f32, at the same bound."""
    jmodel = jax_build_model(_jax_cfg())
    params, batch_stats = _jax_variables(weights, jmodel)
    x = np.random.default_rng(1).normal(size=(4, 3, SIZE, SIZE)).astype(
        np.float32)
    model = _port_model(weights).train()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    ref, _ = jmodel.apply({"params": params, "batch_stats": batch_stats},
                          jnp.asarray(x.transpose(0, 2, 3, 1)), train=True,
                          mutable=["batch_stats"])
    np.testing.assert_allclose(ours, np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-3, atol=2e-4)


def test_bf16_head_serving_matches_jax(weights):
    """bf16 compute and ``head_dtype: bfloat16`` (the bench's serving
    program) through both infer steps.  The JAX step takes the sigmoid in
    bf16, the port in f32 of the same bf16 logits, so the two differ by
    the rounding of bf16 convolutions summed in two orders plus bf16's
    sigmoid: |Δp| ≤ 2⁻⁶ and ≥ 99.9% of the hard masks equal (measured at
    this seed: |Δp| 1.02e-2, 99.97% equal)."""
    jmodel = jax_build_model(_jax_cfg("bfloat16", "bfloat16"))
    params, batch_stats = _jax_variables(weights, jmodel)
    state = namedtuple("_S", "params batch_stats")(params, batch_stats)
    tiles = np.random.default_rng(2).integers(0, 256, (4, SIZE, SIZE, 3),
                                              dtype=np.uint8)
    model = _port_model(weights, dtype="bfloat16", head="bfloat16")
    ours = make_infer_step(model, SIZE)(torch.from_numpy(tiles)).numpy()
    ref = np.asarray(jax_make_infer_step(jmodel, SIZE)(
        state, jnp.asarray(tiles))).astype(np.float32)
    assert ours.dtype == np.float32 and ours.shape == (4, SIZE, SIZE)
    assert np.abs(ours - ref).max() <= 2 ** -6
    assert ((ours >= 0.5) == (ref >= 0.5)).mean() >= 0.999


def test_state_dict_round_trip_through_jax_is_bit_exact(weights):
    jmodel = jax_build_model(_jax_cfg())
    params, batch_stats = _jax_variables(weights, jmodel)
    back = resunet_state_dict_from_jax(_np_tree(params), _np_tree(batch_stats))
    assert sorted(back) == sorted(weights)
    for k, v in weights.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


# -- one train step against JAX make_train_step ------------------------------

def _to_torch_names(tree, batch_stats):
    sd = resunet_state_dict_from_jax(_np_tree(tree), _np_tree(batch_stats))
    return {k: v for k, v in sd.items() if not k.endswith(BN_BUFFERS)}


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    masks = (rng.random((n, SIZE, SIZE)) < 0.4).astype(np.uint8)
    valid = np.array([True] * (n - 1) + [False])  # one wrap-padded sample
    return images, masks, valid


@pytest.fixture(scope="module")
def one_step(weights):
    images, masks, valid = _batch(0)
    model = _port_model(weights)
    opt = make_optimizer(model, LR)
    step = make_train_step(model, opt, SIZE, make_objective(_cfg()),
                           augment=False)
    loss, score = step(torch.from_numpy(images), torch.from_numpy(masks),
                       torch.from_numpy(valid), step_generator(0, 0, 0))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}

    jcfg = _jax_cfg()
    jmodel = jax_build_model(jcfg)
    state = create_train_state(jcfg, jmodel, jax.random.PRNGKey(0))
    params, batch_stats = convert_resunet_state_dict(
        {k: v.numpy() for k, v in weights.items()}, state.params,
        state.batch_stats)
    state = state.replace(params=params, batch_stats=batch_stats)
    jobj = jax_make_objective(jcfg)
    jvalid = jnp.asarray(valid)

    def loss_fn(p):
        imgs, msks = jax_eval_transform(jnp.asarray(images),
                                        jnp.asarray(masks), img_size=SIZE)
        out, _ = jmodel.apply({"params": p, "batch_stats": batch_stats},
                              imgs, train=True, mutable=["batch_stats"])
        return jobj.loss_fn(out, msks, jvalid)

    jgrads = jax.jit(jax.grad(loss_fn))(params)
    jstep = jax_make_train_step(jmodel, SIZE, objective=jobj, donate=False,
                                augment=False)
    new_state, jloss, jscore = jstep(state, jax.random.PRNGKey(1),
                                     jnp.asarray(images), jnp.asarray(masks),
                                     jvalid)
    return {
        "model": model, "loss": float(loss), "score": float(score),
        "grads": grads, "jloss": float(jloss), "jscore": float(jscore),
        "jgrads": _to_torch_names(jgrads, batch_stats),
        "jparams": resunet_state_dict_from_jax(
            _np_tree(new_state.params), _np_tree(new_state.batch_stats)),
    }


def test_train_step_loss_and_score_match_jax(one_step):
    """The FPN test's bounds: loss within 1e-5, the hard score within one
    pixel's weight (1e-3)."""
    assert math.isfinite(one_step["loss"])
    assert abs(one_step["loss"] - one_step["jloss"]) < 1e-5
    assert abs(one_step["score"] - one_step["jscore"]) < 1e-3


def test_train_step_gradients_match_jax_grad(one_step):
    """Every gradient within 2e-3 of that tensor's largest plus 2e-3
    relative, and every parameter's gradient nonzero."""
    grads, jgrads = one_step["grads"], one_step["jgrads"]
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        want = jgrads[k].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * scale + 1e-9, err_msg=k)
        assert g.abs().sum() > 0, k


def test_train_step_adam_update_matches_jax(one_step):
    """Every parameter within ``2·lr`` after one Adam step, and within 1e-6
    where the gradient is clearly nonzero (``|g| > 1e-5``)."""
    model, jparams = one_step["model"], one_step["jparams"]
    state = model.state_dict()
    for k in parameter_names(model):
        got, want = state[k].numpy(), jparams[k].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR, err_msg=k)
        clear = np.abs(one_step["jgrads"][k].numpy()) > 1e-5
        np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_train_step_batchnorm_stats_match_jax(one_step, weights):
    """Running means within 1e-5; running variances within 1e-4 relative
    once torch's unbiased batch variance is brought back to flax's biased
    one (the count each BN normalizes over, from a hook)."""
    model, jparams = one_step["model"], one_step["jparams"]
    state = model.state_dict()
    feats = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: feats.__setitem__(name, inp[0]))
        for name, m in model.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        model.eval()
        model(torch.zeros(4, 3, SIZE, SIZE))
    for h in hooks:
        h.remove()
    assert len(feats) == 20
    for name, x in feats.items():
        n = x.shape[0] * x.shape[2] * x.shape[3]
        np.testing.assert_allclose(state[f"{name}.running_mean"].numpy(),
                                   jparams[f"{name}.running_mean"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        old = weights[f"{name}.running_var"].numpy()
        b_torch = (state[f"{name}.running_var"].numpy() - 0.9 * old) / 0.1
        b_flax = (jparams[f"{name}.running_var"].numpy() - 0.9 * old) / 0.1
        np.testing.assert_allclose(b_torch * (n - 1) / n, b_flax, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_bf16_step_without_augmentation_normalizes_in_f32(weights):
    """ROADMAP Queue 3 item 2: with ``augment=False`` in bf16 the model gets
    ``eval_transform``'s float32 output, equal to the JAX step's, and
    rounds it once to bf16 at its input, as flax does at the stem; the loss
    agrees with the JAX bf16 step within 2e-3 (bf16 convolutions in two
    orders; measured 1.4e-4 at this seed)."""
    images, masks, valid = _batch(3)
    model = _port_model(weights, dtype="bfloat16")
    seen = []
    hook = model.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
    step = make_train_step(model, make_optimizer(model, LR), SIZE,
                           make_objective(_cfg("bfloat16")), augment=False)
    loss, _ = step(torch.from_numpy(images), torch.from_numpy(masks),
                   torch.from_numpy(valid), step_generator(0, 0, 0))
    hook.remove()
    ref, _ = jax_eval_transform(jnp.asarray(images), jnp.asarray(masks),
                                img_size=SIZE)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    assert seen[0].dtype == torch.float32
    np.testing.assert_array_equal(seen[0].numpy(), ref)
    np.testing.assert_array_equal(
        seen[0].to(torch.bfloat16).float().numpy(),
        np.asarray(jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32)))

    jcfg = _jax_cfg("bfloat16")
    jmodel = jax_build_model(jcfg)
    state = create_train_state(jcfg, jmodel, jax.random.PRNGKey(0))
    params, batch_stats = convert_resunet_state_dict(
        {k: v.numpy() for k, v in weights.items()}, state.params,
        state.batch_stats)
    state = state.replace(params=params, batch_stats=batch_stats)
    jstep = jax_make_train_step(jmodel, SIZE,
                                objective=jax_make_objective(jcfg),
                                donate=False, augment=False)
    _, jloss, _ = jstep(state, jax.random.PRNGKey(1), jnp.asarray(images),
                        jnp.asarray(masks), jnp.asarray(valid))
    assert abs(float(loss) - float(jloss)) < 2e-3


# -- reference checkpoints ---------------------------------------------------

def _reference_checkpoint(weights, seed=5, fc_moments=True):
    """A reference ResUNet ``latest.pth``: DDP ``module.`` keys, torchvision's
    ``encoder.fc`` after layer4, and Adam moments indexed by position in
    that list (fc included), as ``train_worker.py`` saves it.  Without
    ``fc_moments`` fc's positions have no state, as when it never had a
    gradient (DDP's ``find_unused_parameters``)."""
    rng = np.random.default_rng(seed)
    model_sd = OrderedDict()
    for k, v in weights.items():
        if k == "upconv1.weight":
            model_sd["encoder.fc.weight"] = torch.randn(1000, 512)
            model_sd["encoder.fc.bias"] = torch.randn(1000)
        model_sd[k] = v
    names = [k for k in model_sd if not k.endswith(BN_BUFFERS)]
    state = {}
    for i, k in enumerate(names):
        if k.startswith("encoder.fc.") and not fc_moments:
            continue
        shape = tuple(model_sd[k].shape)
        state[i] = {
            "step": torch.tensor(7.0),
            "exp_avg": torch.from_numpy(
                rng.normal(0, 1e-3, shape).astype(np.float32)),
            "exp_avg_sq": torch.from_numpy(
                rng.uniform(0, 1e-5, shape).astype(np.float32))}
    optimizer = {"state": state, "param_groups": [{
        "lr": 2.5e-5, "betas": (0.9, 0.999), "eps": 1e-8,
        "weight_decay": 0, "amsgrad": False,
        "params": list(range(len(names)))}]}
    return {"model": OrderedDict((f"module.{k}", v)
                                 for k, v in model_sd.items()),
            "optimizer": optimizer, "epoch": 6, "previous_best": 0.25}


def test_reference_pth_with_fc_serves(weights, tmp_path):
    """The reference file loads for serving (``encoder.fc`` dropped, the
    rest strict) through ``load_serving_state`` and ``cli.export``."""
    pth = tmp_path / "best.pth"
    torch.save(_reference_checkpoint(weights), pth)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({"model": "unet", "img_size": SIZE,
                                        "compute_dtype": "float32"}))
    model, path = load_serving_state(_cfg(), str(tmp_path), device="cpu")
    assert path == str(pth)
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    out = tmp_path / "unet.pdacpt"
    cli_export.main(["--config", str(cfg_path), "--pth_path", str(pth),
                     "--out", str(out)])
    _, sd = read_artifact(str(out))
    assert sorted(sd) == sorted(weights)


@pytest.mark.parametrize("fc_moments", [True, False])
def test_reference_resume_puts_each_moment_on_its_parameter(weights,
                                                            tmp_path,
                                                            fc_moments):
    """Resume from the reference ``latest.pth``: the weights load, and each
    Adam moment lands on the parameter whose name held it in the
    checkpoint, as the JAX ``load_reference_checkpoint_full`` maps it
    (mapped back to torch names: bit-equal), though fc shifts every
    decoder position by two.  The port keeps its own learning rate."""
    ckpt = _reference_checkpoint(weights, fc_moments=fc_moments)
    torch.save(ckpt, tmp_path / "latest.pth")
    model = build_model(_cfg())
    opt = make_optimizer(model, LR)
    meta = restore_checkpoint(str(tmp_path), model, opt)
    assert meta["epoch"] == 6 and meta["previous_best"] == 0.25
    assert opt.param_groups[0]["lr"] == LR
    names = parameter_names(model)
    ours = opt.state_dict()["state"]
    assert len(ours) == len(names)

    jcfg = _jax_cfg()
    template = create_train_state(jcfg, jax_build_model(jcfg),
                                  jax.random.PRNGKey(0))
    state, jmeta = load_reference_checkpoint_full(
        str(tmp_path / "latest.pth"), template, model_name="unet")
    assert jmeta["epoch"] == 6
    adam = next(n for n in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "mu"))
        if hasattr(n, "mu"))
    mu = _to_torch_names(adam.mu, state.batch_stats)
    nu = _to_torch_names(adam.nu, state.batch_stats)
    ref_names = [k.removeprefix("module.") for k in ckpt["model"]
                 if not k.endswith(BN_BUFFERS)]
    assert ref_names.index("upconv1.weight") == names.index(
        "upconv1.weight") + 2
    for i, name in enumerate(names):
        assert torch.equal(ours[i]["exp_avg"], mu[name]), name
        assert torch.equal(ours[i]["exp_avg_sq"], nu[name]), name
        src = ckpt["optimizer"]["state"][ref_names.index(name)]
        assert torch.equal(ours[i]["exp_avg"], src["exp_avg"]), name
    assert int(adam.count) == 7

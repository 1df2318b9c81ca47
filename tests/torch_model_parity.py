"""Shared checks of a port model against its JAX twin, for
``tests/test_torch_deeplab.py``, ``test_torch_pspnet.py``,
``test_torch_unetplusplus.py``, ``test_torch_mobilenetv2.py`` and
``test_torch_efficientnet.py`` (not a test module itself).

Everything runs on the CPU in f32 at 64²: one seeded ``state_dict`` in the
port's names feeds both sides (the JAX side through its converter), and
one train step (``augment=False``, batch 4 with one wrap-padded sample,
dropout off on both sides) is compared at ``tests/test_torch_resunet.py``'s
bounds.  The JAX models' dropout is switched off by
:func:`flax_dropout_off`, a test-local patch of ``flax.linen.Dropout``;
nothing in the JAX package changes.
"""

from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    TrainState,
    make_optimizer as jax_make_optimizer,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    BN_BUFFERS,
    make_optimizer,
    parameter_names,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_train_step,
    step_generator,
)

SIZE = 64
LR = 1e-3
# the JAX golden tests' logit bound (tests/test_deeplab_golden.py:174,
# tests/test_pspnet_golden.py:127)
LOGIT_RTOL, LOGIT_ATOL = 2e-3, 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """64² models: one intra-op thread is about as fast as many alone, and
    keeps a file's time steady when other test workers share the cores
    (as ``tests/test_torch_wsi.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def raw_cfg(model: str, **kw) -> dict:
    return {"model": model, "img_size": SIZE, "compute_dtype": "float32",
            "lr": LR, **kw}


def port_cfg(model: str, **kw) -> Config:
    return Config.from_dict(raw_cfg(model, **kw))


def jax_cfg(model: str, **kw) -> JaxConfig:
    return JaxConfig.from_dict(raw_cfg(model, **kw))


class _NoDropout:
    """Stands in for ``flax.linen.Dropout``: the identity."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    def __call__(self, x, *args, **kwargs):
        return x


@contextlib.contextmanager
def flax_dropout_off():
    """JAX models built and traced inside run without dropout."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        yield


def zero_variables(jmodel, size: int = SIZE) -> dict:
    """``jmodel``'s variables as zeros, shaped by ``jax.eval_shape`` of its
    init: nothing is compiled (a compiled flax init of an EfficientNet
    model takes about 10 s here, an eager one 30 s).  The converters
    overwrite every leaf, so a leaf they miss stays zero and shows."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, size, size, 3)),
        train=False))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes)


def jax_train_state(jcfg, jmodel):
    """The JAX ``create_train_state``'s state on :func:`zero_variables`."""
    variables = zero_variables(jmodel)
    tx = jax_make_optimizer(jcfg.lr)
    return TrainState(step=jnp.zeros((), jnp.int32),
                      params=variables["params"],
                      batch_stats=variables.get("batch_stats", {}),
                      opt_state=tx.init(variables["params"]), tx=tx)


def jax_variables(jmodel, sd, convert):
    """``(params, batch_stats)`` of ``jmodel`` holding the port's ``sd``."""
    variables = zero_variables(jmodel)
    return convert({k: v.numpy() for k, v in sd.items()},
                   variables["params"], variables["batch_stats"])


def assert_forward_matches(model, jmodel, variables, train: bool,
                           seed: int, n: int = 2) -> None:
    """The port's logits against flax's, eval mode or train mode (batch
    statistics on both sides), at the golden bound."""
    x = np.random.default_rng(seed).normal(size=(n, 3, SIZE, SIZE)).astype(
        np.float32)
    model.train(train)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    params, batch_stats = variables
    out = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=train, mutable=["batch_stats"] if train else False))(
        {"params": params, "batch_stats": batch_stats},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    ref = np.asarray(out[0] if train else out).transpose(0, 3, 1, 2)
    model.eval()
    assert ours.dtype == np.float32 and ours.shape == (n, 1, SIZE, SIZE)
    np.testing.assert_allclose(ours, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def far_from_unit_stats(sd, seed: int) -> dict:
    """``sd`` with every BatchNorm's running variance drawn from U(0.01,
    0.1) and its scale multiplied by the variance's square root, so that
    activations keep their size while the BN eps shows: 1e-3 against 1e-5
    moves a normalized value by up to 5%."""
    rng = np.random.default_rng(seed)
    out = dict(sd)
    for k in sd:
        if k.endswith(".running_var"):
            var = rng.uniform(0.01, 0.1, tuple(sd[k].shape)).astype(np.float32)
            bn = k[:-len("running_var")]
            out[k] = torch.from_numpy(var)
            out[bn + "weight"] = sd[bn + "weight"] * torch.from_numpy(
                np.sqrt(var))
    return out


def assert_round_trip(sd, variables, from_jax) -> None:
    back = from_jax(*(np_tree(t) for t in variables))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def _batch(seed, n=4, classes=1):
    """Images, masks (binary, or ids ``0..classes-1``) and ``valid``."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    if classes == 1:
        masks = (rng.random((n, SIZE, SIZE)) < 0.4).astype(np.uint8)
    else:
        masks = rng.integers(0, classes, (n, SIZE, SIZE), dtype=np.uint8)
    valid = np.array([True] * (n - 1) + [False])  # one wrap-padded sample
    return images, masks, valid


def one_step(model_name, model, sd, convert, from_jax,
             jax_grads: bool = True, backbone: str = "resnet18",
             cfg_kw: dict | None = None, step_kw: dict | None = None
             ) -> dict:
    """One train step of the port ``model`` (holding ``sd``, dropout off)
    and of the JAX model on ``backbone`` with dropout off: the loss, score,
    gradients, parameters after Adam and BN statistics of both, in the
    port's names.  Parameters that get no gradient on the port are left
    out of ``grads``; ``jax_grads=False`` skips ``jax.grad`` (``jgrads``
    None).  ``cfg_kw`` goes into both configs (``num_classes`` draws masks
    of that many classes), ``step_kw`` (``remat``, ``grad_accum_steps``)
    into both step factories; with ``grad_accum_steps = k`` JAX's gradient
    is the mean of ``jax.grad`` over the k microbatches."""
    cfg_kw, step_kw = cfg_kw or {}, step_kw or {}
    k = int(step_kw.get("grad_accum_steps", 1))
    images, masks, valid = _batch(0, classes=cfg_kw.get("num_classes", 1))
    opt = make_optimizer(model, LR)
    step = make_train_step(model, opt, SIZE,
                           make_objective(port_cfg(model_name, **cfg_kw)),
                           augment=False, **step_kw)
    loss, score = step(torch.from_numpy(images), torch.from_numpy(masks),
                       torch.from_numpy(valid), step_generator(0, 0, 0))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}

    jcfg = jax_cfg(model_name, backbone=backbone, **cfg_kw)
    with flax_dropout_off():
        jmodel = jax_build_model(jcfg)
        state = jax_train_state(jcfg, jmodel)
        params, batch_stats = convert(
            {k: v.numpy() for k, v in sd.items()}, state.params,
            state.batch_stats)
        state = state.replace(params=params, batch_stats=batch_stats)
        jobj = jax_make_objective(jcfg)

        def loss_fn(p, part):
            imgs, msks = jax_eval_transform(jnp.asarray(images[part]),
                                            jnp.asarray(masks[part]),
                                            img_size=SIZE)
            out, _ = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                  imgs, train=True, mutable=["batch_stats"])
            return jobj.loss_fn(out, msks, jnp.asarray(valid[part]))

        jgrads = None
        if jax_grads:
            m = len(images) // k
            parts = [jax.jit(jax.grad(loss_fn), static_argnums=1)(
                params, slice(i * m, (i + 1) * m)) for i in range(k)]
            jgrads = jax.tree_util.tree_map(lambda *g: sum(g) / k, *parts)
        jstep = jax_make_train_step(jmodel, SIZE, objective=jobj,
                                    donate=False, augment=False, **step_kw)
        new_state, jloss, jscore = jstep(state, jax.random.PRNGKey(1),
                                         jnp.asarray(images),
                                         jnp.asarray(masks),
                                         jnp.asarray(valid))
    jg = {} if jgrads is None else from_jax(np_tree(jgrads),
                                            np_tree(batch_stats))
    return {
        "model": model, "optimizer": opt, "sd": sd, "loss": float(loss),
        "score": float(score),
        "grads": grads, "jloss": float(jloss), "jscore": float(jscore),
        "jgrads": None if jgrads is None else {
            k: v for k, v in jg.items() if not k.endswith(BN_BUFFERS)},
        "jparams": from_jax(np_tree(new_state.params),
                            np_tree(new_state.batch_stats)),
    }


def assert_step_loss_and_score(step) -> None:
    """Loss within 1e-5, the hard score within one pixel's weight."""
    assert np.isfinite(step["loss"])
    assert abs(step["loss"] - step["jloss"]) < 1e-5
    assert abs(step["score"] - step["jscore"]) < 1e-3


def assert_step_gradients(step) -> None:
    """Every gradient within 2e-3 of that tensor's largest plus 2e-3
    relative, and nonzero."""
    for k, g in step["grads"].items():
        want = step["jgrads"][k].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * scale + 1e-9, err_msg=k)
        assert g.abs().sum() > 0, k


def assert_step_adam(step, clear_above: float = 1e-5,
                     both_sides: bool = False) -> None:
    """Every parameter within ``2·lr`` after Adam, and within 1e-6 where
    the gradient is clearly nonzero (``|g| > clear_above``: JAX's gradient,
    or the port's where ``step`` has no JAX gradients).  With
    ``both_sides``, where both sides' f32 gradients are clearly nonzero
    and have one sign: Adam's first step is ``lr·g/(|g| + eps)``, so there
    the two steps differ by less than ``lr·eps/clear_above``, while an f32
    rounding that shrinks a gradient towards 0 or flips its sign moves
    the step with it, which says nothing of Adam."""
    model, jparams = step["model"], step["jparams"]
    grads = step["jgrads"] or {k: g for k, g in step["grads"].items()}
    state = model.state_dict()
    for k in parameter_names(model):
        got, want = state[k].numpy(), jparams[k].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR, err_msg=k)
        clear = np.abs(grads[k].numpy()) > clear_above
        if both_sides:
            ours = step["grads"][k].numpy()
            clear &= (np.abs(ours) > clear_above) & (
                np.sign(grads[k].numpy()) == np.sign(ours))
        np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                   atol=1e-6, err_msg=k)


def batchnorm_inputs(model) -> dict:
    """Each BatchNorm2d that runs → its input at the step's shapes (from an
    eval forward of zeros at batch 4)."""
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
    return feats


def assert_step_batchnorm(step, micro: int = 1) -> list:
    """Running means within 1e-5; running variances within 1e-4 relative
    once torch's unbiased batch variance is brought back to flax's biased
    one (through each BatchNorm's own momentum).  With ``micro``
    microbatches the statistics chain through ``micro`` updates, each over
    a ``1/micro`` of the batch: the old value decays by ``(1 − m)^micro``
    and the rest is a sum of batch variances.  Returns the names of the
    BatchNorms that ran."""
    model, sd, jparams = step["model"], step["sd"], step["jparams"]
    state = model.state_dict()
    feats = batchnorm_inputs(model)
    for name, x in feats.items():
        n = x.shape[0] // micro * x.shape[2] * x.shape[3]
        np.testing.assert_allclose(state[f"{name}.running_mean"].numpy(),
                                   jparams[f"{name}.running_mean"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        m = model.get_submodule(name).momentum
        old = sd[f"{name}.running_var"].numpy() * (1 - m) ** micro
        b_torch = (state[f"{name}.running_var"].numpy() - old) / m
        b_flax = (jparams[f"{name}.running_var"].numpy() - old) / m
        np.testing.assert_allclose(b_torch * (n - 1) / n, b_flax, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    return sorted(feats)


def reference_checkpoint(sd, seed: int = 5, cold=None) -> dict:
    """A reference ``latest.pth`` of ``sd``: DDP ``module.`` keys and Adam
    moments indexed by position in the ``state_dict`` without BN buffers,
    as ``train_worker.py`` saves it.  Parameters whose name starts with
    one of ``cold`` never had a gradient and get no moments; by default
    ``encoder.layer3``/``encoder.layer4`` when ``sd`` is a PSPNet's."""
    rng = np.random.default_rng(seed)
    names = [k for k in sd if not k.endswith(BN_BUFFERS)]
    if cold is None:
        cold = (("encoder.layer3", "encoder.layer4")
                if "decoder.psp.blocks.0.pool.1.0.bias" in sd else ())
    state = {}
    for i, k in enumerate(names):
        if k.startswith(tuple(cold)):
            continue
        shape = tuple(sd[k].shape)
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
    return {"model": OrderedDict((f"module.{k}", v) for k, v in sd.items()),
            "optimizer": optimizer, "epoch": 6, "previous_best": 0.25}


def adam_moments_in_port_names(state, from_jax) -> tuple:
    """The JAX state's Adam ``(mu, nu, count)``, mu and nu in the port's
    names."""
    adam = next(n for n in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "mu"))
        if hasattr(n, "mu"))

    def names(tree):
        sd = from_jax(np_tree(tree), np_tree(state.batch_stats))
        return {k: v for k, v in sd.items() if not k.endswith(BN_BUFFERS)}

    return names(adam.mu), names(adam.nu), int(adam.count)


@functools.lru_cache(maxsize=None)
def _jax_template(model_name, backbone="resnet18"):
    """A JAX train state of ``model_name`` on ``backbone`` for the
    converters to fill."""
    jcfg = jax_cfg(model_name, backbone=backbone)
    return jax_train_state(jcfg, jax_build_model(jcfg))


def assert_reference_resume(sd, tmp_path, model_name, from_jax,
                            backbone: str = "resnet18", cold=None):
    """Resume the port from a reference ``latest.pth`` of ``sd`` (which may
    hold parameters the port does not build) with Adam moments on all but
    the ``cold`` parameters: the weights load strictly, each moment lands
    on the parameter whose name held it, as the JAX
    ``load_reference_checkpoint_full`` places it (bit-equal once mapped
    back), the port keeps its own learning rate.  Returns the
    optimizer."""
    from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
        load_reference_checkpoint_full,
    )
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
        restore_checkpoint,
    )

    ckpt = reference_checkpoint(sd, cold=cold)
    torch.save(ckpt, tmp_path / "latest.pth")
    model = build_model(port_cfg(model_name, backbone=backbone))
    opt = make_optimizer(model, LR)
    meta = restore_checkpoint(str(tmp_path), model, opt)
    assert meta["epoch"] == 6 and opt.param_groups[0]["lr"] == LR
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    state, _ = load_reference_checkpoint_full(
        str(tmp_path / "latest.pth"), _jax_template(model_name, backbone),
        model_name=model_name)
    mu, nu, count = adam_moments_in_port_names(state, from_jax)
    ours = opt.state_dict()["state"]
    names = parameter_names(model)
    ckpt_names = [k for k in sd if not k.endswith(BN_BUFFERS)]
    held = sorted(ckpt_names[int(i)] for i in ckpt["optimizer"]["state"])
    assert sorted(names[i] for i in ours) == held and count == 7
    for i in ours:
        name = names[i]
        assert torch.equal(ours[i]["exp_avg"], mu[name]), name
        assert torch.equal(ours[i]["exp_avg_sq"], nu[name]), name
    return opt


def assert_port_checkpoint_loads_into_jax(step, tmp_path, model_name,
                                          from_jax,
                                          backbone: str = "resnet18"):
    """The port's ``latest.pth`` after one train step: the JAX
    ``load_reference_checkpoint_full`` reads it, with the port's weights,
    BN statistics and Adam moments bit-equal once mapped back (zeros where
    the port holds no moment)."""
    from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
        load_reference_checkpoint_full,
    )
    from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
        EarlyStop,
    )

    model, opt = step["model"], step["optimizer"]
    save_checkpoint(str(tmp_path), model, opt, 0, 0.1,
                    {"lr": LR, "best": 0.1, "num_bad_epochs": 0},
                    EarlyStop().state_dict(), is_best=False)
    state, meta = load_reference_checkpoint_full(
        str(tmp_path / "latest.pth"), _jax_template(model_name, backbone),
        model_name=model_name)
    assert meta["epoch"] == 0
    back = from_jax(np_tree(state.params), np_tree(state.batch_stats))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    mu, nu, count = adam_moments_in_port_names(state, from_jax)
    ours = opt.state_dict()["state"]
    assert count == 1
    for i, name in enumerate(parameter_names(model)):
        if i in ours:
            assert torch.equal(ours[i]["exp_avg"], mu[name]), name
            assert torch.equal(ours[i]["exp_avg_sq"], nu[name]), name
        else:
            assert not mu[name].any() and not nu[name].any(), name


def assert_cli_train_and_resume(model_name, tmp_path, capsys,
                                backbone: str = "resnet18",
                                **extra) -> dict:
    """``cli.train --device cpu`` with ``model: model_name`` on
    ``backbone`` (bf16, 64², batch 4, 8 + 4 synthetic patches, ``extra``
    config keys): two finite epochs, both checkpoints, then a rerun with
    three epochs that resumes after the second.  Returns the first run's
    result."""
    import yaml

    from pdac_pathological_image_segmentation_tpu.data.synthetic import (
        generate_synthetic_patches,
    )
    from pdac_pathological_image_segmentation_tpu_torch.cli import (
        train as cli_train,
    )

    for split, n, seed in (("train", 8, 0), ("val", 4, 1)):
        generate_synthetic_patches(str(tmp_path / split), n=n, size=SIZE,
                                   seed=seed)
    cfg_path = tmp_path / "cfg.yaml"
    argv = ["--config", str(cfg_path), "--save_path", str(tmp_path / "out"),
            "--device", "cpu"]
    results = []
    for epochs in (2, 3):
        cfg_path.write_text(yaml.safe_dump({
            "train_path": str(tmp_path / "train"),
            "val_path": str(tmp_path / "val"), "model": model_name,
            "backbone": backbone, "img_size": SIZE, "batch_size": 4,
            "epochs": epochs, "lr": LR, "seed": 41, "num_worker": 2,
            "compute_dtype": "bfloat16", **extra}))
        results.append(cli_train.main(argv))
    assert [h["epoch"] for h in results[0]["history"]] == [0, 1]
    assert [h["epoch"] for h in results[1]["history"]] == [2]
    assert all(np.isfinite([h["train_loss"], h["val_loss"]]).all()
               for r in results for h in r["history"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    for name in ("latest.pth", "best.pth"):
        assert (tmp_path / "out" / "pth" / name).is_file()
    return results[0]


def f64_gradients(model_name, model, jmodel64, variables, from_jax,
                  cfg_kw: dict | None = None) -> tuple:
    """The gradients of the step's loss (the batch of :func:`one_step`,
    ``eval_transform``'s input, batch statistics, dropout off) in float64
    on both sides: a float64 copy of the port ``model``, and ``jmodel64``
    (the JAX model built with ``dtype=jnp.float64``) on ``variables`` (the
    same weights) cast to float64, under ``jax.enable_x64``.  Both heads
    still resize and score in float32, as in f32.  Returns ``(port,
    jax)``, in the port's names."""
    import copy

    from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
        eval_transform,
    )

    cfg_kw = cfg_kw or {}
    images, masks, valid = _batch(0, classes=cfg_kw.get("num_classes", 1))
    model = copy.deepcopy(model).double().train()
    model.compute_dtype = torch.float64
    imgs, msks = eval_transform(torch.from_numpy(images),
                                torch.from_numpy(masks), SIZE)
    out = model(imgs.double(), step_generator(0, 0, 0))
    make_objective(port_cfg(model_name, **cfg_kw)).loss_fn(
        out, msks, torch.from_numpy(valid)).backward()
    ours = {k: p.grad for k, p in model.named_parameters()
            if p.grad is not None}
    with jax.enable_x64(True), flax_dropout_off():
        params, batch_stats = (
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
            for t in variables)
        jimgs, jmsks = jax_eval_transform(jnp.asarray(images),
                                          jnp.asarray(masks), img_size=SIZE)
        jobj = jax_make_objective(jax_cfg(model_name, **cfg_kw))

        def loss_fn(p):
            out, _ = jmodel64.apply({"params": p, "batch_stats": batch_stats},
                                    jimgs.astype(jnp.float64), train=True,
                                    mutable=["batch_stats"])
            return jobj.loss_fn(out, jmsks, jnp.asarray(valid))

        jgrads = np_tree(jax.jit(jax.grad(loss_fn))(params))
    theirs = from_jax(jgrads, np_tree(batch_stats))
    return ours, {k: v for k, v in theirs.items()
                  if not k.endswith(BN_BUFFERS)}


def encoder_file_npz(path, seed: int = 0, nan_at: str | None = None) -> None:
    """A seeded torchvision resnet18 ImageNet file in the ``.npz`` layout
    (torch names, ``fc`` included); with ``nan_at``, that tensor's first
    element NaN."""
    from pdac_pathological_image_segmentation_tpu_torch.models.encoders import (
        build_encoder,
    )
    from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
        seeded_state_dict,
    )

    rng = np.random.default_rng(seed)
    arrays = {k: v.numpy().copy() for k, v in seeded_state_dict(
        build_encoder("resnet18"), seed=seed).items()}
    arrays["fc.weight"] = rng.normal(0, 0.05, (1000, 512)).astype(np.float32)
    arrays["fc.bias"] = np.zeros(1000, np.float32)
    if nan_at is not None:
        arrays[nan_at].flat[0] = np.nan
    np.savez(path, **arrays)


def write_class_patches(root, n: int, seed: int, classes: int = 3,
                        size: int = SIZE) -> None:
    """``n`` image/mask PNG pairs in the reference's layout whose masks
    hold class ids ``0..classes-1``: smooth colour noise with one tinted
    disc per class above 0, each class's disc its own tint."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    tints = rng.uniform(40, 220, (classes, 3))
    for i in range(n):
        img = rng.uniform(150, 230, (size, size, 3))
        img += rng.normal(0, 10, img.shape)
        mask = np.zeros((size, size), np.uint8)
        for c in range(1, classes):
            cy, cx = rng.integers(size // 6, 5 * size // 6, 2)
            r = rng.integers(size // 8, size // 4)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            mask[disc] = c
            img[disc] = 0.4 * img[disc] + 0.6 * tints[c]
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / f"patch_{i:04d}.png")
        Image.fromarray(mask).save(root / f"patch_{i:04d}-labelled.png")

"""The PyTorch port's FPN training path against the JAX package.

On the CPU every GroupNorm takes the plain forward and backward and the
augmentation its plain chain; the card's kernels are held against those in
``chip_smoke.py``.  Here, from one seeded smp-named ``state_dict`` in f32
at 64²:

* one train step (``augment=False``, dropout 0, batch 4 with one
  wrap-padded sample) against the JAX ``make_train_step``: loss, score,
  every parameter's gradient (JAX side by ``jax.grad`` of the same
  objective), the parameters after Adam, BN running means and variances;
* Dropout2d's law; the objective, the plateau scheduler and the early
  stop against the JAX ones; the loader's batches against the JAX
  loader's;
* ``cli.train --device cpu`` for two epochs on synthetic patches, its
  resume, and its ``latest.pth`` read by the JAX package's
  ``load_reference_checkpoint_full``.
"""

import csv
import math
import shutil
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.data.discovery import (
    discover_split as jax_discover_split,
)
from pdac_pathological_image_segmentation_tpu.data.loader import (
    PatchDataset as JaxPatchDataset,
    PatchLoader as JaxPatchLoader,
)
from pdac_pathological_image_segmentation_tpu.data.synthetic import (
    generate_synthetic_patches,
)
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.models.fpn import FPN as JaxFPN
from pdac_pathological_image_segmentation_tpu.ops import (
    augment as jax_augment,
)
from pdac_pathological_image_segmentation_tpu.ops.augment import (
    eval_transform as jax_eval_transform,
)
from pdac_pathological_image_segmentation_tpu.train.objective import (
    make_objective as jax_make_objective,
)
from pdac_pathological_image_segmentation_tpu.train.schedule import (
    ReduceLROnPlateau as JaxPlateau,
)
from pdac_pathological_image_segmentation_tpu.train.state import (
    create_train_state,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_infer_step as jax_make_infer_step,
    make_train_step as jax_make_train_step,
)
from pdac_pathological_image_segmentation_tpu.utils.meters import (
    EarlyStop as JaxEarlyStop,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_resunet_state_dict,
    convert_smp_fpn_state_dict,
    load_reference_checkpoint_full,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.cli import (
    export as cli_export,
    train as cli_train,
)
from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
    discover_split,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
    PatchLoader,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
    read_artifact,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.fpn import (
    FPN,
    Dropout2d,
)
from pdac_pathological_image_segmentation_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.augment import (
    draw_augment_scalars,
)
from pdac_pathological_image_segmentation_tpu_torch.train.loop import (
    TAGS,
    Trainer,
)
from pdac_pathological_image_segmentation_tpu_torch.train.objective import (
    make_objective,
)
from pdac_pathological_image_segmentation_tpu_torch.train.schedule import (
    ReduceLROnPlateau,
)
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    make_optimizer,
    parameter_names,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
    make_train_step,
    step_generator,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.meters import (
    EarlyStop,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    fpn_state_dict_from_jax,
    load_reference_state_dict,
    resunet_state_dict_from_jax,
    seeded_state_dict,
)

SIZE = 64
LR = 1e-3
BN_RUNNING = ("running_mean", "running_var", "num_batches_tracked")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_FROM_JAX = {"fpn": fpn_state_dict_from_jax,
             "unet": resunet_state_dict_from_jax}


def _to_torch_names(tree, batch_stats, model_name="fpn"):
    """A JAX parameter-shaped tree (params, gradients, Adam moments) in the
    port's names and layouts."""
    sd = _FROM_JAX[model_name](_np_tree(tree), _np_tree(batch_stats))
    return {k: v for k, v in sd.items() if not k.endswith(BN_RUNNING)}


# -- one train step against JAX make_train_step ------------------------------

@pytest.fixture(scope="module")
def one_step():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    masks = (rng.random((4, SIZE, SIZE)) < 0.4).astype(np.uint8)
    valid = np.array([True, True, True, False])  # one wrap-padded sample

    model = FPN(output_size=SIZE, dropout=0.0)
    sd = seeded_state_dict(model, seed=3)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model, LR)
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="float32", lr=LR)
    step = make_train_step(model, opt, SIZE, make_objective(cfg),
                           augment=False)
    loss, score = step(torch.from_numpy(images), torch.from_numpy(masks),
                       torch.from_numpy(valid), step_generator(0, 0, 0))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}

    jcfg = JaxConfig(model="fpn", img_size=SIZE, compute_dtype="float32",
                     lr=LR)
    jmodel = JaxFPN(output_size=SIZE, dropout=0.0, use_pallas=False)
    state = create_train_state(jcfg, jmodel, jax.random.PRNGKey(0))
    params, batch_stats = convert_smp_fpn_state_dict(
        {k: v.numpy() for k, v in sd.items()}, state.params,
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
        "sd": sd, "model": model, "loss": float(loss), "score": float(score),
        "grads": grads, "jloss": float(jloss), "jscore": float(jscore),
        "jgrads": _to_torch_names(jgrads, batch_stats),
        "jparams": fpn_state_dict_from_jax(_np_tree(new_state.params),
                                           _np_tree(new_state.batch_stats)),
    }


def test_train_step_loss_and_score_match_jax(one_step):
    """f32 on both sides: the loss within 1e-5 (the two frameworks' conv
    and reduction orders); the hard Dice score exactly unless a pixel sits
    on the 0.5 threshold, so within one pixel's weight (1e-3)."""
    assert math.isfinite(one_step["loss"])
    assert abs(one_step["loss"] - one_step["jloss"]) < 1e-5
    assert abs(one_step["score"] - one_step["jscore"]) < 1e-3


def test_train_step_gradients_match_jax_grad(one_step):
    """Every parameter's gradient against ``jax.grad`` of the same
    objective: within 2e-3 of the largest gradient of that tensor plus
    2e-3 relative (f32 convolutions summed in another order, through 20
    layers of backward, at 64² where BN statistics span few pixels)."""
    grads, jgrads = one_step["grads"], one_step["jgrads"]
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        want = jgrads[k].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * scale + 1e-9, err_msg=k)


def test_train_step_every_parameter_gets_a_gradient(one_step):
    """The autograd repair, slice-wide: every encoder, lateral, GroupNorm,
    segmentation-conv and head parameter has a nonzero gradient."""
    zero = [k for k, g in one_step["grads"].items() if not g.abs().sum() > 0]
    assert zero == []


def test_train_step_adam_update_matches_jax(one_step):
    """Parameters after Adam.  At step 1 Adam moves each weight by about
    ``lr·sign(g)``, so a gradient within its numerical error of zero may
    move either way: every parameter is held within ``2·lr``, and those
    whose gradient is clearly nonzero (``|g| > 1e-5``) within 1e-6."""
    model, jparams = one_step["model"], one_step["jparams"]
    names = parameter_names(model)
    state = model.state_dict()
    for k in names:
        got, want = state[k].numpy(), jparams[k].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR,
                                   err_msg=k)
        clear = np.abs(one_step["jgrads"][k].numpy()) > 1e-5
        np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_train_step_batchnorm_stats_match_jax(one_step):
    """Running means: torch's momentum 0.1 is flax's 0.9, within 1e-5.
    Running variances: torch folds in the unbiased batch variance, flax the
    biased one (``tests/test_torch_parity.py:143-148``); undoing the
    ``n/(n-1)`` factor, where n is the count of values each BN layer
    normalizes over, the two agree within 1e-4 relative."""
    model, sd, jparams = one_step["model"], one_step["sd"], one_step["jparams"]
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
    for name, x in feats.items():
        n = x.shape[0] * x.shape[2] * x.shape[3]
        np.testing.assert_allclose(state[f"{name}.running_mean"].numpy(),
                                   jparams[f"{name}.running_mean"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        old = sd[f"{name}.running_var"].numpy()
        b_torch = (state[f"{name}.running_var"].numpy() - 0.9 * old) / 0.1
        b_flax = (jparams[f"{name}.running_var"].numpy() - 0.9 * old) / 0.1
        np.testing.assert_allclose(b_torch * (n - 1) / n, b_flax, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_bf16_train_step_runs_batchnorm_and_gn_backward():
    """bf16 compute with float32 parameters, as the default config trains:
    BN in train mode takes the bf16 input, every GN input carries a
    ``grad_fn``, every parameter gets a finite nonzero gradient and stays
    float32, and the augmentation runs (the plain chain on the CPU)."""
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="bfloat16")
    model = build_model(cfg)
    opt = make_optimizer(model, LR)
    gn_inputs = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: gn_inputs.append(inp[0]))
        for m in model.modules() if type(m).__name__ == "GroupNormReLU"]
    step = make_train_step(model, opt, SIZE, make_objective(cfg))
    rng = np.random.default_rng(1)
    loss, score = step(
        torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), np.uint8)),
        torch.from_numpy(rng.integers(0, 2, (2, SIZE, SIZE), np.uint8)),
        torch.ones(2, dtype=torch.bool), step_generator(0, 0, 0))
    for h in hooks:
        h.remove()
    assert len(gn_inputs) == 7
    assert all(x.dtype == torch.bfloat16 and x.grad_fn is not None
               for x in gn_inputs)
    assert math.isfinite(float(loss)) and 0.0 <= float(score) <= 1.0
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, k
    assert int(model.encoder.bn1.num_batches_tracked) == 1


@pytest.mark.parametrize("model_name,convert", [
    ("fpn", convert_smp_fpn_state_dict), ("unet", convert_resunet_state_dict)])
def test_infer_step_puts_a_train_mode_model_in_eval_mode(model_name, convert):
    """A model the trainer left in train mode gives the JAX
    ``make_infer_step``'s probabilities (always ``train=False``: running
    statistics, no dropout) within the FPN bound, 5e-4, and is left in eval
    mode.  In train mode FPN's Dropout2d would need a generator and BN
    would take the batch's statistics."""
    cfg = Config(model=model_name, img_size=SIZE, compute_dtype="float32")
    model = build_model(cfg)
    sd = seeded_state_dict(model, seed=23)
    model.load_state_dict(sd, strict=True)
    model.train()
    imgs = np.random.default_rng(4).integers(0, 256, (3, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    ours = make_infer_step(model, SIZE)(torch.from_numpy(imgs)).numpy()
    assert not model.training

    jmodel = jax_build_model(JaxConfig(model=model_name, img_size=SIZE,
                                       compute_dtype="float32"))
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, SIZE, SIZE, 3)),
        train=False)
    params, batch_stats = convert({k: v.numpy() for k, v in sd.items()},
                                  variables["params"],
                                  variables["batch_stats"])
    state = namedtuple("_S", "params batch_stats")(params, batch_stats)
    ref = np.asarray(jax_make_infer_step(jmodel, SIZE)(state,
                                                       jnp.asarray(imgs)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-4)


def test_f32_step_augments_in_f32_as_jax():
    """With ``compute_dtype: float32`` the model's augmented input is the
    JAX ``train_transform(..., dtype=float32)`` of the step's draws (the
    JAX step sends a model that is not bf16 through that chain), within
    1e-6 plus 1e-6 relative (the two libraries' jitter tables and slot
    sums, one f32 rounding apart); the masks bitwise."""
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="float32")
    model = build_model(cfg)
    seen = {}
    model.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("x", args[0].detach().clone()))
    obj = make_objective(cfg)
    objective = obj._replace(loss_fn=lambda out, m, v: (
        seen.__setitem__("m", m.clone()), obj.loss_fn(out, m, v))[1])
    step = make_train_step(model, make_optimizer(model, LR), SIZE, objective)
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    masks = rng.integers(0, 2, (4, SIZE, SIZE), dtype=np.uint8)
    step(torch.from_numpy(images), torch.from_numpy(masks),
         torch.ones(4, dtype=torch.bool), step_generator(0, 0, 0))
    facs, ints = draw_augment_scalars(4, step_generator(0, 0, 0))
    assert seen["x"].dtype == torch.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_augment, "draw_augment_scalars",
                   lambda key, n, **kw: (jnp.asarray(facs.numpy()),
                                         jnp.asarray(ints.numpy())))
        jax.clear_caches()
        try:
            want, want_m = jax_augment.train_transform(
                jax.random.PRNGKey(0), jnp.asarray(images),
                jnp.asarray(masks), img_size=SIZE, dtype=jnp.float32)
        finally:
            jax.clear_caches()
    np.testing.assert_allclose(seen["x"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(seen["m"].numpy(), np.asarray(want_m))


# -- Dropout2d ---------------------------------------------------------------

def test_dropout2d_drops_whole_channels_at_rate_p():
    """Each (n, c) plane is either zero or scaled by 1/(1-p), the drop rate
    is p within 0.01 (5 standard errors over 32768 planes), the mask comes
    from the generator alone, and eval mode is the identity."""
    drop = Dropout2d(0.2).train()
    x = torch.rand(64, 512, 3, 3) + 0.5
    y = drop(x, torch.Generator().manual_seed(5))
    kept = (y != 0).reshape(64, 512, 9)
    assert (kept.all(dim=2) | (~kept).all(dim=2)).all()
    rate = 1.0 - kept.all(dim=2).float().mean().item()
    assert abs(rate - 0.2) < 0.01
    planes = kept.all(dim=2)
    torch.testing.assert_close(y[planes], x[planes] / 0.8)
    again = drop(x, torch.Generator().manual_seed(5))
    assert torch.equal(y, again)
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    assert drop.eval()(x) is x


# -- objective, plateau, early stop ------------------------------------------

@pytest.mark.parametrize("loss", ["dice", "dice_ce"])
@pytest.mark.parametrize("with_valid", [True, False])
def test_objective_matches_jax(loss, with_valid):
    """Loss and score on the same logits: f32 sums in two orders, 1e-6."""
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (3, 1, 16, 16)).astype(np.float32)
    masks = (rng.random((3, 16, 16)) < 0.5).astype(np.float32)
    valid = np.array([True, False, True]) if with_valid else None
    ours = make_objective(Config.from_dict({"loss": loss}))
    ref = jax_make_objective(JaxConfig.from_dict({"loss": loss}))
    tv = None if valid is None else torch.from_numpy(valid)
    jv = None if valid is None else jnp.asarray(valid)
    for ours_fn, ref_fn in ((ours.loss_fn, ref.loss_fn),
                            (ours.score_fn, ref.score_fn)):
        got = float(ours_fn(torch.from_numpy(logits), torch.from_numpy(masks),
                            tv))
        want = float(ref_fn(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                            jnp.asarray(masks), jv))
        assert abs(got - want) < 1e-6, (got, want)


SCORES = [0.1, 0.3, 0.3, 0.30005, 0.2999, 0.31, 0.5, 0.5, 0.49, 0.48, 0.6,
          0.6001, 0.59, 0.58, 0.57, 0.56]


def test_plateau_matches_jax_with_an_absolute_threshold():
    ours, ref = ReduceLROnPlateau(1e-3), JaxPlateau(1e-3)
    lrs = []
    for s in SCORES:
        lrs.append(ours.step(s))
        assert lrs[-1] == ref.step(s)
        assert ours.state_dict() == ref.state_dict()
    assert min(lrs) < 1e-3  # the sequence does reduce the rate
    # 0.30005 is within the absolute 1e-4 threshold of 0.3: a bad epoch
    assert ours.num_bad_epochs == ref.num_bad_epochs


def test_early_stop_matches_jax():
    ours, ref = EarlyStop(patience=3, delta=0.02), JaxEarlyStop(3, 0.02)
    for s in SCORES:
        ours(s)
        ref(s)
        assert ours.state_dict() == ref.state_dict()
    assert ours.early_stop


# -- data --------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("patches")
    for split, n, seed in (("train", 10, 0), ("val", 4, 1)):
        generate_synthetic_patches(str(root / split), n=n, size=SIZE,
                                   seed=seed)
    return root


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_match_jax_loader(data_root, shuffle):
    """Same seed: the same pre-shuffle, epoch order, wrap-padding and
    bytes, batch for batch."""
    split = str(data_root / "train")
    cfg = Config(img_size=SIZE, seed=7)
    ours = PatchLoader(PatchDataset(*discover_split(split), cfg), 4,
                       shuffle=shuffle, device="cpu", num_workers=2)
    ref = JaxPatchLoader(JaxPatchDataset(*jax_discover_split(split),
                                         JaxConfig(img_size=SIZE, seed=7)),
                         4, shuffle=shuffle, num_workers=2)
    assert len(ours) == len(ref) == 3
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        want = list(ref.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.image.dtype == torch.uint8 and g.valid.dtype == torch.bool
            np.testing.assert_array_equal(g.image.numpy(), np.asarray(w.image))
            np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
            np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        assert got[-1].valid.tolist() == [True, True, False, False]


# -- the trainer -------------------------------------------------------------

def _write_cfg(path, data_root, epochs, model="fpn"):
    path.write_text(yaml.safe_dump({
        "train_path": str(data_root / "train"),
        "val_path": str(data_root / "val"),
        "model": model, "backbone": "resnet18", "img_size": SIZE,
        "batch_size": 4, "epochs": epochs, "lr": LR, "seed": 41,
        "num_worker": 2, "compute_dtype": "bfloat16"}))


def _train_two_epochs(data_root, run, model="fpn"):
    cfg_path = run / "cfg.yaml"
    _write_cfg(cfg_path, data_root, epochs=2, model=model)
    result = cli_train.main(["--config", str(cfg_path), "--save_path",
                             str(run / "out"), "--device", "cpu"])
    return run, cfg_path, result


@pytest.fixture(scope="module")
def trained(data_root, tmp_path_factory):
    return _train_two_epochs(data_root, tmp_path_factory.mktemp("run"))


@pytest.fixture(scope="module")
def trained_unet(data_root, tmp_path_factory):
    return _train_two_epochs(data_root, tmp_path_factory.mktemp("unet"),
                             model="unet")


def test_cli_train_two_epochs_writes_tags_and_checkpoints(trained):
    run, _, result = trained
    assert [h["epoch"] for h in result["history"]] == [0, 1]
    assert all(math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])
               for h in result["history"])
    with open(run / "out" / "log_dir" / "scalars.csv") as f:
        rows = list(csv.reader(f))
    assert sorted({r[1] for r in rows}) == sorted(TAGS)
    assert [r[0] for r in rows] == ["1"] * 4 + ["2"] * 4
    assert (run / "out" / "pth" / "latest.pth").is_file()
    assert (run / "out" / "pth" / "best.pth").is_file()
    # the serving side reads the port's own checkpoint like a reference one
    fresh = build_model(Config(model="fpn", img_size=SIZE))
    fresh.load_state_dict(load_reference_state_dict(
        str(run / "out" / "pth" / "best.pth")), strict=True)


def _assert_latest_pth_loads_into_the_jax_package(path, model_name):
    """``path`` through the JAX package's ``load_reference_checkpoint_full``:
    parameters, BN statistics and Adam moments arrive equal, bit for
    bit."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert {"model", "optimizer", "epoch", "previous_best"} <= set(ckpt)
    assert ckpt["epoch"] == 1
    jcfg = JaxConfig(model=model_name, img_size=SIZE, compute_dtype="float32")
    template = create_train_state(jcfg, jax_build_model(jcfg),
                                  jax.random.PRNGKey(0))
    state, meta = load_reference_checkpoint_full(str(path), template,
                                                 model_name=model_name)
    assert meta["epoch"] == 1
    back = _FROM_JAX[model_name](_np_tree(state.params),
                                 _np_tree(state.batch_stats))
    model_sd = {k.removeprefix("module."): v for k, v in ckpt["model"].items()}
    assert sorted(back) == sorted(model_sd)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, model_sd[k]), k
    adam = next(n for n in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "mu"))
        if hasattr(n, "mu"))
    mu = _to_torch_names(adam.mu, state.batch_stats, model_name)
    nu = _to_torch_names(adam.nu, state.batch_stats, model_name)
    names = [k for k in model_sd if not k.endswith(BN_RUNNING)]
    for idx, name in enumerate(names):
        entry = ckpt["optimizer"]["state"][idx]
        assert torch.equal(mu[name], entry["exp_avg"]), name
        assert torch.equal(nu[name], entry["exp_avg_sq"]), name
    assert int(adam.count) == int(ckpt["optimizer"]["state"][0]["step"])


def test_latest_pth_loads_into_the_jax_package(trained):
    """The port's FPN ``latest.pth`` in the JAX package."""
    run, _, _ = trained
    _assert_latest_pth_loads_into_the_jax_package(
        run / "out" / "pth" / "latest.pth", "fpn")


def test_unet_latest_pth_loads_into_the_jax_package(trained_unet):
    """The port's unet ``latest.pth`` in the JAX package (the ResUNet
    converter, transposed-conv taps flipped)."""
    run, _, _ = trained_unet
    _assert_latest_pth_loads_into_the_jax_package(
        run / "out" / "pth" / "latest.pth", "unet")


def test_cli_export_reads_the_ports_unet_checkpoint(trained_unet, tmp_path):
    """``cli.export`` takes the port's own unet ``best.pth`` (optimizer,
    scheduler and early-stop keys beside the weights); the artifact holds
    exactly the trained weights."""
    run, cfg_path, _ = trained_unet
    out = tmp_path / "unet.pdacpt"
    cli_export.main(["--config", str(cfg_path), "--pth_path",
                     str(run / "out" / "pth" / "best.pth"), "--out",
                     str(out)])
    meta, sd = read_artifact(str(out))
    assert meta["model"] == "unet" and meta["head_dtype"] == "float32"
    want = load_reference_state_dict(str(run / "out" / "pth" / "best.pth"))
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)


def _assert_resumes(trained, data_root, tmp_path, capsys, model="fpn"):
    run, _, _ = trained
    shutil.copytree(run / "out", tmp_path / "out")
    cfg_path = tmp_path / "cfg.yaml"
    _write_cfg(cfg_path, data_root, epochs=3, model=model)
    capsys.readouterr()
    result = cli_train.main(["--config", str(cfg_path), "--save_path",
                             str(tmp_path / "out"), "--device", "cpu"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert [h["epoch"] for h in result["history"]] == [2]
    with open(tmp_path / "out" / "log_dir" / "scalars.csv") as f:
        assert [r[0] for r in csv.reader(f)][-4:] == ["3"] * 4
    ckpt = torch.load(tmp_path / "out" / "pth" / "latest.pth",
                      weights_only=True)
    assert ckpt["epoch"] == 2


def test_cli_train_resumes(trained, data_root, tmp_path, capsys):
    """A rerun with ``epochs: 3`` on a copy of the first run's output
    resumes after epoch 2 (index 1) and trains one more epoch."""
    _assert_resumes(trained, data_root, tmp_path, capsys)


def test_cli_train_unet_two_epochs_then_resumes(trained_unet, data_root,
                                                tmp_path, capsys):
    """``model: unet`` through ``cli.train``: two finite epochs, then the
    resume (the trainer has nothing FPN-specific)."""
    _, _, result = trained_unet
    assert [h["epoch"] for h in result["history"]] == [0, 1]
    assert all(math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])
               for h in result["history"])
    _assert_resumes(trained_unet, data_root, tmp_path, capsys, model="unet")


def test_checkpoint_round_trip_restores_model_and_adam(tmp_path):
    cfg = Config(model="fpn", img_size=SIZE, compute_dtype="float32")
    model = build_model(cfg)
    opt = make_optimizer(model, LR)
    step = make_train_step(model, opt, SIZE, make_objective(cfg))
    rng = np.random.default_rng(4)
    step(torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), np.uint8)),
         torch.from_numpy(rng.integers(0, 2, (2, SIZE, SIZE), np.uint8)),
         torch.ones(2, dtype=torch.bool), step_generator(1, 0, 0))
    save_checkpoint(str(tmp_path), model, opt, 4, 0.5, {"lr": 1.0, "best": 0.4,
                    "num_bad_epochs": 1}, EarlyStop().state_dict(), True)
    fresh = build_model(cfg)
    fresh_opt = make_optimizer(fresh, LR)
    meta = restore_checkpoint(str(tmp_path), fresh, fresh_opt, name="best.pth")
    assert meta["epoch"] == 4 and meta["previous_best"] == 0.5
    assert meta["scheduler"]["num_bad_epochs"] == 1
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])
               for i in sa)
    assert restore_checkpoint(str(tmp_path / "none"), fresh, fresh_opt) is None


@pytest.mark.parametrize("value", [True, False])
def test_debug_nans_traps_a_nan_weight_as_the_jax_cli(value, data_root,
                                                       tmp_path):
    """``debug_nans: true`` with a NaN in the ImageNet file's first conv:
    the JAX CLI (``jax_debug_nans``) and the port's both raise
    ``FloatingPointError``, the port's naming the epoch, the step and the
    tensor; with the file's weights finite, the same run trains."""
    from torch_model_parity import encoder_file_npz

    path = tmp_path / "resnet18.npz"
    encoder_file_npz(path, nan_at="conv1.weight" if value else None)
    raw = {"train_path": str(data_root / "train"),
           "val_path": str(data_root / "val"), "model": "unet",
           "img_size": SIZE, "batch_size": 4, "epochs": 1, "lr": LR,
           "num_worker": 2, "compute_dtype": "float32", "augment": False,
           "pretrained_path": str(path), "debug_nans": True,
           "num_devices": 1}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    argv = ["--config", str(cfg_path), "--save_path", str(tmp_path / "out")]
    if not value:
        result = cli_train.main(argv + ["--device", "cpu"])
        assert math.isfinite(result["history"][0]["train_loss"])
        return
    with pytest.raises(FloatingPointError,
                       match=r"epoch 1, step 0: non-finite loss"):
        cli_train.main(argv + ["--device", "cpu"])
    assert not (tmp_path / "out" / "pth" / "latest.pth").exists()
    from pdac_pathological_image_segmentation_tpu.cli import (
        train as jax_cli_train,
    )

    try:
        with pytest.raises(FloatingPointError):
            jax_cli_train.main(["--config", str(cfg_path), "--save_path",
                                str(tmp_path / "jax_out")])
    finally:
        jax.config.update("jax_debug_nans", False)


def test_trainer_initial_weights_follow_the_seed(data_root, tmp_path):
    """Two trainers with one seed start from the same weights, another
    seed from others, and the caller's global RNG is left as it was; for
    FPN and for ResUNet (whose decoder's first weight is checked too)."""
    def first_weights(seed, model):
        cfg = Config(model=model, img_size=SIZE, compute_dtype="float32",
                     batch_size=4, seed=seed)
        ds = PatchDataset(*discover_split(str(data_root / "train")), cfg)
        trainer = Trainer(cfg, str(tmp_path / f"{model}{seed}"), ds, ds,
                          device="cpu")
        names = ["encoder.conv1.weight", next(
            k for k, _ in trainer.model.named_parameters()
            if not k.startswith("encoder."))]
        params = dict(trainer.model.named_parameters())
        return [params[k].detach().clone() for k in names]

    state = torch.random.get_rng_state()
    for model in ("fpn", "unet"):
        a, b, c = (first_weights(41, model), first_weights(41, model),
                   first_weights(42, model))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not any(torch.equal(x, z) for x, z in zip(a, c))
    assert torch.equal(torch.random.get_rng_state(), state)

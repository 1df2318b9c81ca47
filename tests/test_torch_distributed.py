"""Data-parallel training of the PyTorch port (``parallel/``,
``train/steps.py``, ``train/loop.py``, ``cli/train.py``) on the CPU, over
gloo ranks spawned by ``tests/torch_dist_worker.py``.

* BatchNorm over the global batch (``parallel/batchnorm.py``) on 2 and 3
  ranks, one of them with no rows, against ``F.batch_norm`` on the
  concatenated batch in float64: output, input and parameter gradients and
  running statistics within 1e-12.
* The loader's per-rank split against the JAX ``_epoch_indices`` at world
  sizes 1-4, wrap padding included.
* One FPN/resnet18 step at 64²: 2 ranks against the port's own one-device
  step in float64 with augmentation and dropout on (and with
  ``grad_accum_steps: 2``), and against the JAX ``make_train_step`` on a
  2-device mesh in float32 with dropout off (and with
  ``grad_accum_steps: 2``, where rank 1 holds no row of microbatch 0), at
  ``tests/test_torch_train.py``'s bounds.
* The rendezvous: a failing one raises, a lost initialization race
  passes, none named is a no-op; ``create_mesh``.
(``cli.train`` over ranks: ``tests/test_torch_distributed_train.py``.)
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

from pdac_pathological_image_segmentation_tpu.data.loader import (
    _epoch_indices as jax_epoch_indices,
)
from pdac_pathological_image_segmentation_tpu.ops.augment import (
    eval_transform as jax_eval_transform,
)
from pdac_pathological_image_segmentation_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh,
)
from pdac_pathological_image_segmentation_tpu.train.objective import (
    make_objective as jax_make_objective,
)
from pdac_pathological_image_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    convert_smp_fpn_state_dict,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    _epoch_indices,
)
from pdac_pathological_image_segmentation_tpu_torch.models.fpn import FPN
from pdac_pathological_image_segmentation_tpu_torch.parallel import mesh
from pdac_pathological_image_segmentation_tpu_torch.train.state import (
    parameter_names,
)
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    fpn_state_dict_from_jax,
)

import torch_dist_worker as worker
from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    BN_BUFFERS,
    LR,
    SIZE,
    assert_step_adam,
    assert_step_batchnorm,
    assert_step_gradients,
    assert_step_loss_and_score,
    flax_dropout_off,
    jax_cfg,
    jax_train_state,
    np_tree,
    one_torch_thread,
)

STEP_CASES = {
    "f64": {},
    "f64_accum2": {"step_kw": {"grad_accum_steps": 2}},
    "f32": {"float64": False, "dropout": 0.0, "augment": False},
    "f32_accum2": {"float64": False, "dropout": 0.0, "augment": False,
                   "step_kw": {"grad_accum_steps": 2}},
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank case in one spawn: BatchNorm with rows (3, 2) and
    the four steps."""
    cases = [("bn_case", {"rows": [3, 2]})] + [
        ("step_case", kw) for kw in STEP_CASES.values()]
    ranks = worker.run_ranks(2, tmp_path_factory.mktemp("two_ranks"), cases)
    return {"bn": [r[0] for r in ranks],
            **{name: [r[i + 1] for r in ranks]
               for i, name in enumerate(STEP_CASES)}}


# -- BatchNorm over the global batch ------------------------------------------

def _plain_bn(rows):
    x, dy = worker.bn_data(rows)
    x = x.clone().requires_grad_(True)
    w = torch.linspace(0.5, 1.5, 5, dtype=torch.float64).requires_grad_(True)
    b = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64).requires_grad_(True)
    rm, rv = torch.zeros(5, dtype=torch.float64), torch.ones(
        5, dtype=torch.float64)
    y = F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.1, eps=1e-5)
    y.backward(dy)
    return {"y": y.detach(), "dx": x.grad, "dw": w.grad, "db": b.grad,
            "running_mean": rm, "running_var": rv}


def _assert_bn(ranks, rows):
    want = _plain_bn(rows)
    for key in ("y", "dx"):
        got = torch.cat([r[key] for r in ranks])
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-12, err_msg=key)
    for key in ("dw", "db"):  # each rank's share; the step sums them
        got = sum(r[key] for r in ranks)
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-12, err_msg=key)
    for r in ranks:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[key].numpy(), want[key].numpy(),
                                       rtol=0, atol=1e-12, err_msg=key)
        assert r["tracked"] == 1


def test_global_batchnorm_two_ranks(two_ranks):
    _assert_bn(two_ranks["bn"], [3, 2])


def test_global_batchnorm_three_ranks_one_empty(tmp_path):
    rows = [2, 0, 3]
    ranks = worker.run_ranks(3, tmp_path, [("bn_case", {"rows": rows})])
    assert ranks[1][0]["y"].shape == (0, 5, 8, 7)
    _assert_bn([r[0] for r in ranks], rows)


# -- the loader's split -------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_epoch_indices_match_jax(world):
    for n, shuffle in ((10, True), (9, False), (7, True)):
        shares = [_epoch_indices(n, 3, 41, shuffle, r, world)
                  for r in range(world)]
        for r, got in enumerate(shares):
            np.testing.assert_array_equal(
                got, jax_epoch_indices(n, 3, 41, shuffle, r, world))
        flat = np.concatenate(shares)
        assert len(flat) == -(-n // world) * world  # wrap-padded
        assert set(flat.tolist()) == set(range(n))


# -- the train step -----------------------------------------------------------

def _flat_diff(a: dict, b: dict, keys) -> dict:
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in keys}


@pytest.mark.parametrize("case", ["f64", "f64_accum2"])
def test_two_rank_step_equals_one_rank_float64(two_ranks, case):
    """2 ranks against the port's one-device step on the same global batch,
    augmentation and dropout drawn for the global batch.  The model is
    float64; the objective sums in float32 (as on one device), so the
    loss agrees within 1e-6, each gradient within 1e-6 of its tensor's
    largest, and the parameters after Adam within 1e-9 where the gradient
    is clearly away from Adam's eps (|g| > 1e-4; Adam's first step is
    lr·g/(|g| + eps)), within 2·lr elsewhere.  BN buffers (float64 global
    statistics) within 1e-10; both ranks hold the same state."""
    ranks = two_ranks[case]
    want = worker.step_case(**STEP_CASES[case])
    for r in ranks:
        assert abs(r["loss"] - want["loss"]) < 1e-6
        assert abs(r["score"] - want["score"]) < 1e-6
        assert sorted(r["grads"]) == sorted(want["grads"])
        for k, g in want["grads"].items():
            scale = float(g.abs().max())
            np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(),
                                       rtol=0, atol=1e-6 * scale + 1e-15,
                                       err_msg=k)
        for k, v in want["state"].items():
            got = r["state"][k].double().numpy()
            ref = v.double().numpy()
            if k.endswith(BN_BUFFERS):
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10,
                                           err_msg=k)
                continue
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * LR,
                                       err_msg=k)
            clear = want["grads"][k].abs().numpy() > 1e-4
            np.testing.assert_allclose(got[clear], ref[clear], rtol=0,
                                       atol=1e-9, err_msg=k)
    for k in want["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k


def _jax_mesh_step(step_kw: dict) -> dict:
    """The JAX ``make_train_step`` on a 2-device mesh (state replicated, the
    batch sharded over the data axis), FPN from the same ``state_dict``,
    dropout off, ``augment=False``; its gradient ``jax.grad`` of the same
    objective (the mean over microbatches)."""
    k = int(step_kw.get("grad_accum_steps", 1))
    images, masks, valid = worker.step_batch()
    sd = worker.fpn_sd()
    jcfg = jax_cfg("fpn")
    jmesh = jax_create_mesh(2)
    shard, repl = NamedSharding(jmesh, P("data")), NamedSharding(jmesh, P())
    with flax_dropout_off():
        from pdac_pathological_image_segmentation_tpu.models import (
            build_model as jax_build_model,
        )
        jmodel = jax_build_model(jcfg)
        state = jax_train_state(jcfg, jmodel)
        params, batch_stats = convert_smp_fpn_state_dict(
            {n: v.numpy() for n, v in sd.items()}, state.params,
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

        m = len(images) // k
        parts = [jax.jit(jax.grad(loss_fn), static_argnums=1)(
            params, slice(i * m, (i + 1) * m)) for i in range(k)]
        jgrads = jax.tree_util.tree_map(lambda *g: sum(g) / k, *parts)
        jstep = jax_make_train_step(jmodel, SIZE, objective=jobj,
                                    donate=False, augment=False, **step_kw)
        new_state, jloss, jscore = jstep(
            jax.device_put(state, repl), jax.random.PRNGKey(1),
            *(jax.device_put(jnp.asarray(a), shard)
              for a in (images, masks, valid)))
    jg = fpn_state_dict_from_jax(np_tree(jgrads), np_tree(batch_stats))
    return {"sd": sd, "jloss": float(jloss), "jscore": float(jscore),
            "jgrads": {n: v for n, v in jg.items()
                       if not n.endswith(BN_BUFFERS)},
            "jparams": fpn_state_dict_from_jax(
                np_tree(new_state.params), np_tree(new_state.batch_stats))}


@pytest.mark.parametrize("case", ["f32", "f32_accum2"])
def test_two_rank_step_matches_jax_mesh(two_ranks, case):
    """Rank 0's step (the ranks agree bit for bit) against the JAX step on
    ``create_mesh(2)``: loss 1e-5, score one pixel, gradients 2e-3, Adam,
    BN running statistics over the global batch (per microbatch under
    accumulation), at ``tests/test_torch_train.py``'s bounds."""
    step_kw = STEP_CASES[case].get("step_kw", {})
    ranks = two_ranks[case]
    for k in ranks[0]["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
    ref = _jax_mesh_step(step_kw)
    model = FPN(output_size=SIZE, dropout=0.0)
    model.load_state_dict(ranks[0]["state"], strict=True)
    step = {**ref, "model": model, "loss": ranks[0]["loss"],
            "score": ranks[0]["score"], "grads": ranks[0]["grads"]}
    assert sorted(step["grads"]) == sorted(parameter_names(model))
    assert_step_loss_and_score(step)
    assert_step_gradients(step)
    assert_step_adam(step)
    assert_step_batchnorm(step, micro=int(step_kw.get("grad_accum_steps",
                                                      1)))


# -- the rendezvous -----------------------------------------------------------

def test_initialize_distributed_reraises_rendezvous_failure(monkeypatch):
    """A rendezvous that fails raises: N ranks must not go on as N
    single-process runs writing one checkpoint."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)

    def boom(*args, **kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="connection refused"):
        mesh.initialize_distributed(init_method="tcp://127.0.0.1:1", rank=0,
                                    world_size=2, device="cpu")
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"),
                 ("WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="connection refused"):
        mesh.initialize_distributed(device="cpu")


def test_initialize_distributed_lets_a_lost_init_race_pass(monkeypatch):
    flags = iter([False, True])  # not yet; after the raise, yes
    monkeypatch.setattr(torch.distributed, "is_initialized",
                        lambda: next(flags))

    def boom(*args, **kwargs):
        raise RuntimeError("already initialized")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    mesh.initialize_distributed(init_method="file:///nowhere", rank=0,
                                world_size=2, device="cpu")


def test_initialize_distributed_without_rendezvous_is_a_no_op(monkeypatch):
    for k in mesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.is_chief()) == (0, 1, True)
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        mesh.initialize_distributed(backend="nccl", init_method="file:///x",
                                    rank=0, world_size=1, device="cpu")


def test_create_mesh():
    assert mesh.create_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert mesh.create_mesh(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.create_mesh(2)

"""The gradient-noise-scale estimator of the PyTorch port
(``train/gns.py``) against the JAX ``make_gns_stats``, on gloo ranks
spawned by ``tests/torch_dist_worker.py``.

On a linear least-squares loss (``tests/test_gns.py``'s model): the port's
estimator on 2 and 4 ranks equals the JAX one on a 2- and a 4-device mesh
(every field within 1e-5 relative); the JAX file's three estimator tests
(the known noise recovered, zero noise giving S ≈ 0, a replicated
argument passing through) and its EMA test; one rank gives NaN estimates
and a batch that does not divide raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh,
)
from pdac_pathological_image_segmentation_tpu.train.gns import (
    make_gns_stats as jax_make_gns_stats,
)
from pdac_pathological_image_segmentation_tpu_torch.train.gns import (
    GnsEma,
    GnsStats,
    make_gns_stats,
)

import torch_dist_worker as worker

FIELDS = ("g_small_sq", "g_big_sq", "s_est", "g2_est", "b_simple")


def _noisy(d=16, b=512, seed=0):
    """x ~ N(0, I), y = x·w* + ε, and a start w0 away from w*."""
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=(d,))
    w0 = (w_star + 0.5 * rng.normal(size=(d,))).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    y = (x @ w_star + rng.normal(size=(b,))).astype(np.float32)
    return x, y, w0


def _noiseless(d=8, b=64):
    x = np.tile(np.linspace(-1, 1, d, dtype=np.float32)[None, :], (b, 1))
    return x, np.ones((b,), np.float32), np.zeros((d,), np.float32)


def _replicated(d=4, b=32):
    rng = np.random.default_rng(1)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b,)).astype(np.float32),
            np.ones((d,), np.float32))


CASES = {"noisy": (_noisy(), None), "noiseless": (_noiseless(), None),
         "replicated": (_replicated(), 3.0)}


def _case_list():
    return [("gns_case", {"x": x, "y": y, "w0": w0, "scale": s})
            for (x, y, w0), s in CASES.values()]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 2 and on 4 ranks (rank 0's results: every rank
    returns the same)."""
    out = {}
    for world in (2, 4):
        got = worker.run_ranks(world, tmp_path_factory.mktemp(f"gns{world}"),
                               _case_list())
        for r in got[1:]:
            assert r == got[0]
        out[world] = dict(zip(CASES, got[0]))
    return out


def _jax_stats(name: str, world: int) -> dict:
    (x, y, w0), scale = CASES[name]

    def grad_fn(params, *args):
        *s, xb, yb = args

        def loss(w):
            pred = xb @ w
            if s:
                pred = s[0] * pred
            return jnp.mean((pred - yb) ** 2)

        return {"w": jax.grad(loss)(params["w"])}

    args = (jnp.asarray(x), jnp.asarray(y))
    n_repl = 0
    if scale is not None:
        args, n_repl = (jnp.float32(scale),) + args, 1
    stats = jax_make_gns_stats(grad_fn, jax_create_mesh(world), len(x),
                               n_repl_args=n_repl)(
        {"w": jnp.asarray(w0)}, *args)
    return {k: float(v) for k, v in stats._asdict().items()}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_gns_matches_jax_mesh(ranks, world, name):
    got, want = ranks[world][name], _jax_stats(name, world)
    for k in FIELDS:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def test_estimator_recovers_known_noise(ranks):
    """The JAX file's check on 4 ranks: the pair of norms equals the
    empirical per-rank means, and S and G² estimate tr(Σ) and |G|² of the
    per-sample gradients within their sampling noise."""
    stats = ranks[4]["noisy"]
    (x, y, w0), _ = CASES["noisy"]
    g_i = 2.0 * (x @ w0 - y)[:, None] * x
    big = g_i.mean(0)
    shard_means = g_i.reshape(4, len(x) // 4, -1).mean(1)
    np.testing.assert_allclose(stats["g_small_sq"],
                               float((shard_means ** 2).sum(1).mean()),
                               rtol=1e-4)
    np.testing.assert_allclose(stats["g_big_sq"], float((big ** 2).sum()),
                               rtol=1e-4)
    assert stats["s_est"] == pytest.approx(
        float(g_i.var(0, ddof=1).sum()), rel=0.3)
    assert stats["g2_est"] == pytest.approx(float((big ** 2).sum()), rel=0.3)
    assert stats["b_simple"] > 0


def test_zero_noise_gradients_give_zero_s(ranks):
    stats = ranks[4]["noiseless"]
    np.testing.assert_allclose(stats["g_small_sq"], stats["g_big_sq"],
                               rtol=1e-5)
    assert abs(stats["s_est"]) < 1e-3 * max(stats["g2_est"], 1.0)


def test_replicated_args_pass_through(ranks):
    assert np.isfinite(ranks[2]["replicated"]["g_big_sq"])
    assert np.isfinite(ranks[4]["replicated"]["g_big_sq"])


def test_one_rank_gives_nan_and_checks_the_batch():
    (x, y, w0), _ = CASES["noisy"]
    got = worker.gns_case(x, y, w0)
    assert np.isfinite(got["g_small_sq"])
    assert got["g_small_sq"] == got["g_big_sq"]
    assert all(np.isnan(got[k]) for k in ("s_est", "g2_est", "b_simple"))
    stats = make_gns_stats(lambda *a: [torch.zeros(1)], 8)
    with pytest.raises(ValueError, match="share is 8"):
        stats(torch.zeros(4, 2))


def test_ema_tracks_ratio():
    ema = GnsEma(alpha=0.5)

    def mk(s, g2):
        return GnsStats(*(torch.tensor(v) for v in (0.0, 0.0, s, g2,
                                                    s / g2)))

    assert ema.update(mk(10.0, 2.0)) == pytest.approx(5.0)
    assert ema.update(mk(20.0, 2.0)) == pytest.approx(
        (0.5 * 10 + 0.5 * 20) / 2.0)
    # NaN stats (one rank) leave the EMA untouched
    assert np.isnan(ema.update(GnsStats(*([torch.tensor(float("nan"))]
                                          * 5))))
    assert ema.s == pytest.approx(15.0)
    ema2 = GnsEma()
    ema2.load_state_dict(ema.state_dict())
    assert (ema2.s, ema2.g2, ema2.alpha) == (ema.s, ema.g2, ema.alpha)

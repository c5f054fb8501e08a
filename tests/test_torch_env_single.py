"""The port's single-sample reward API (``env/spai.py``: masked_values,
residual_norm, matrix_flops, evaluate_preconditioner, reward,
reward_from_actions) against the JAX package's, on ``tests/test_env.py``'s
LF10 fixture in float64: the rewards within rtol 1e-9 of JAX's and of an
independent numpy statement of the reference formula; no deletions with
original = seed gives 0 within 1e-9; and ``reward_from_actions`` equals
``batched_rewards`` row by row (a batch of one bit for bit; a row of a
larger batch within rtol 1e-12) on the pair env and the rowblock env."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu import env as j_env
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu_torch import env as t_env
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery

RTOL = 1e-9
ROW_RTOL = 1e-12


def _numpy_reward_oracle(seed_dense, original_dense, deleted_edges, alpha):
    """The reference reward (preconditioner.py:64,137-165) in numpy."""
    n = seed_dense.shape[0]
    rows, cols = np.nonzero(seed_dense)
    M = seed_dense.copy()
    for e in deleted_edges:
        M[rows[e], cols[e]] = 0.0
    res = np.linalg.norm(M @ original_dense - np.eye(n), "fro")
    base_res = np.linalg.norm(original_dense @ original_dense - np.eye(n), "fro")
    flops = 2 * np.count_nonzero(M) * n
    base_flops = 2 * np.count_nonzero(original_dense) * n
    metric = alpha * (1 - res / base_res) + (1 - alpha) * (1 - flops / base_flops)
    return metric * 1000.0


@pytest.fixture(scope="module")
def lf10():
    ja = j_gallery.get("LF10_like")
    jseed = j_env.seed_pattern(ja, method="ilu0", dtype=jnp.float64)
    ta = t_gallery.get("LF10_like")
    tseed = t_env.seed_pattern(ta, method="ilu0", dtype=np.float64)
    return dict(ja=ja, jseed=jseed, jenv=j_env.make_env(jseed, original=ja),
                ta=ta, tseed=tseed, tenv=t_env.make_env(tseed, original=ta, device="cpu"))


def _actions(env, rng, k):
    a = np.full(env.num_actions, -1, dtype=np.int64)
    a[:k] = rng.choice(env.num_edges, size=k, replace=False)
    a[k] = env.terminal_action
    return a


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.73])
def test_reward_from_actions_matches_jax_and_the_oracle(lf10, alpha):
    jenv, tenv = lf10["jenv"], lf10["tenv"]
    assert tenv.num_edges == jenv.num_edges
    seed_dense = np.asarray(lf10["jseed"].todense())
    orig_dense = np.asarray(lf10["ja"].todense())
    rng = np.random.default_rng(0)
    for k in (0, 10, 40):
        acts = _actions(tenv, rng, k)
        got = t_env.reward_from_actions(tenv, torch.as_tensor(acts), alpha)
        want = j_env.reward_from_actions(jenv, jnp.asarray(acts, jnp.int32),
                                         jnp.asarray(alpha))
        assert got.dtype == torch.float64 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        np.testing.assert_allclose(
            float(got), _numpy_reward_oracle(seed_dense, orig_dense, acts[:k], alpha),
            rtol=RTOL)


def test_the_single_sample_parts_match_jax(lf10):
    jenv, tenv = lf10["jenv"], lf10["tenv"]
    rng = np.random.default_rng(5)
    keep = rng.random(tenv.num_edges) > 0.3
    tk, jk = torch.as_tensor(keep), jnp.asarray(keep)
    np.testing.assert_array_equal(t_env.masked_values(tenv, tk).numpy(),
                                  np.asarray(j_env.masked_values(jenv, jk)))
    np.testing.assert_allclose(float(t_env.residual_norm(tenv, tk)),
                               float(j_env.residual_norm(jenv, jk)), rtol=RTOL)
    assert float(t_env.matrix_flops(tenv, tk)) == float(j_env.matrix_flops(jenv, jk))
    for fn in ("evaluate_preconditioner", "reward"):
        np.testing.assert_allclose(float(getattr(t_env, fn)(tenv, tk, 0.6)),
                                   float(getattr(j_env, fn)(jenv, jk, jnp.asarray(0.6))),
                                   rtol=RTOL)


def test_reward_no_deletions_reference_baseline(lf10):
    """original = seed and nothing deleted: both ratios are 1, reward 0."""
    env = t_env.make_env(lf10["tseed"], device="cpu")
    actions = torch.full((env.num_actions,), -1, dtype=torch.int64)
    np.testing.assert_allclose(float(t_env.reward_from_actions(env, actions, 0.5)), 0.0,
                               atol=1e-9)


@pytest.mark.parametrize("path", ["pair", "rowblock"])
def test_reward_from_actions_equals_batched_rewards(lf10, path):
    env = t_env.make_env(lf10["tseed"], original=lf10["ta"], reward_path=path,
                         device="cpu")
    assert (env.rb is not None) == (path == "rowblock")
    rng = np.random.default_rng(1)
    B = 6
    acts = torch.as_tensor(np.stack([_actions(env, rng, k)
                                     for k in rng.integers(0, 30, size=B)]))
    alpha = torch.tensor(0.4, dtype=torch.float64)
    batched = t_env.batched_rewards(env, acts, alpha)
    for b in range(B):
        one = t_env.reward_from_actions(env, acts[b], alpha)
        assert torch.equal(one, t_env.batched_rewards(env, acts[b][None], alpha)[0])
        np.testing.assert_allclose(float(one), float(batched[b]), rtol=ROW_RTOL)

"""PyTorch port vs the JAX package: the Gumbel-top-k rollout with shared
noise, trajectory log-probs and the suffix log-sum-exp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.gfn import rollout as j_roll
from gflownet_spai_tpu.ops import scan as j_scan
from gflownet_spai_tpu_torch.gfn import rollout as t_roll
from gflownet_spai_tpu_torch.ops import scan as t_scan

B, A = 6, 40


def _logits_and_noise(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(A).astype(np.float32)
    logits[A - 1] -= 1.5          # longer trajectories: terminal less likely
    gumbels = rng.gumbel(size=(B, A)).astype(np.float32)
    return np.broadcast_to(logits, (B, A)).copy(), gumbels


@pytest.mark.parametrize("t_cap", [None, 8])
def test_gumbel_topk_rollout_shared_noise(t_cap):
    logits, gumbels = _logits_and_noise()
    want = j_roll.gumbel_topk_rollout(
        jnp.asarray(logits), jax.random.PRNGKey(0), terminal_action=A - 1,
        gumbels=jnp.asarray(gumbels), t_cap=t_cap)
    got = t_roll.gumbel_topk_rollout(
        torch.as_tensor(logits), None, terminal_action=A - 1,
        gumbels=torch.as_tensor(gumbels), t_cap=t_cap)
    np.testing.assert_array_equal(got.actions.numpy(), np.asarray(want.actions))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.fwd_logprobs.numpy(),
                               np.asarray(want.fwd_logprobs), atol=1e-5)
    if t_cap is not None:
        # some samples end inside the prefix and some are cut at the cap
        lengths = got.lengths.numpy()
        assert (lengths < t_cap).any() and (lengths == t_cap).any()


def test_gumbel_topk_rollout_generator_draws_valid_trajectories():
    logits, _ = _logits_and_noise()
    gen = torch.Generator().manual_seed(0)
    r = t_roll.gumbel_topk_rollout(torch.as_tensor(logits), gen, A - 1)
    acts = r.actions.numpy()
    for b in range(B):
        k = int(r.lengths[b])
        assert acts[b, k - 1] == A - 1 and (acts[b, k:] == -1).all()
        assert len(set(acts[b, :k].tolist())) == k


def test_trajectory_logprobs_match():
    logits, gumbels = _logits_and_noise(1)
    r = t_roll.gumbel_topk_rollout(torch.as_tensor(logits), None, A - 1,
                                   gumbels=torch.as_tensor(gumbels))
    lg = torch.as_tensor(logits[0])
    got = t_roll.trajectory_logprobs(lg, r.actions)
    want = np.stack([np.asarray(j_roll.trajectory_logprobs(
        jnp.asarray(logits[0]), jnp.asarray(a.numpy(), jnp.int32)))
        for a in r.actions])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the rollout's own log-probs and the sequential oracle agree
    np.testing.assert_allclose(got.numpy(), r.fwd_logprobs.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        t_roll.sequential_logprobs(lg, r.actions[0]).numpy(), want[0],
        rtol=1e-5, atol=1e-5)


def test_suffix_logsumexp_matches():
    x = np.random.default_rng(2).standard_normal((3, 17)).astype(np.float32)
    x[1, 5:9] = -np.inf
    x[2, 12:] = -np.inf
    want = np.asarray(j_scan.suffix_logsumexp(jnp.asarray(x)))
    got = t_scan.suffix_logsumexp(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

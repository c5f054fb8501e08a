"""The port's grid env and its generic per-step sampler against the JAX
package: ``update``, ``mask`` and ``reward`` exactly on every cell and
action of an 8×8 grid; ``scan_rollout`` fed the Gumbel noise that
``jax.random.categorical`` draws gives JAX's actions, lengths and final
states exactly and its log-probs within 1e-6 (float32 log-softmax); and
the grid GFlowNet of ``tests/test_train.py`` learns in torch
(``examples/grid_gfn_torch.py``: Adam 5e-3, 300 steps of 64, 15 steps a
trajectory)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gflownet_spai_tpu.env import grid as JG
from gflownet_spai_tpu.gfn.rollout import scan_rollout as j_scan_rollout
from gflownet_spai_tpu_torch import env as t_env
from gflownet_spai_tpu_torch.env import grid as TG
from gflownet_spai_tpu_torch.gfn.rollout import scan_rollout
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SIZE, STEPS, B = 8, 15, 48
LP_TOL = 1e-6


def _launcher():
    spec = importlib.util.spec_from_file_location(
        "grid_gfn_torch", ROOT / "examples" / "grid_gfn_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grid_is_exported_as_env_grid():
    assert t_env.grid is TG


def test_update_mask_reward_match_jax_on_every_cell_and_action():
    jg, tg = JG.GridEnv(size=SIZE), TG.GridEnv(size=SIZE)
    assert (tg.state_dim, tg.num_actions) == (jg.state_dim, jg.num_actions)
    cells = np.repeat(np.arange(SIZE * SIZE), 3)
    acts = np.tile(np.arange(3), SIZE * SIZE)
    ti, ta = torch.as_tensor(cells), torch.as_tensor(acts)
    ji, ja = jnp.asarray(cells), jnp.asarray(acts)
    np.testing.assert_array_equal(TG.update(tg, ti, ta).numpy(),
                                  np.asarray(JG.update(jg, ji, ja)))
    np.testing.assert_array_equal(TG.mask(tg, ti).numpy(), np.asarray(JG.mask(jg, ji)))
    got = TG.reward(tg, ti)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JG.reward(jg, ji)))


def test_scan_rollout_matches_jax_given_its_noise():
    """A fixed table of float32 logits per cell, masked by the grid; B
    samples with JAX's per-sample keys, the noise of each step drawn as
    ``jax.random.categorical`` draws it from ``split(key, max_steps)``."""
    g = JG.GridEnv(size=SIZE)
    table = np.random.default_rng(3).standard_normal((SIZE * SIZE, 3)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.as_tensor(table)

    def j_logits(s, t):
        return jnp.where(JG.mask(g, s), jt[s], -jnp.inf)

    keys = jax.random.split(jax.random.PRNGKey(7), B)
    finals, roll = jax.vmap(lambda k: j_scan_rollout(
        j_logits, lambda s, a: JG.update(g, s, a), jnp.asarray(0), k, JG.TERMINATE,
        STEPS))(keys)
    noise = jax.vmap(lambda k: jax.vmap(
        lambda kt: jax.random.gumbel(kt, (3,), jnp.float32))(
        jax.random.split(k, STEPS)))(keys)                     # [B, T, 3]
    noise = torch.as_tensor(np.array(noise)).transpose(0, 1)     # [T, B, 3]

    tg = TG.GridEnv(size=SIZE)
    t_finals, t_roll = scan_rollout(
        lambda s, t: torch.where(TG.mask(tg, s), tt[s], float("-inf")),
        lambda s, a: TG.update(tg, s, a), torch.zeros(B, dtype=torch.int64), None,
        TG.TERMINATE, STEPS, gumbel=noise)
    np.testing.assert_array_equal(t_roll.actions.numpy(), np.asarray(roll.actions))
    np.testing.assert_array_equal(t_roll.lengths.numpy(), np.asarray(roll.lengths))
    np.testing.assert_array_equal(t_finals.numpy(), np.asarray(finals))
    np.testing.assert_allclose(t_roll.fwd_logprobs.numpy(), np.asarray(roll.fwd_logprobs),
                               rtol=LP_TOL, atol=LP_TOL)
    # the batch really has finished and unfinished samples, and padding
    lengths = t_roll.lengths.numpy()
    assert lengths.min() < STEPS and (t_roll.actions.numpy() == -1).any()
    pad = t_roll.actions.numpy() < 0
    assert (t_roll.fwd_logprobs.numpy()[pad] == 0.0).all()


def test_scan_rollout_draws_its_own_noise_from_the_generator():
    tg = TG.GridEnv(size=SIZE)
    table = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (SIZE * SIZE, 3)).astype(np.float32))

    def run(seed):
        return scan_rollout(lambda s, t: torch.where(TG.mask(tg, s), table[s], float("-inf")),
                            lambda s, a: TG.update(tg, s, a),
                            torch.zeros(B, dtype=torch.int64),
                            torch.Generator().manual_seed(seed), TG.TERMINATE, STEPS)

    (f1, r1), (f2, r2), (_, r3) = run(0), run(0), run(1)
    assert torch.equal(r1.actions, r2.actions) and torch.equal(f1, f2)
    assert not torch.equal(r1.actions, r3.actions)
    assert torch.isfinite(r1.fwd_logprobs).all() and (r1.fwd_logprobs <= 0).all()


def test_grid_gflownet_learns_target_distribution():
    mod = _launcher()
    params, losses, _ = mod.train(size=SIZE, hidden=32, steps=300, batch=64,
                                  max_steps=15, lr=5e-3, device="cpu", seed=0)
    assert np.mean(losses[-30:]) < np.mean(losses[:30])
    share = mod.band_share(SIZE, params, 512, seed=99, max_steps=15)
    assert share > 0.35, f"only {share:.2%} in high-reward bands"

"""The deep-thinning recipe's path (``examples/thinning_orsirr_torch.py``,
docs/BENCH.md's α 0.985 run) in the port against the JAX package, at a
small size: orsirr_like12's k = 2 classic-SPAI seed (1,645 entries) with
``gat_tiled_min_edges`` and ``rowblock_min_nnz`` lowered, so that ``auto``
gives the rowblock env and the policy graph the bucketed tile layout, as
at orsirr_like150's 291,513 entries (the tile ops run their plain
versions on the CPU).  Both sides start from the JAX parameters
(``convert.params_from_jax``) and take the same Gumbel noise.  Both envs
are built on the port's seed: the packages' SPAI seeds agree to rounding
(``tests/test_torch_validate.py::test_spai_seed_pattern_matches_jax``),
and the magnitude order of near-equal values decides the demonstrations.

Every case runs twice, with both sides in float64 and in float32 (the
recipe's dtype on the card), at the tolerances of ``TOL``.  The
parameters' deltas are held in float64 only: Adam's first steps move each
parameter by about ±lr whatever the size of its gradient, so a gradient
that cancels to float32 rounding noise would flip a delta's sign.

(a) The replay buffer after ``seed_replay_with_magnitude_thinning`` with
    fractions 0.2 / 0.3 / 0.4: actions, lengths and −1 padding exactly,
    rewards at ``reward``.
(b) Three ``warmstart_on_demonstrations`` steps: each step's printed NLL
    (delete and total) at ``nll`` rtol plus the print's half unit, and (in
    float64) the parameters' deltas at rtol 1e-5 + atol 1e-6 times the
    largest delta of the leaf's parameter group.
(c) One SubTB(1.0) train step after them, with β 50, the edge-feature
    logit channel, the linear backward policy, t_cap 1,024 below the 1,646
    actions and prioritised replay over the seeded buffer, the replay draw
    fed to both sides: the loss at ``loss`` rtol and the fresh rewards'
    β·log R at ``nll`` rtol, the lengths and the buffer after the step
    exactly (actions) and at ``reward`` (rewards), and (in float64)
    the deltas as in (b).

The JAX warm start and train step run under ``jax.jit`` (their own), and
so do JAX's parameter init, the demonstrations' rewards and the buffer
merge (patched here, one compile each)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.env import ilu as j_ilu
from gflownet_spai_tpu.gfn.loss import log_reward as j_log_reward
from gflownet_spai_tpu.sparse.types import COO as JCOO
from gflownet_spai_tpu.train import TrainConfig as JConfig
from gflownet_spai_tpu.train import loop as j_loop
from gflownet_spai_tpu_torch.convert import params_from_jax
from gflownet_spai_tpu_torch.env import ilu as t_ilu
from gflownet_spai_tpu_torch.gfn import rollout as t_rollout
from gflownet_spai_tpu_torch.gfn.loss import log_reward as t_log_reward
from gflownet_spai_tpu_torch.models import policies as t_pol
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.train import TrainConfig as TConfig
from gflownet_spai_tpu_torch.train import loop as t_loop
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RECIPE = dict(matrix="orsirr_like12", seed_method="spai", seed_k=2,
              reward_baseline="identity", loss="subtb", subtb_lambda=1.0,
              backward="linear", replay_size=8, replay_samples=4,
              replay_prioritized=1.0, alpha_fixed=0.985, lr=1e-3, plateau_patience=0,
              reward_beta=50.0, edge_feats=True, replay_seed_fracs="0.2,0.3,0.4",
              warmstart_epochs=3, t_cap=1024, batch_size=4, terminal_bias=0.0,
              gat_tiled_min_edges=0, rowblock_min_nnz=0)
# a reward is 1000 times a sum of terms near 1 (1 - ||MA - I|| / base,
# 1 - the flop ratio), so in float32 it also gets an absolute 4e-3: about
# 32 float32 units of 1000
TOL = {"float64": dict(reward=dict(rtol=1e-6), nll=1e-5, loss=1e-5),
       "float32": dict(reward=dict(rtol=1e-5, atol=4e-3), nll=1e-5, loss=1e-5)}
DRAW = [2, 0, 1, 2]         # the replay slots both sides draw in (c)
NOISE_SEED = 21


def _leaves(params):
    return [(p, x.detach().numpy()) for p, x in t_loop.tree_leaves(params)]


def _hold_deltas(t_before, t_after, j_before, j_after):
    """The parameters' deltas per leaf at rtol 1e-5 + atol 1e-6 times the
    largest delta of the leaf's parameter group."""
    jb = [np.asarray(x) for x in jax.tree_util.tree_leaves(j_before)]
    ja = [np.asarray(x) for x in jax.tree_util.tree_leaves(j_after)]
    tb, ta = _leaves(t_before), _leaves(t_after)
    assert len(jb) == len(tb) == len(ta) == len(ja)
    group = lambda p: p.rsplit("/", 1)[0]
    want = {p: a - b for (p, _), a, b in zip(tb, ja, jb)}
    scale = {}
    for p, w in want.items():
        scale[group(p)] = max(scale.get(group(p), 0.0), float(np.abs(w).max()))
    moved = 0
    for (p, b), (_, a) in zip(tb, ta):
        np.testing.assert_allclose(a - b, want[p], rtol=1e-5,
                                   atol=1e-6 * scale[group(p)], err_msg=p)
        moved += bool(np.any(want[p] != 0))
    assert moved >= 8


@pytest.fixture(scope="module", params=sorted(TOL, reverse=True))
def recipe(request):
    dtype = np.dtype(request.param)
    jcfg = JConfig(**RECIPE, dtype=request.param)
    tcfg = TConfig(platform="cpu", **RECIPE, dtype=request.param)
    a = t_gallery.get(RECIPE["matrix"])
    t_seed = t_ilu.seed_pattern(a.__class__(row=a.row, col=a.col, data=a.data.astype(dtype),
                                            shape=a.shape), method="spai", k=2, dtype=dtype)

    def shared_seed(a, **kw):
        return JCOO(row=jnp.asarray(t_seed.row, jnp.int32),
                    col=jnp.asarray(t_seed.col, jnp.int32),
                    data=jnp.asarray(t_seed.data), shape=tuple(t_seed.shape))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ilu, "seed_pattern", shared_seed)
        mp.setattr(j_loop.gfn, "init_params",
                   jax.jit(j_loop.gfn.init_params, static_argnums=1,
                           static_argnames="dtype"))
        _, _, jenv, jgraph, jmcfg, jopt, jstate = j_loop.setup(jcfg)
    _, _, tenv, tgraph, tmcfg, topt, tstate = t_loop.setup(tcfg)
    assert tenv.rb is not None and tenv.rb.edge_perm is not None
    assert isinstance(tgraph, t_pol.TiledGraphInputs) and tgraph.gat_buckets
    assert tgraph.action_feats is not None
    assert tmcfg.num_actions == jmcfg.num_actions == 1646 > tmcfg.t_cap
    assert jstate.params.forward.feat_w.dtype == dtype
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                             device="cpu")
    tstate = tstate._replace(params=params,
                             opt_state=topt.init(x for _, x in t_loop.tree_leaves(params)))
    assert params.forward.feat_w.dtype == getattr(torch, request.param)
    return dict(jcfg=jcfg, tcfg=tcfg, jenv=jenv, jgraph=jgraph, jmcfg=jmcfg, jopt=jopt,
                jstate=jstate, tenv=tenv, tgraph=tgraph, tmcfg=tmcfg, topt=topt,
                tstate=tstate, tol=TOL[request.param], exact=request.param == "float64",
                steps={})


def _seeded(r):
    if "seeded" not in r["steps"]:
        with pytest.MonkeyPatch.context() as mp:
            # the demonstrations' rewards under jax.jit, one compile
            mp.setattr(j_loop.gfn, "_batched_rewards", jax.jit(j_loop.gfn._batched_rewards))
            mp.setattr(j_loop, "replay_update", jax.jit(j_loop.replay_update))
            j = j_loop.seed_replay_with_magnitude_thinning(r["jenv"], r["jstate"],
                                                           r["jcfg"], alpha=0.985)
        t = t_loop.seed_replay_with_magnitude_thinning(r["tenv"], r["tstate"], r["tcfg"],
                                                       alpha=0.985)
        r["steps"]["seeded"] = (j, t)
    return r["steps"]["seeded"]


def _nll_lines(text):
    return [(float(m[1]), float(m[2])) for m in
            re.finditer(r"warmstart \d+: NLL (\S+) \(delete (\S+),", text)]


def _warm(r, capsys):
    if "warm" not in r["steps"]:
        j, t = _seeded(r)
        capsys.readouterr()
        j2 = j_loop.warmstart_on_demonstrations(r["jenv"], r["jgraph"], r["jmcfg"], j,
                                                r["jcfg"], r["jopt"])
        j_out = capsys.readouterr().out
        t2 = t_loop.warmstart_on_demonstrations(r["tenv"], r["tgraph"], r["tmcfg"], t,
                                                r["tcfg"], r["topt"])
        t_out = capsys.readouterr().out
        r["steps"]["warm"] = (j, t, j2, t2, _nll_lines(j_out), _nll_lines(t_out))
    return r["steps"]["warm"]


def test_seeded_replay_equals_jax(recipe):
    """(a)"""
    j, t = _seeded(recipe)
    ja, ta = np.asarray(j.replay.actions), t.replay.actions.numpy()
    jr, tr = np.asarray(j.replay.rewards), t.replay.rewards.numpy()
    assert ta.shape == ja.shape == (8, 1024)
    np.testing.assert_array_equal(ta, ja)
    filled = np.isfinite(jr)
    np.testing.assert_array_equal(np.isfinite(tr), filled)
    assert filled.sum() == 3
    lengths = (ta >= 0).sum(-1)[filled]
    deletions = sorted(int(f * 1645) for f in (0.2, 0.3, 0.4))
    assert sorted(lengths - 1) == deletions
    assert all((row[n:] == -1).all() and row[n - 1] == 1645
               for row, n in zip(ta[filled], lengths))
    np.testing.assert_allclose(tr[filled], jr[filled], **recipe["tol"]["reward"])


def test_warmstart_steps_equal_jax(recipe, capsys):
    """(b)"""
    j, t, j2, t2, j_nll, t_nll = _warm(recipe, capsys)
    rtol = recipe["tol"]["nll"]
    assert len(j_nll) == len(t_nll) == 3
    for (tn, td), (jn, jd) in zip(t_nll, j_nll):
        assert abs(tn - jn) <= rtol * abs(jn) + 0.005, (tn, jn)
        assert abs(td - jd) <= rtol * abs(jd) + 0.005, (td, jd)
    assert t_nll[2][0] < t_nll[0][0]
    if recipe["exact"]:
        _hold_deltas(t.params, t2.params, j.params, j2.params)
    assert float(t2.params.forward.feat_w[0]) != 0.0


def test_subtb_step_with_beta_and_edge_features_equals_jax(recipe, capsys, monkeypatch):
    """(c)"""
    r, tol = recipe, recipe["tol"]
    _, _, j2, t2, _, _ = _warm(r, capsys)
    A, B = r["tmcfg"].num_actions, r["tcfg"].batch_size
    g = np.random.default_rng(NOISE_SEED).gumbel(size=(B, A)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=None:
                        jnp.asarray(g, dtype))
    monkeypatch.setattr(t_rollout, "gumbel_noise", lambda shape, gen, dtype=None,
                        device=None: torch.as_tensor(g, dtype=dtype, device=device))
    draw = np.asarray(DRAW)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, shape=None, axis=-1: jnp.asarray(draw))
    monkeypatch.setattr(torch, "multinomial",
                        lambda probs, num, replacement=False, generator=None:
                        torch.as_tensor(draw))
    j_before = jax.tree_util.tree_map(np.asarray, j2.params)
    j3, jm = j_loop.make_train_step(r["jcfg"], r["jenv"], r["jgraph"], r["jmcfg"],
                                    r["jopt"])(j2)
    t3, tm = t_loop.make_train_step(r["tcfg"], r["tenv"], r["tgraph"], r["tmcfg"],
                                    r["topt"])(t2)
    assert not bool(jm["skipped"]) and not bool(tm["skipped"])
    jl, tl = float(jm["loss"]), float(tm["loss"])
    assert np.isfinite(jl) and abs(jl) > 1.0
    np.testing.assert_allclose(tl, jl, rtol=tol["loss"])
    jr, tr = np.asarray(jm["rewards"]), tm["rewards"].numpy()
    np.testing.assert_allclose(50.0 * t_log_reward(torch.as_tensor(tr)).numpy(),
                               50.0 * np.asarray(j_log_reward(jnp.asarray(jr))),
                               rtol=tol["nll"])
    np.testing.assert_array_equal(tm["lengths"].numpy(), np.asarray(jm["lengths"]))
    assert int(tm["lengths"].min()) > 1
    np.testing.assert_array_equal(t3.replay.actions.numpy(), np.asarray(j3.replay.actions))
    np.testing.assert_allclose(t3.replay.rewards.numpy(), np.asarray(j3.replay.rewards),
                               **tol["reward"])
    if r["exact"]:
        _hold_deltas(t2.params, t3.params, j_before, j3.params)

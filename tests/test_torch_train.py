"""The training slice of the port against the JAX package: ``loss_fn``
values and every parameter group's gradient on the bucketed tiled graph
(carried-over params, shared Gumbel noise), the optimizer against the optax
chain, the train step and its NaN guard, checkpoint save → restore →
continue, the enumeration stamp, and the train and sample CLIs.

Tolerances: ``loss_fn`` value rtol 5e-4; gradients rtol 5e-4 and atol 5e-5
times the largest gradient magnitude in the leaf's parameter group (one
GAT layer, the head, the backward policy, the flow head): the repo's bound
for the tiled GAT's gradients (tests/test_segment.py), scaled because the
fused backward and the scans sum in another order, and a layer's
``w_dst``/``w_edge``/``att`` gradients are float32 sums that cancel to
~1e-9 of the layer's ``w_src`` gradient on both sides.  The optimizer: rtol 1e-6 (same float32 arithmetic, only
the bias corrections' rounding may differ).  Checkpoint resume: exact (the
same CPU arithmetic in the same order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.gfn import gflownet as j_gfn
from gflownet_spai_tpu.train import TrainConfig as JConfig
from gflownet_spai_tpu.train import enums as j_enums
from gflownet_spai_tpu.train import loop as j_loop
from gflownet_spai_tpu.train import setup as j_setup
from gflownet_spai_tpu_torch.convert import params_from_jax
from gflownet_spai_tpu_torch.gfn import gflownet as t_gfn
from gflownet_spai_tpu_torch.gfn import replay as t_replay
from gflownet_spai_tpu_torch.gfn import rollout as t_rollout
from gflownet_spai_tpu_torch.sample.__main__ import main as sample_main
from gflownet_spai_tpu_torch.train import TrainConfig as TConfig
from gflownet_spai_tpu_torch.train import enums as t_enums
from gflownet_spai_tpu_torch.train import loop as t_loop
from gflownet_spai_tpu_torch.train.__main__ import main as train_main

TILED = dict(matrix="orsirr_like16", env_format="coo", gat_tiled_min_edges=0)
SMALL = dict(matrix="LF10_like", env_format="coo")


@pytest.fixture(scope="module")
def tiled():
    _, _, jenv, jgraph, jmcfg, _, _ = j_setup(JConfig(**TILED))
    _, _, tenv, tgraph, tmcfg, _, _ = t_loop.setup(TConfig(platform="cpu", **TILED))
    assert tgraph.gat_buckets is not None and len(tgraph.gat_buckets) == 2
    return jenv, jgraph, jmcfg, tenv, tgraph, tmcfg


def _share_noise(monkeypatch, B, A, seed):
    g = np.random.default_rng(seed).gumbel(size=(B, A)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=None:
                        jnp.asarray(g, dtype))
    monkeypatch.setattr(t_rollout, "gumbel_noise", lambda shape, gen, dtype=None,
                        device=None: torch.as_tensor(g, dtype=dtype, device=device))


def _replay_batch(A, T):
    acts = np.full((3, T), -1, np.int64)
    acts[0, :4] = [5, 17, 2, A - 1]
    acts[1, :2] = [40, A - 1]                 # row 2 stays empty (invalid)
    return acts, np.array([True, True, False])


@pytest.mark.parametrize("loss,backward,t_cap,alpha_fixed,replay", [
    ("tb", "lstm", 0, -1.0, False),
    ("vargrad", "uniform", 0, -1.0, False),
    ("subtb", "linear", 64, 0.98, True),
])
def test_loss_fn_matches_jax(tiled, monkeypatch, loss, backward, t_cap,
                             alpha_fixed, replay):
    jenv, jgraph, jmcfg, tenv, tgraph, tmcfg = tiled
    kw = dict(loss=loss, backward=backward, t_cap=t_cap, alpha_fixed=alpha_fixed)
    jmcfg, tmcfg = jmcfg._replace(**kw), tmcfg._replace(**kw)
    A, B = tmcfg.num_actions, 3
    _share_noise(monkeypatch, B, A, seed=len(loss))
    jparams = j_gfn.init_params(jax.random.PRNGKey(2), jmcfg, dtype=jnp.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    j_rep = t_rep = None
    if replay:
        acts, valid = _replay_batch(A, t_cap)
        j_rep = (jnp.asarray(acts, jnp.int32), jnp.asarray(valid))
        t_rep = (torch.as_tensor(acts), torch.as_tensor(valid))
    (jl, jaux), jg = jax.jit(lambda p, r: jax.value_and_grad(
        j_gfn.loss_fn, has_aux=True)(p, jenv, jgraph, jmcfg, jax.random.PRNGKey(0),
                                     B, replay=r))(jparams, j_rep)
    leaves = [x.requires_grad_(True) for _, x in t_loop.tree_leaves(tparams)]
    tparams = t_loop.tree_replace(tparams, iter(leaves))
    tl, taux = t_gfn.loss_fn(tparams, tenv, tgraph, tmcfg, None, B, replay=t_rep)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_array_equal(taux["actions"].numpy(), np.asarray(jaux["actions"]))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=5e-4)
    jleaves = [np.asarray(w) for w in jax.tree_util.tree_leaves(jg)]
    assert len(jleaves) == len(leaves)
    paths = [p for p, _ in t_loop.tree_leaves(tparams)]
    group = lambda p: p.rsplit("/", 1)[0]
    scale = {}
    for p, w in zip(paths, jleaves):
        scale[group(p)] = max(scale.get(group(p), 0.0), float(np.abs(w).max()))
    for p, g, w in zip(paths, tg, jleaves):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5 * scale[group(p)],
                                   err_msg=p)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patience", [0, 2])
def test_optimizer_matches_optax(patience):
    """A gradient sequence with flat values (a plateau cut), one ``inf``
    value (the NaN guard's) and zero gradients."""
    rng = np.random.default_rng(patience)
    shapes = [(3, 4), (5,), ()]
    jcfg = JConfig(lr=1e-2, plateau_patience=patience)
    jopt = j_loop.make_optimizer(jcfg)
    topt = t_loop.make_optimizer(TConfig(lr=1e-2, plateau_patience=patience))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jstate = jopt.init([jnp.asarray(p) for p in params])
    tstate = topt.init([torch.as_tensor(p) for p in params])
    values = [5.0, 5.0, 3.0, 3.0] + [3.0] * 8 + [np.inf, 3.0] + [3.0] * 6
    for i, v in enumerate(values):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        if not np.isfinite(v):
            grads = [np.zeros_like(g) for g in grads]
        ju, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate,
                                 [jnp.asarray(p) for p in params], value=v)
        tu, tstate = topt.update([torch.as_tensor(g) for g in grads], tstate,
                                 value=torch.tensor(v, dtype=torch.float32))
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12, err_msg=f"step {i}")
    if patience:
        jp = jstate[1]
        assert float(tstate.plateau.scale) < 1.0          # the cut happened
        np.testing.assert_allclose(float(tstate.plateau.scale), float(jp.scale),
                                   rtol=1e-6)
        assert int(tstate.plateau.cooldown_count) == int(jp.cooldown_count)
        assert int(tstate.plateau.plateau_count) == int(jp.plateau_count)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _small_cfg(tmp_path, **kw):
    base = dict(SMALL, batch_size=4, loss="subtb", backward="linear", t_cap=16,
                replay_size=8, replay_samples=2, replay_prioritized=1.0,
                plateau_patience=1, lr=5e-3, out_dir=str(tmp_path), log_every=1)
    base.update(kw)
    return base


def test_train_step_metrics_and_nan_guard(tmp_path, monkeypatch):
    cfg = TConfig(platform="cpu", **_small_cfg(tmp_path, plateau_patience=3))
    _, _, env, graph, mcfg, opt, state = t_loop.setup(cfg)
    step = t_loop.make_train_step(cfg, env, graph, mcfg, opt)
    new, metrics = step(state)
    assert new.epoch == 1 and torch.isfinite(metrics["loss"])
    # JAX's step reports the same metrics
    jcfg = JConfig(**_small_cfg(tmp_path, plateau_patience=3))
    _, _, jenv, jgraph, jmcfg, jopt, jstate = j_setup(jcfg)
    _, jmetrics = j_loop.make_train_step(jcfg, jenv, jgraph, jmcfg, jopt)(jstate)
    assert set(metrics) == set(jmetrics)
    assert int((new.replay.rewards > -np.inf).sum()) > 0
    # a non-finite loss: zero gradients into Adam (its moments decay, its
    # count advances, and the momentum still moves the parameters) and inf
    # into the plateau average: optax's update from the same state
    real = t_gfn.loss_fn
    monkeypatch.setattr(t_gfn, "loss_fn", lambda *a, **k: (
        lambda l, aux: (l * float("nan"), aux))(*real(*a, **k)))
    after, m2 = step(new)
    assert bool(m2["skipped"])
    flat = [jnp.asarray(x.numpy()) for _, x in t_loop.tree_leaves(new.params)]
    st = new.opt_state
    j0 = jopt.init(flat)
    j_adam = j0[0][0]._replace(count=jnp.asarray(int(st.adam.count), jnp.int32),
                               mu=[jnp.asarray(m.numpy()) for m in st.adam.mu],
                               nu=[jnp.asarray(v.numpy()) for v in st.adam.nu])
    j_plateau = j0[1]._replace(**{f: jnp.asarray(getattr(st.plateau, f).numpy())
                                  for f in j0[1]._fields})
    ju, jst = jopt.update([jnp.zeros_like(x) for x in flat],
                          ((j_adam, j0[0][1]), j_plateau), flat, value=jnp.inf)
    for (path, a), p, u in zip(t_loop.tree_leaves(after.params), flat, ju):
        np.testing.assert_allclose(a.numpy(), np.asarray(p + u), rtol=1e-6,
                                   atol=1e-7, err_msg=path)
    assert int(after.opt_state.adam.count) == int(jst[0][0].count) == 2
    assert float(after.opt_state.plateau.avg_value) == float(jst[1].avg_value) \
        == np.inf


# ---------------------------------------------------------------------------
# Checkpoints and the enumeration stamp
# ---------------------------------------------------------------------------

def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    kw = _small_cfg(tmp_path)
    full, _ = t_loop.train(TConfig(platform="cpu", num_epochs=4,
                                   **{**kw, "out_dir": str(tmp_path / "a")}),
                           progress=False)
    t_loop.train(TConfig(platform="cpu", num_epochs=2,
                         **{**kw, "out_dir": str(tmp_path / "b")}), progress=False)
    resumed, hist = t_loop.train(TConfig(platform="cpu", num_epochs=4, resume=True,
                                         **{**kw, "out_dir": str(tmp_path / "b")}),
                                 progress=False)
    assert resumed.epoch == full.epoch == 4 and len(hist) == 2
    for (path, a), (_, b) in zip(t_loop.tree_leaves(resumed.params),
                                 t_loop.tree_leaves(full.params)):
        assert torch.equal(a, b), path
    assert torch.equal(resumed.replay.actions, full.replay.actions)
    lines = (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1, 2, 3]


def test_enum_stamp_files_equal_jax(tmp_path):
    _, _, jenv, *_ = j_setup(JConfig(**SMALL))
    _, _, tenv, *_ = t_loop.setup(TConfig(platform="cpu", **SMALL))
    j_enums.save_enum_meta(str(tmp_path / "j"), jenv)
    t_enums.save_enum_meta(str(tmp_path / "t"), tenv)
    for name in ("enum.json", "enum_perm.npy"):
        assert (tmp_path / "t" / "checkpoint" / name).read_bytes() \
            == (tmp_path / "j" / "checkpoint" / name).read_bytes()
    # a permuted enumeration of the same edge set remaps, exactly
    meta = t_enums.enumeration_meta(tenv)
    assert meta["order"] == "sorted"
    _, _, _, _, _, _, state = t_loop.setup(TConfig(platform="cpu", backward="linear",
                                                   **SMALL))
    same, remapped = t_enums.reconcile(str(tmp_path / "t"), tenv, state, "linear")
    assert not remapped and same is state


def test_restore_conforms_replay_width(tmp_path):
    """The oracle of tests/test_train.py: a template at another replay
    width restores the stored width, which ``train`` then resizes."""
    cfg = TConfig(platform="cpu", replay_size=4, t_cap=8, **SMALL)
    _, _, env, _, _, _, state = t_loop.setup(cfg)
    assert state.replay.actions.shape[1] == 8
    acts = torch.full((1, 8), -1, dtype=torch.int64)
    acts[0, 0] = env.num_edges
    state = state._replace(replay=t_replay.replay_update(
        state.replay, acts, torch.tensor([3.5])))
    t_loop.save_checkpoint(str(tmp_path), state)
    wide = state._replace(replay=t_replay.replay_init(4, env.num_actions))
    restored = t_loop.restore_checkpoint(str(tmp_path), wide)
    assert restored.replay.actions.shape == (4, 8)
    filled = torch.isfinite(restored.replay.rewards)
    assert int(filled.sum()) == 1
    assert float(restored.replay.rewards[filled][0]) == 3.5


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def test_train_then_sample_cli(tmp_path, capsys):
    run = str(tmp_path / "run")
    flags = ["--matrix", "LF10_like", "--env-format", "coo", "--loss", "subtb",
             "--backward", "linear", "--t-cap", "16", "--replay-size", "4",
             "--plateau-patience", "0"]
    assert train_main(flags + ["--epochs", "3", "--batch-size", "4",
                               "--replay-samples", "2", "--out-dir", run,
                               "--platform", "cpu", "--log-every", "1"]) == 0
    assert (tmp_path / "run" / "checkpoint" / "epoch_3.pt").exists()
    assert len((tmp_path / "run" / "training_log.csv").read_text().splitlines()) == 4
    mtx = tmp_path / "best.mtx"
    assert sample_main(flags + ["--run-dir", run, "--num-samples", "10",
                                "--batch-size", "8", "--platform", "cpu",
                                "--export-mtx", str(mtx)]) == 0
    assert "restored epoch 3" in capsys.readouterr().out
    summary = json.loads((tmp_path / "run" / "sample_summary.json").read_text())
    assert summary["samples"] == 10 and np.isfinite(summary["reward_mean"])
    assert mtx.read_text().startswith("%%MatrixMarket matrix coordinate real general")


@pytest.mark.parametrize("flags", [["--multihost"], ["--dp-devices", "2"],
                                   ["--sampler", "sharded", "--rows-devices", "2"]])
def test_multi_device_flags_raise(flags, monkeypatch):
    """The multi-device flags run on ``parallel/``; on one process without
    the ranks they ask for they raise: a half-set bootstrap environment, a
    mesh larger than the world."""
    for var in ("GFNSPAI_COORDINATOR", "GFNSPAI_NUM_PROCS", "GFNSPAI_PROC_ID",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    if "--multihost" in flags:
        monkeypatch.setenv("GFNSPAI_COORDINATOR", "localhost:1")
    match = "all three" if "--multihost" in flags else "need 2 ranks"
    with pytest.raises(ValueError, match=match):
        train_main(["--platform", "cpu", "--matrix", "LF10_like", *flags])


# ---------------------------------------------------------------------------
# The rowblock and DIA envs in the train path
# ---------------------------------------------------------------------------

def _env_kind(env):
    return ("dia" if type(env).__name__ == "SpaiDiaEnv" else
            "rowblock" if env.rb is not None else "coo")


@pytest.mark.parametrize("matrix,want", [("LF10_like", "dia"), ("olm500_like", "dia"),
                                         ("poisson32", "coo"), ("orsirr_like32", "coo"),
                                         ("bcsstk03_like", "coo")])
def test_auto_env_format_resolves_as_jax(matrix, want):
    """``env_format="auto"``: banded seeds without phantom slots take the DIA
    env, as in JAX's ``setup`` (poisson32's ILU(0) seed stores zeros inside
    its diagonals, so it does not); ``rowblock_min_nnz`` sends the rest to
    the row-block env."""
    _, _, jenv, *_ = j_setup(JConfig(matrix=matrix))
    a, seed, tenv, *_ = t_loop.setup(TConfig(matrix=matrix, platform="cpu"))
    assert _env_kind(tenv) == _env_kind(jenv) == want
    assert tenv.num_actions == jenv.num_actions
    cfg = TConfig(matrix=matrix, rowblock_min_nnz=100)
    assert t_loop.resolve_env_format(cfg, a, seed) == (
        "dia" if want == "dia" else "rowblock")


def test_default_train_cli_runs_the_dia_env(tmp_path):
    """``train`` with every argument at its default (LF10_like → the DIA
    env): finite losses, the DIA enumeration stamped."""
    run = tmp_path / "run"
    assert train_main(["--epochs", "4", "--out-dir", str(run), "--platform", "cpu",
                       "--log-every", "1"]) == 0
    recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert json.loads((run / "checkpoint" / "enum.json").read_text())["order"] == "dia"


def test_train_tiled_graph_rowblock_end_to_end(tmp_path):
    """The oracle of tests/test_train.py: the train loop with the tiled
    graph and the rowblock reward forced on runs 12 finite epochs, then
    checkpoints and restores."""
    cfg = TConfig(matrix="poisson32", num_epochs=12, batch_size=4, backward="linear",
                  loss="subtb", lr=5e-3, env_format="rowblock", gat_tiled_min_edges=1,
                  out_dir=str(tmp_path), platform="cpu")
    _, seed, env, graph, mcfg, opt, state = t_loop.setup(cfg)
    assert graph.gat_buckets is not None and env.rb is not None
    assert env.rb.edge_perm is not None
    np.testing.assert_array_equal(seed.row, env.seed.row.numpy())
    step = t_loop.make_train_step(cfg, env, graph, mcfg, opt)
    for _ in range(cfg.num_epochs):
        state, m = step(state)
        assert np.isfinite(float(m["loss"]))
    t_loop.save_checkpoint(cfg.out_dir, state, env=env)
    restored = t_loop.restore_checkpoint(cfg.out_dir, state)
    assert restored.epoch == state.epoch == 12
    assert torch.equal(restored.params.log_z, state.params.log_z)
    same, remapped = t_enums.reconcile(cfg.out_dir, env, restored, "linear")
    assert not remapped


@pytest.mark.parametrize("kw", [dict(matrix="LF10_like"),
                                dict(matrix="orsirr_like32", env_format="rowblock"),
                                dict(matrix="orsirr_like32", env_format="rowblock",
                                     rowblock_order="sorted")])
def test_enum_stamp_files_equal_jax_every_order(tmp_path, kw):
    """``enum.json`` and ``enum_perm.npy`` byte-equal to JAX's for the dia,
    window and sorted orders."""
    _, _, jenv, *_ = j_setup(JConfig(**kw))
    _, _, tenv, *_ = t_loop.setup(TConfig(platform="cpu", **kw))
    j_enums.save_enum_meta(str(tmp_path / "j"), jenv)
    t_enums.save_enum_meta(str(tmp_path / "t"), tenv)
    for name in ("enum.json", "enum_perm.npy"):
        assert (tmp_path / "t" / "checkpoint" / name).read_bytes() \
            == (tmp_path / "j" / "checkpoint" / name).read_bytes()


def _edge_match(new, old, n):
    """o_idx with new edge j == old edge o_idx[j], by (row, col)."""
    k_old = np.asarray(old.row).astype(np.int64) * n + np.asarray(old.col)
    k_new = np.asarray(new.row).astype(np.int64) * n + np.asarray(new.col)
    order = np.argsort(k_old)
    return order[np.searchsorted(k_old[order], k_new)]


@pytest.mark.parametrize("old_kw,new_kw", [
    (dict(matrix="orsirr_like32", env_format="rowblock", rowblock_order="sorted"),
     dict(matrix="orsirr_like32", env_format="rowblock", rowblock_order="window")),
    (dict(matrix="LF10_like", env_format="coo"), dict(matrix="LF10_like")),
])
def test_restore_across_orders_remaps_exactly(tmp_path, old_kw, new_kw):
    """Sorted → window and sorted → dia: the restored policy's logits follow
    the edge relabelling exactly, as JAX's ``reconcile`` remaps (the oracle
    of tests/test_enums.py); replayed actions name the same edges."""
    from gflownet_spai_tpu_torch.env import spai_dia
    from gflownet_spai_tpu_torch.models import policies as pol

    common = dict(backward="linear", loss="subtb", batch_size=2, replay_size=4, t_cap=4,
                  replay_samples=1, plateau_patience=0, reward_baseline="identity",
                  out_dir=str(tmp_path), platform="cpu")
    _, _, env_o, graph_o, mcfg, _, state = t_loop.setup(TConfig(**old_kw, **common))
    acts = torch.full((1, 4), -1, dtype=torch.int64)
    acts[0, :3] = torch.tensor([2, 5, env_o.num_edges])
    state = state._replace(replay=t_replay.replay_update(state.replay, acts,
                                                         torch.tensor([1.0])))
    t_loop.save_checkpoint(str(tmp_path), state, env=env_o)
    _, _, env_n, graph_n, mcfg_n, opt_n, tmpl = t_loop.setup(TConfig(**new_kw, **common))
    restored = t_loop.restore_checkpoint(str(tmp_path), tmpl)
    new, remapped = t_enums.reconcile(str(tmp_path), env_n, restored, "linear", opt=opt_n)
    assert remapped
    edges = lambda e: (spai_dia.edge_coo(e) if isinstance(e, spai_dia.SpaiDiaEnv)
                       else e.seed.numpy())
    o_idx = _edge_match(edges(env_n), edges(env_o), env_o.n)
    assert (o_idx != np.arange(len(o_idx))).any()
    lg_o = pol.forward_policy_logits(state.params.forward, graph_o, mcfg.num_actions,
                                     mcfg.hidden_dim)
    lg_n = pol.forward_policy_logits(new.params.forward, graph_n, mcfg_n.num_actions,
                                     mcfg_n.hidden_dim)
    np.testing.assert_allclose(lg_n[:-1].detach().numpy(), lg_o[o_idx].detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(lg_n[-1]) == pytest.approx(float(lg_o[-1]), rel=1e-6)
    row = new.replay.actions[torch.isfinite(new.replay.rewards)][0]
    assert o_idx[int(row[0])] == 2 and o_idx[int(row[1])] == 5
    assert int(row[2]) == env_n.num_edges


def test_magnitude_demos_dia_env_uses_edge_enumeration():
    """The oracle of tests/test_train.py: on a DIA env the demonstrations
    come from the (diagonal, row) edge enumeration, equal to JAX's."""
    from gflownet_spai_tpu_torch.env import spai_dia

    kw = dict(matrix="LF10_like", seed_method="spai", seed_k=2)
    _, _, jenv, *_ = j_setup(JConfig(**kw))
    _, _, env, *_ = t_loop.setup(TConfig(platform="cpu", **kw))
    assert isinstance(env, spai_dia.SpaiDiaEnv)
    demos = t_loop._magnitude_demos(env, [0.5], env.num_actions)
    np.testing.assert_array_equal(demos, j_loop._magnitude_demos(jenv, [0.5],
                                                                 jenv.num_actions))
    acts = demos[0][demos[0] >= 0]
    assert acts[-1] == env.num_edges
    vals = np.abs(spai_dia.edge_coo(env).data)
    kept = np.setdiff1d(np.arange(env.num_edges), acts[:-1])
    assert vals[acts[:-1]].max() <= vals[kept].min() + 1e-12


def test_best_sampled_matrix_dia_env_equals_jax():
    from gflownet_spai_tpu.solvers.validate import best_sampled_matrix as j_best
    from gflownet_spai_tpu_torch.solvers.validate import best_sampled_matrix as t_best

    _, _, jenv, *_ = j_setup(JConfig(matrix="LF10_like"))
    _, _, tenv, *_ = t_loop.setup(TConfig(matrix="LF10_like", platform="cpu"))
    acts = np.full((3, tenv.num_actions), -1, np.int64)
    acts[0, :3] = [4, 9, tenv.num_edges]
    acts[1, :4] = [0, 17, 30, tenv.num_edges]
    acts[2, :1] = [tenv.num_edges]
    rewards = np.array([1.0, 3.0, 2.0], np.float32)
    want = j_best(jenv, jnp.asarray(acts, jnp.int32), jnp.asarray(rewards))
    got = t_best(tenv, torch.as_tensor(acts), torch.as_tensor(rewards))
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))

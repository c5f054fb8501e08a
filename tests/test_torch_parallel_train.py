"""The training side of the port's ``parallel/`` against the JAX package:
the dp step, the sharded head, the sharded sampler and its train step, the
tile-sharded GAT, the sharded residual providers, the train loop's
adapters and ``CapLadder``.

One gloo world of four ranks runs every multi-rank case once (a
module-scoped fixture spawns ``python <this file> rank world dir``, the
ranks meet through a ``file://`` rendezvous and write their results with
``pickle``); the tests assert on the results.  The JAX side runs in the
pytest process on a JAX mesh of the same shape from conftest's eight
virtual devices: (1, 4), (2, 2) or (4, 1).  Inputs are made from seeds:
JAX's parameters (carried over with ``convert``), JAX's own Gumbel noise
fed to the port (the ``gumbels`` arguments), numpy for the rest.

Tolerances: sharded rollouts the same actions up to the terminal, log-probs
rtol 1e-5 (atol 1e-6); losses rtol 2e-4; SpMV-like residuals in float64
rtol 1e-9; gradients as SGD(lr 1) parameter deltas against JAX's and
against autograd of the replicated oracle loss: |Δ − Δref| ≤ 1e-6 + 1e-4 ·
max|Δref| over the leaf's parameter group (one GAT layer, the head, the
backward policy, the flow head; a layer's ``w_dst`` / ``w_edge`` / ``att``
gradients are float32 sums that cancel to ~1e-9 of its ``w_src``
gradient, as in ``test_torch_train.py``).
"""

import functools
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WORLD = 4
JOIN_S = 110          # the ranks' whole run; the process group's own timeout is 100 s
LF10, BCS, ORS = "LF10_like", "bcsstk03_like", "orsirr_like32"


# ---------------------------------------------------------------------------
# Shared helpers (numpy / torch only: the ranks import them too)
# ---------------------------------------------------------------------------

class SGD:
    """optax.sgd(lr) in the port optimizer's interface."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, leaves):
        return ()

    def update(self, grads, state, value=None):
        return [-self.lr * g for g in grads], state


@functools.lru_cache(maxsize=None)
def _t_problem(matrix, seed_method="ilu0", reward_path="pair", baseline="auto",
               dia=False, rowblock_order="sorted", seed_k=None):
    """The port's float32 env and graph of ``matrix``."""
    from gflownet_spai_tpu_torch.env import make_env, seed_pattern, spai_dia
    from gflownet_spai_tpu_torch.models import graph_from_seed
    from gflownet_spai_tpu_torch.sparse import gallery
    from gflownet_spai_tpu_torch.sparse.types import COO

    a = gallery.get(matrix)
    a = COO(row=a.row, col=a.col, data=np.asarray(a.data, np.float32), shape=a.shape)
    seed = seed_pattern(a, method=seed_method, dtype=np.float32,
                        **({} if seed_k is None else {"k": seed_k}))
    if dia:
        env = spai_dia.make_dia_env(seed, a, device="cpu")
        return env, graph_from_seed(spai_dia.edge_coo(env), device="cpu")
    env = make_env(seed, original=a, reward_path=reward_path, baseline=baseline,
                   rowblock_order=rowblock_order, device="cpu")
    return env, graph_from_seed(env.seed.numpy(), device="cpu")


def _leaves(params):
    from gflownet_spai_tpu_torch.gfn.gflownet import tree_leaves

    return tree_leaves(params)


def _np(t):
    return t.detach().cpu().numpy()


def _deltas(new, old):
    return {p: _np(a) - _np(b) for (p, a), (_, b) in zip(_leaves(new), _leaves(old))}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, workdir):
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=100))
    from gflownet_spai_tpu_torch.parallel import make_mesh

    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    meshes = {(1, 4): make_mesh(1, 4, "cpu"), (2, 2): make_mesh(2, 2, "cpu"),
              (4, 1): make_mesh(4, 1, "cpu")}
    out = {}
    for name, fn in CASES.items():
        t0 = time.perf_counter()
        out[name] = fn(meshes, inputs[name] if name in inputs else None, workdir)
        out[name + "/s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _case_residual_pair(meshes, inp, _):
    from gflownet_spai_tpu_torch.env import make_env, seed_pattern
    from gflownet_spai_tpu_torch.parallel.dp import _pad_pairs
    from gflownet_spai_tpu_torch.parallel import sharded_residual_norms
    from gflownet_spai_tpu_torch.sparse import gallery

    a = gallery.get(LF10)
    env = make_env(seed_pattern(a, method="ilu0", dtype=np.float64), original=a,
                   device="cpu")
    keep = torch.as_tensor(inp["keep"])
    m_vals = env.seed.data[None, :] * keep.to(env.seed.data.dtype)
    mesh = meshes[(2, 2)]
    got = sharded_residual_norms(mesh, _pad_pairs(env, 2), m_vals, env.plan.out_nnz)
    return _np(got)


def _case_residual_rowblock(meshes, inp, _):
    from gflownet_spai_tpu_torch.parallel import sharded_rowblock_residual_norms

    env, _g = _t_problem("poisson32", reward_path="rowblock")
    keep = torch.as_tensor(inp["keep"])
    m_vals = env.seed.data[None, :] * keep.to(env.seed.data.dtype)
    return _np(sharded_rowblock_residual_norms(meshes[(2, 2)], env, m_vals))


def _case_tp_logits(meshes, inp, _):
    from gflownet_spai_tpu_torch.parallel import shard_head, sharded_policy_logits

    env, graph = _t_problem(LF10)
    mesh = meshes[(1, 4)]
    fwd = shard_head(mesh, inp["params"].forward)
    return {"logits": _np(sharded_policy_logits(mesh, fwd, graph, env.num_actions, 4)),
            "a_loc": fwd.fc_w.shape[1]}


def _rollout(mesh, params_fwd, graph, A, noise, t_cap, **kw):
    from gflownet_spai_tpu_torch.parallel import shard_head, sharded_rollout

    j = mesh.index("rows")
    out = sharded_rollout(mesh, shard_head(mesh, params_fwd), graph, A, 4, 0,
                          batch_size=noise[j].shape[0], t_cap=t_cap,
                          gumbels=torch.as_tensor(noise[j]), **kw)
    return {"actions": _np(out.rollout.actions), "lp": _np(out.rollout.fwd_logprobs),
            "lengths": _np(out.rollout.lengths), "valid": _np(out.valid),
            "logits_local": _np(out.logits_local)}


def _case_rollout_exact(meshes, inp, _):
    from gflownet_spai_tpu_torch.parallel import shard_head, sharded_rollout

    env, graph = _t_problem(BCS)
    A = env.num_actions
    out = {t: _rollout(meshes[(1, 4)], inp["params"].forward, graph, A, inp["noise"], t)
           for t in (A, 64)}
    mesh = meshes[(1, 4)]
    own = sharded_rollout(mesh, shard_head(mesh, inp["params"].forward), graph, A, 4, 9,
                          batch_size=3, t_cap=A)
    out["own"] = {"actions": _np(own.rollout.actions), "lp": _np(own.rollout.fwd_logprobs)}
    return out


def _case_rollout_temperature(meshes, inp, _):
    env, graph = _t_problem(BCS)
    return _rollout(meshes[(1, 4)], inp["params"].forward, graph, env.num_actions,
                    inp["noise"], env.num_actions, temperature=2.5)


def _case_rollout_short_tcap(meshes, inp, _):
    env, graph = _t_problem(BCS)
    A = env.num_actions
    fwd = inp["params"].forward
    trained = fwd._replace(fc_b=fwd.fc_b.clone())
    trained.fc_b[A - 1] += 12.0
    return {"trained": _rollout(meshes[(1, 4)], trained, graph, A, inp["noise"], 32),
            "untrained": _rollout(meshes[(1, 4)], fwd, graph, A, inp["noise"], 32)}


def _case_rollout_edge_feats(meshes, inp, _):
    env, graph = _t_problem(BCS, seed_method="spai", seed_k=1)
    A = env.num_actions
    fwd = inp["params"].forward
    return {"feats": _rollout(meshes[(1, 4)], fwd._replace(feat_w=torch.tensor([-1.7])),
                              graph, A, inp["noise"], A),
            "zero": _rollout(meshes[(1, 4)], fwd, graph, A, inp["noise"], A)}


def _sampler_step(mesh, env, graph, cfg, opt, params, batch, t_cap, noise, seed=0,
                  replay=None, **kw):
    """One sharded-sampler step on this rank: SGD deltas and the outputs."""
    from gflownet_spai_tpu_torch.parallel.sampler import make_sharded_sampler_train_step

    step, shard_fwd, _ = make_sharded_sampler_train_step(
        mesh, env, graph, cfg, opt, batch_size=batch, t_cap=t_cap,
        replay_samples=0 if replay is None else replay[0].shape[0], **kw)
    p = shard_fwd(params)
    st = opt.init([x for _, x in _leaves(p)])
    g = None if noise is None else torch.as_tensor(
        noise[mesh.index("dp")][mesh.index("rows")])
    rep = () if replay is None else tuple(torch.as_tensor(r) for r in replay)
    out = step(p, st, seed, *rep, gumbels=g)
    res = {"loss": float(out[2]), "rewards": _np(out[3]), "valid": _np(out[4]),
           "lengths": _np(out[5]), "deltas": _deltas(out[0], p)}
    if replay is not None:
        res["actions"] = _np(out[6])
    return res


def _case_sampler_tb(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(LF10)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear")
    return {shape: _sampler_step(meshes[shape], env, graph, cfg, SGD(1.0), inp["params"],
                                 4, env.num_actions, inp["noise"][shape])
            for shape in ((1, 4), (2, 2))}


def _case_sampler_subtb(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(LF10)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear", loss="subtb", subtb_lambda=0.9)
    return _sampler_step(meshes[(2, 2)], env, graph, cfg, SGD(1.0), inp["params"], 4,
                         env.num_actions, inp["noise"])


def _case_sampler_replay(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(LF10)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear")
    return _sampler_step(meshes[(2, 2)], env, graph, cfg, SGD(1.0), inp["params"], 4,
                         env.num_actions, inp["noise"], replay=inp["replay"])


def _case_sampler_partial(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(BCS)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear", loss="subtb")
    return {part: _sampler_step(meshes[(2, 2)], env, graph, cfg, SGD(1e-3), inp["params"],
                                4, 16, inp["noise"], partial_subtb=part)
            for part in (True, False)}


def _train_steps(mesh, env, graph, cfg, params, steps, batch=4, t_cap=None):
    """``steps`` Adam(5e-3) sharded-sampler steps on the port's own noise."""
    from gflownet_spai_tpu_torch.parallel.sampler import make_sharded_sampler_train_step
    from gflownet_spai_tpu_torch.train.loop import Optimizer

    opt = Optimizer(lr=5e-3)
    step, shard_fwd, _ = make_sharded_sampler_train_step(
        mesh, env, graph, cfg, opt, batch_size=batch, t_cap=t_cap or env.num_actions)
    p = shard_fwd(params)
    st = opt.init([x for _, x in _leaves(p)])
    hist, valid, rewards = [], [], []
    for s in range(steps):
        p, st, loss, rew, v, _ = step(p, st, 100 + s)
        hist.append(float(loss))
        valid.append(_np(v))
        rewards.append(_np(rew))
    return {"hist": np.array(hist), "valid": np.array(valid),
            "rewards": np.array(rewards), "params": p}


def _case_sampler_window(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(ORS, seed_method="pattern", reward_path="rowblock",
                            baseline="identity", rowblock_order="window")
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear")
    out = _train_steps(meshes[(2, 2)], env, graph, cfg, inp["params"], 12)
    out.pop("params")
    return out


def _tiled_problem():
    from gflownet_spai_tpu_torch.models.policies import tiled_graph_from_seed

    env, _g = _t_problem(ORS, baseline="identity")
    tg = tiled_graph_from_seed(env.seed.numpy(), tile_nodes=32, bucket_step=None,
                               device="cpu")
    return env, tg


def _case_gat_pooled(meshes, inp, _):
    from gflownet_spai_tpu_torch.parallel.gat import (local_shard, shard_tiled_graph,
                                                      sharded_policy_pooled)
    from gflownet_spai_tpu_torch.parallel.mesh import reduce_grads

    mesh = meshes[(1, 4)]
    _env, tg = _tiled_problem()
    sg, meta = shard_tiled_graph(tg, 4)
    local = local_shard(sg, meta, mesh.index("rows"))
    fwd = inp["params"].forward
    named = [(p, x.detach().requires_grad_(True)) for p, x in _leaves(fwd)]
    from gflownet_spai_tpu_torch.gfn.gflownet import tree_replace

    p = tree_replace(fwd, (x for _, x in named))
    pooled = sharded_policy_pooled(mesh, p, local, meta, 4, 4)
    loss = torch.sum(pooled ** 2)
    grads = torch.autograd.grad(loss / 4, [x for _, x in named], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for (_, x), g in zip(named, grads)]
    grads = reduce_grads(mesh, grads)
    return {"pooled": _np(pooled), "grads": {pth: _np(g) for (pth, _), g in zip(named, grads)}}


def _case_sampler_gat(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, tg = _tiled_problem()
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear", loss="subtb")
    res = _sampler_step(meshes[(2, 2)], env, tg, cfg, SGD(1.0), inp["params"], 4,
                        env.num_actions, inp["noise"])
    tr = _train_steps(meshes[(2, 2)], env, tg, cfg, inp["params"], 6)
    tr.pop("params")
    return {"step": res, "train": tr}


def _case_sampler_feats(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(BCS, seed_method="spai", baseline="identity",
                            seed_k=1)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear", loss="subtb", edge_feats=True,
                         alpha_fixed=0.9)
    out = _train_steps(meshes[(2, 2)], env, graph, cfg, inp["params"], 5)
    out["feat_w"] = _np(out.pop("params").forward.feat_w)
    return out


def _dp_step(mesh, env, graph, cfg, opt, params, batch, noise, replay=None):
    from gflownet_spai_tpu_torch.parallel import make_dp_train_step

    step, _ = make_dp_train_step(mesh, env, graph, cfg, opt, batch_size=batch,
                                 replay_samples=0 if replay is None else replay[0].shape[0])
    st = opt.init([x for _, x in _leaves(params)])
    rep = () if replay is None else tuple(torch.as_tensor(r) for r in replay)
    out = step(params, st, 0, *rep,
               gumbels=torch.as_tensor(noise[mesh.index("dp")]))
    return {"loss": float(out[2]), "rewards": _np(out[3]), "actions": _np(out[4]),
            "deltas": _deltas(out[0], params)}


def _case_dp_tb(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(LF10)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions)
    return _dp_step(meshes[(2, 2)], env, graph, cfg, SGD(1.0), inp["params"], 4,
                    inp["noise"])


def _case_dp_fast(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    out = {}
    for backend, shape, matrix in (("rowblock", (2, 2), "poisson32"),
                                   ("dia", (4, 1), "olm500_like")):
        env, graph = _t_problem(matrix, reward_path="rowblock", dia=backend == "dia")
        cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                             backward="linear")
        out[backend] = _dp_step(meshes[shape], env, graph, cfg, SGD(0.0),
                                inp[backend]["params"], 2 * shape[0],
                                inp[backend]["noise"])
    return out


def _case_dp_replay(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    env, graph = _t_problem(LF10)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear")
    return _dp_step(meshes[(2, 2)], env, graph, cfg, SGD(0.0), inp["params"], 4,
                    inp["noise"], replay=inp["replay"])


def _case_dp_improves(meshes, inp, _):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig
    from gflownet_spai_tpu_torch.parallel import make_dp_train_step
    from gflownet_spai_tpu_torch.train.loop import Optimizer

    env, graph = _t_problem(LF10)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions,
                         backward="linear")
    opt = Optimizer(lr=5e-3)
    step, _ = make_dp_train_step(meshes[(2, 2)], env, graph, cfg, opt, batch_size=8)
    p = inp["params"]
    st = opt.init([x for _, x in _leaves(p)])
    hist = []
    for s in range(40):
        p, st, loss, rewards, _a = step(p, st, s)
        hist.append(float(loss))
    return {"hist": np.array(hist), "rewards": _np(rewards)}


def _case_train_loop(meshes, inp, workdir):
    """``train`` through both adapters on the (2, 2) mesh, then a resume of
    the sharded run from its checkpoint."""
    from gflownet_spai_tpu_torch.train import TrainConfig, train

    out = {}
    common = dict(matrix=LF10, platform="cpu", batch_size=4, dp_devices=2,
                  rows_devices=2, loss="subtb", backward="linear", replay_size=8,
                  replay_samples=2, log_every=100)
    run = os.path.join(workdir, "sharded_run")
    state, hist = train(TrainConfig(sampler="sharded", num_epochs=6, lr=5e-3,
                                    replay_prioritized=1.0, temperature=1.3,
                                    out_dir=run, **common), progress=False)
    out["sharded"] = {"hist": np.array(hist), "replay": _np(state.replay.rewards),
                      "fc_w": _np(state.params.forward.fc_w)}
    state, hist = train(TrainConfig(sampler="sharded", num_epochs=8, lr=5e-3,
                                    replay_prioritized=1.0, temperature=1.3,
                                    out_dir=run, resume=True, **common), progress=False)
    out["resumed"] = {"hist": np.array(hist), "epoch": int(state.epoch)}
    state, hist = train(TrainConfig(num_epochs=6, out_dir=os.path.join(workdir, "dp_run"),
                                    **common), progress=False)
    out["dp"] = {"hist": np.array(hist), "replay": _np(state.replay.rewards)}
    return out


def _case_dryrun(meshes, inp, _):
    sys.path.insert(0, REPO)
    import __graft_entry_torch__ as graft

    graft.dryrun_multichip(4, device="cpu")
    return True


CASES = {
    "residual_pair": _case_residual_pair,
    "residual_rowblock": _case_residual_rowblock,
    "tp_logits": _case_tp_logits,
    "rollout_exact": _case_rollout_exact,
    "rollout_temperature": _case_rollout_temperature,
    "rollout_short_tcap": _case_rollout_short_tcap,
    "rollout_edge_feats": _case_rollout_edge_feats,
    "sampler_tb": _case_sampler_tb,
    "sampler_subtb": _case_sampler_subtb,
    "sampler_replay": _case_sampler_replay,
    "sampler_partial": _case_sampler_partial,
    "sampler_window": _case_sampler_window,
    "gat_pooled": _case_gat_pooled,
    "sampler_gat": _case_sampler_gat,
    "sampler_feats": _case_sampler_feats,
    "dp_tb": _case_dp_tb,
    "dp_fast": _case_dp_fast,
    "dp_replay": _case_dp_replay,
    "dp_improves": _case_dp_improves,
    "train_loop": _case_train_loop,
    "dryrun": _case_dryrun,
}


# ---------------------------------------------------------------------------
# The pytest side: JAX inputs and oracles, the world's results
# ---------------------------------------------------------------------------

def _j():
    import jax
    import jax.numpy as jnp

    return jax, jnp


@functools.lru_cache(maxsize=None)
def _j_problem(matrix, seed_method="ilu0", reward_path="pair", baseline="auto",
               dia=False, seed_k=None):
    jax, jnp = _j()
    from gflownet_spai_tpu.env import make_env, seed_pattern, spai_dia
    from gflownet_spai_tpu.models import graph_from_seed
    from gflownet_spai_tpu.sparse import gallery
    from gflownet_spai_tpu.sparse.types import COO

    a = gallery.get(matrix)
    a = COO(row=a.row, col=a.col, data=a.data.astype(jnp.float32), shape=a.shape)
    seed = seed_pattern(a, method=seed_method, dtype=jnp.float32,
                        **({} if seed_k is None else {"k": seed_k}))
    if dia:
        env = spai_dia.make_dia_env(seed, a)
        return env, graph_from_seed(spai_dia.edge_coo(env))
    env = make_env(seed, original=a, reward_path=reward_path, baseline=baseline)
    return env, graph_from_seed(seed)


@functools.lru_cache(maxsize=None)
def _j_tiled():
    """orsirr_like32's env and its uniform tile layout (no buckets: the
    layout the sharded path takes)."""
    from gflownet_spai_tpu.models.policies import tiled_graph_from_seed

    env_t, _ = _j_problem(ORS, baseline="identity")
    return env_t, tiled_graph_from_seed(env_t.seed, tile_nodes=32, bucket_step=None)


def _j_cfg(A, **kw):
    from gflownet_spai_tpu.gfn import GFlowNetConfig

    return GFlowNetConfig(hidden_dim=4, heads=4, num_actions=A, **kw)


def _t_params(A, key=0, **cfg_kw):
    """The port's parameters, drawn from a seeded CPU generator."""
    from gflownet_spai_tpu_torch.gfn import init_params

    return init_params(torch.Generator().manual_seed(key), _t_cfg(A, **cfg_kw),
                       device="cpu")


def _to_jax(tree):
    """A port params tree (torch leaves) as the JAX package's NamedTuples."""
    _, jnp = _j()
    from gflownet_spai_tpu.gfn import gflownet as j_gfn
    from gflownet_spai_tpu.models import gat as j_gat
    from gflownet_spai_tpu.models import policies as j_pol

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    cls = type(tree).__name__
    jcls = getattr(j_pol, cls, None) or getattr(j_gat, cls, None) or getattr(j_gfn, cls)
    return jcls(**{f: _to_jax(getattr(tree, f)) for f in tree._fields})


def _rollout_noise(key, B, a_loc, R):
    """JAX's ``sharded_rollout`` noise of each rows shard j."""
    jax, jnp = _j()
    k = jax.random.PRNGKey(key)
    return [np.asarray(jax.random.gumbel(jax.random.fold_in(k, j), (B, a_loc), jnp.float32))
            for j in range(R)]


def _sampler_noise(key, dp, R, b_local, a_loc):
    """JAX's sharded train step noise of shard (d, j)."""
    jax, jnp = _j()
    k = jax.random.PRNGKey(key)
    return [[np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(k, d), j), (b_local, a_loc), jnp.float32))
        for j in range(R)] for d in range(dp)]


def _dp_noise(key, dp, b_local, A):
    """JAX's dp step noise of dp group d."""
    jax, jnp = _j()
    k = jax.random.PRNGKey(key)
    return [np.asarray(jax.random.gumbel(jax.random.fold_in(k, d), (b_local, A), jnp.float32))
            for d in range(dp)]


def _replay_lf10(A):
    rng = np.random.default_rng(3)
    r = np.full((3, A), -1, np.int64)
    for s in range(2):
        length = rng.integers(3, 9)
        r[s, :length - 1] = rng.choice(A - 1, size=length - 1, replace=False)
        r[s, length - 1] = A - 1
    return r, np.array([True, True, False])


def _replay_dp(env):
    rng = np.random.default_rng(8)
    T = env.num_actions
    r = np.full((3, T), -1, np.int64)
    for i in range(3):
        k = rng.integers(1, 20)
        r[i, :k] = rng.choice(env.num_edges, size=k, replace=False)
        r[i, k] = env.num_edges
    return r, np.array([True, True, False])


def _np_noise(seed, *shape):
    return np.random.default_rng(seed).gumbel(size=shape).astype(np.float32)


def _inputs():
    """Every case's inputs, made in the pytest process: the port's seeded
    parameters (carried to JAX for the JAX-side oracles), JAX's noise
    where a JAX function draws it, numpy noise where the oracle is the
    port's single-device path."""
    inp = {}
    rng = np.random.default_rng(3)
    inp["residual_pair"] = {"keep": rng.random((4, 84)) > 0.3}
    inp["residual_rowblock"] = {"keep": np.random.default_rng(4).random((4, 6914)) > 0.3}
    inp["tp_logits"] = {"params": _t_params(85)}
    A_b = 1685
    a_loc = -(-A_b // 4)
    pb = _t_params(A_b)
    inp["rollout_exact"] = {"params": pb, "noise": _rollout_noise(9, 3, a_loc, 4)}
    inp["rollout_temperature"] = {"params": pb,
                                  "noise": [_np_noise(11 + j, 3, a_loc) for j in range(4)]}
    inp["rollout_short_tcap"] = {"params": pb,
                                 "noise": [_np_noise(7 + j, 4, a_loc) for j in range(4)]}
    env_f, _ = _t_problem(BCS, seed_method="spai", seed_k=1)
    A_f = env_f.num_actions
    inp["rollout_edge_feats"] = {"params": _t_params(A_f, edge_feats=True),
                                 "noise": [_np_noise(30 + j, 2, -(-A_f // 4)) for j in range(4)]}
    pl = _t_params(85, backward="linear")
    inp["sampler_tb"] = {"params": pl,
                         "noise": {(1, 4): _sampler_noise(5, 1, 4, 4, 22),
                                   (2, 2): _sampler_noise(5, 2, 2, 2, 43)}}
    grid = lambda seed, b, a: [[_np_noise(seed + 2 * d + j, b, a) for j in range(2)]
                               for d in range(2)]
    # JAX's key 41 draws no trajectory that stops at once: such a one has
    # reward 0 in exact arithmetic, the two sharded residuals round it to
    # 2.1e-5 (JAX, key 40's first sample) and 0 (the port), and
    # log_reward's 1e-9 floor makes that ~10 nats of SubTB loss
    inp["sampler_subtb"] = {"params": _t_params(85, backward="linear", loss="subtb"),
                            "noise": _sampler_noise(41, 2, 2, 2, 43)}
    inp["sampler_replay"] = {"params": pl, "noise": _sampler_noise(50, 2, 2, 2, 43),
                             "replay": _replay_lf10(85)}
    inp["sampler_partial"] = {"params": _t_params(A_b, backward="linear", loss="subtb"),
                              "noise": grid(60, 2, -(-A_b // 2))}
    env_w, _ = _t_problem(ORS, seed_method="pattern", reward_path="rowblock",
                          baseline="identity", rowblock_order="window")
    inp["sampler_window"] = {"params": _t_params(env_w.num_actions, backward="linear")}
    env_t, _ = _t_problem(ORS, baseline="identity")
    A_t = env_t.num_actions
    inp["gat_pooled"] = {"params": _t_params(A_t, key=2)}
    inp["sampler_gat"] = {"params": _t_params(A_t, backward="linear", loss="subtb"),
                          "noise": _sampler_noise(70, 2, 2, 2, -(-A_t // 2))}
    inp["sampler_feats"] = {"params": _t_params(A_f, backward="linear", loss="subtb",
                                                edge_feats=True, alpha_fixed=0.9)}
    inp["dp_tb"] = {"params": _t_params(85), "noise": _dp_noise(1, 2, 2, 85)}
    fast = {}
    for backend, matrix, dp in (("rowblock", "poisson32", 2), ("dia", "olm500_like", 4)):
        env_b, _ = _t_problem(matrix, reward_path="rowblock", dia=backend == "dia")
        fast[backend] = {"params": _t_params(env_b.num_actions, backward="linear"),
                         "noise": [_np_noise(20 + d, 2, env_b.num_actions)
                                   for d in range(dp)]}
    inp["dp_fast"] = fast
    env_l, _ = _t_problem(LF10)
    inp["dp_replay"] = {"params": pl, "noise": [_np_noise(80 + d, 2, 85) for d in range(2)],
                        "replay": _replay_dp(env_l)}
    inp["dp_improves"] = {"params": pl}
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the four ranks once, with the JAX oracles computed meanwhile."""
    workdir = str(tmp_path_factory.mktemp("parallel_train"))
    inp = _inputs()
    torch.save(inp, os.path.join(workdir, "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, HERE, *args], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for args in [(str(r), str(WORLD), workdir) for r in range(WORLD)]]
    t0 = time.perf_counter()
    try:
        oracles = _jax_oracles(inp)
        oracles.update(_jax_sharded_steps(inp))
    finally:
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, JOIN_S - (time.perf_counter() - t0)))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return {"inputs": inp, "out": outs, "jax": oracles, "dir": workdir}


def _jax_oracles(inp):
    """The JAX package's results the tests hold the ranks against."""
    jax, jnp = _j()
    import optax
    from gflownet_spai_tpu.env.spai import residual_norm
    from gflownet_spai_tpu.models.policies import forward_policy_logits, forward_policy_pooled
    from gflownet_spai_tpu.parallel import (make_dp_train_step, make_mesh, shard_head,
                                            sharded_rollout, sharded_rowblock_residual_norms)
    from gflownet_spai_tpu.env import make_env, seed_pattern
    from gflownet_spai_tpu.sparse import gallery

    jo = {}
    a = gallery.get(LF10)
    env64 = make_env(seed_pattern(a, method="ilu0", dtype=jnp.float64), original=a)
    keep = jnp.asarray(inp["residual_pair"]["keep"])
    jo["residual_pair"] = np.asarray(jax.jit(jax.vmap(lambda k: residual_norm(env64, k)))(keep))
    env_rb, _ = _j_problem("poisson32", reward_path="rowblock")
    keep = jnp.asarray(inp["residual_rowblock"]["keep"])
    m_vals = env_rb.seed.data[None, :] * keep.astype(env_rb.seed.data.dtype)
    m22 = make_mesh(2, 2)
    jo["residual_rowblock"] = np.asarray(jax.jit(
        lambda m: sharded_rowblock_residual_norms(m22, env_rb, m))(m_vals))

    env, graph = _j_problem(LF10)
    p = _to_jax(inp["tp_logits"]["params"])
    logits = jax.jit(forward_policy_logits, static_argnums=(2, 3))
    jo["tp_logits"] = np.asarray(logits(p.forward, graph, 85, 4))

    env_b, graph_b = _j_problem(BCS)
    A_b = env_b.num_actions
    pb = _to_jax(inp["rollout_exact"]["params"])
    m14 = make_mesh(1, 4)
    fwd_sh = shard_head(m14, pb.forward)
    jo["rollout_exact"] = {}
    for t in (A_b, 64):
        out = jax.jit(lambda f, g, t=t: sharded_rollout(
            m14, f, g, A_b, 4, jax.random.PRNGKey(9), batch_size=3, t_cap=t))(fwd_sh, graph_b)
        jo["rollout_exact"][t] = {"actions": np.asarray(out.rollout.actions),
                                  "lp": np.asarray(out.rollout.fwd_logprobs),
                                  "lengths": np.asarray(out.rollout.lengths),
                                  "valid": np.asarray(out.valid)}
    env_f, graph_f = _j_problem(BCS, seed_method="spai", seed_k=1)
    pf = _to_jax(inp["rollout_edge_feats"]["params"])
    jo["rollout_edge_feats"] = np.asarray(logits(
        pf.forward._replace(feat_w=jnp.asarray([-1.7], jnp.float32)), graph_f,
        env_f.num_actions, 4))

    # the dp step at (2, 2), SGD(1)
    cfg_d, pd = _j_cfg(85), _to_jax(inp["dp_tb"]["params"])
    step, _ = make_dp_train_step(make_mesh(2, 2), env, graph, cfg_d, optax.sgd(1.0),
                                 batch_size=4)
    new, _, loss, rewards = step(pd, optax.sgd(1.0).init(pd), jax.random.PRNGKey(1))
    jo["dp_tb"] = {"loss": float(loss), "rewards": np.asarray(rewards),
                   "deltas": [np.asarray(x) - np.asarray(y) for x, y in
                              zip(jax.tree_util.tree_leaves(new),
                                  jax.tree_util.tree_leaves(pd))]}

    # the replicated pooled forward on the uniform tile layout and its gradient
    env_t, tg = _j_tiled()
    fwd = _to_jax(inp["gat_pooled"]["params"].forward)
    def sq(q, g):
        pooled = forward_policy_pooled(q, g, 4, 4)
        return jnp.sum(pooled ** 2), pooled

    (_, pooled), grads = jax.jit(jax.value_and_grad(sq, has_aux=True))(fwd, tg)
    jo["gat_pooled"] = {"pooled": np.asarray(pooled),
                        "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}
    return jo


def _jax_sharded_steps(inp):
    """JAX's sharded-sampler train steps (SGD lr 1) the sampler tests hold
    the ranks against: on LF10_like TB at (1, 4) and (2, 2), SubTB(λ 0.9)
    and replay at weight valid/dp at (2, 2); on the tiled graph SubTB over
    the tile-sharded GAT at (2, 2)."""
    jax, jnp = _j()
    import optax
    from gflownet_spai_tpu.parallel import make_mesh
    from gflownet_spai_tpu.parallel.sampler import make_sharded_sampler_train_step

    jo = {}

    def sharded_step(name, env_, graph_, cfg_, key, shape=(2, 2), replay=None):
        params = _to_jax(inp[name]["params"])
        step, shard_fwd, _ = make_sharded_sampler_train_step(
            make_mesh(*shape), env_, graph_, cfg_, optax.sgd(1.0), batch_size=4,
            t_cap=cfg_.num_actions, replay_samples=0 if replay is None else len(replay[1]))
        p_sh = shard_fwd(params)
        rep = () if replay is None else (jnp.asarray(replay[0], jnp.int32),
                                         jnp.asarray(replay[1]))
        out = step(p_sh, optax.sgd(1.0).init(p_sh), jax.random.PRNGKey(key), *rep)
        return {"loss": float(out[2]), "rewards": np.asarray(out[3]),
                "deltas": [np.asarray(x) - np.asarray(y) for x, y in
                           zip(jax.tree_util.tree_leaves(out[0]),
                               jax.tree_util.tree_leaves(p_sh))]}

    env, graph = _j_problem(LF10)
    cfg_l = _j_cfg(85, backward="linear")
    jo["sampler_tb"] = {shape: sharded_step("sampler_tb", env, graph, cfg_l, 5, shape)
                        for shape in ((1, 4), (2, 2))}
    jo["sampler_subtb"] = sharded_step(
        "sampler_subtb", env, graph,
        _j_cfg(85, backward="linear", loss="subtb", subtb_lambda=0.9), 41)
    jo["sampler_replay"] = sharded_step("sampler_replay", env, graph, cfg_l, 50,
                                        replay=inp["sampler_replay"]["replay"])
    env_t, tg = _j_tiled()
    jo["sampler_gat"] = sharded_step(
        "sampler_gat", env_t, tg, _j_cfg(env_t.num_actions, backward="linear", loss="subtb"), 70)
    return jo


# ---------------------------------------------------------------------------
# Oracles in the port (single device, the same noise)
# ---------------------------------------------------------------------------

def _port_oracle(params, env, graph, cfg, noise_by_dp, loss_kind="tb", replay=None,
                 grads=False):
    """The replicated oracle: per dp group the single-device rollout on the
    group's assembled noise, the objective, the dp mean."""
    from gflownet_spai_tpu_torch.gfn.gflownet import _batched_rewards as batched_rewards
    from gflownet_spai_tpu_torch.gfn.gflownet import backward_logprobs, tree_replace
    from gflownet_spai_tpu_torch.gfn.loss import log_reward, subtb_loss, trajectory_balance_loss
    from gflownet_spai_tpu_torch.gfn.rollout import gumbel_topk_rollout, trajectory_logprobs
    from gflownet_spai_tpu_torch.models.policies import (flow_head_logF, forward_policy_alpha,
                                                         forward_policy_logits)

    leaves = [x.detach().clone().requires_grad_(grads) for _, x in _leaves(params)]
    p = tree_replace(params, iter(leaves))
    A = cfg.num_actions
    logits = forward_policy_logits(p.forward, graph, A, 4, 4)
    alpha = forward_policy_alpha(p.forward)
    dp = len(noise_by_dp)
    losses, rewards = [], []
    for g in noise_by_dp:
        g = torch.as_tensor(g)
        roll = gumbel_topk_rollout(logits.expand(g.shape[0], A), None, A - 1, gumbels=g)
        rew = batched_rewards(env, roll.actions, alpha)
        rewards.append(rew)
        acts, fwd, lr, lens = roll.actions, roll.fwd_logprobs, log_reward(rew), roll.lengths
        w = None
        if replay is not None:
            ra = torch.as_tensor(replay[0])
            acts = torch.cat([acts, ra])
            fwd = torch.cat([fwd, trajectory_logprobs(logits, ra)])
            lr = torch.cat([lr, log_reward(batched_rewards(env, ra, alpha))])
            lens = torch.cat([lens, (ra >= 0).sum(-1)])
            w = torch.cat([torch.ones(g.shape[0]), torch.as_tensor(replay[1]).float() / dp])
        back = backward_logprobs(p, cfg, acts)
        if loss_kind == "subtb":
            losses.append(subtb_loss(flow_head_logF(p.flow, acts), lr, fwd, back, lens,
                                     lam=cfg.subtb_lambda, weights=w))
        else:
            losses.append(trajectory_balance_loss(p.log_z, lr, fwd.sum(-1), back.sum(-1),
                                                  weights=w))
    loss = torch.stack(losses).mean()
    out = {"loss": float(loss.detach()), "rewards": _np(torch.cat(rewards))}
    if grads:
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        out["deltas"] = {pth: -(np.zeros(x.shape, np.float32) if g is None else _np(g))
                         for (pth, x), g in zip(_leaves(params), gs)}
    return out


def _t_cfg(A, **kw):
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig

    return GFlowNetConfig(hidden_dim=4, heads=4, num_actions=A, **kw)


def _head_whole(outs, name, key, shape, path):
    """The sharded head's delta, its dp-0 rows ranks' slices side by side."""
    R = shape[1]
    return np.concatenate([outs[r][name][key]["deltas"][path] if key is not None
                           else outs[r][name]["deltas"][path] for r in range(R)], axis=-1)


def _assert_deltas(got: dict, want: dict, what, rel=1e-4):
    """|Δ − Δref| ≤ 1e-6 + rel · max|Δref| over each parameter group."""
    group = lambda p: p.rsplit("/", 1)[0]
    scale = {}
    for p, w in want.items():
        scale[group(p)] = max(scale.get(group(p), 0.0), float(np.abs(w).max()))
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for p, w in want.items():
        g = got[p]
        assert g.shape == w.shape, (what, p, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 + rel * scale[group(p)],
                                   err_msg=f"{what} {p}")


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def test_world_ranks_agree(world):
    """Every rank returns the same replicated values (lockstep): losses,
    rewards and the replicated parameters' deltas."""
    o = world["out"]
    for r in range(1, WORLD):
        for name in ("sampler_subtb", "dp_tb", "dp_replay"):
            assert o[r][name]["loss"] == o[0][name]["loss"], (name, r)
        np.testing.assert_array_equal(o[r]["dp_tb"]["deltas"]["/log_z"],
                                      o[0]["dp_tb"]["deltas"]["/log_z"])
        np.testing.assert_array_equal(o[r]["sampler_tb"][(2, 2)]["deltas"]["/forward/gat1/w_src"],
                                      o[0]["sampler_tb"][(2, 2)]["deltas"]["/forward/gat1/w_src"])


def test_sharded_residual_matches_jax(world):
    np.testing.assert_allclose(world["out"][0]["residual_pair"], world["jax"]["residual_pair"],
                               rtol=1e-9)
    for r in range(WORLD):
        np.testing.assert_allclose(world["out"][r]["residual_rowblock"],
                                   world["jax"]["residual_rowblock"], rtol=1e-5)


def test_tp_sharded_logits_match_jax(world):
    got = world["out"][0]["tp_logits"]
    assert 85 % 4 != 0 and got["a_loc"] == 22            # the padded head
    np.testing.assert_allclose(got["logits"], world["jax"]["tp_logits"], rtol=1e-5,
                               atol=1e-6)


def _assert_rollout(got, want, B):
    for b in range(B):
        if not want["valid"][b]:
            assert not got["valid"][b]
            continue
        assert got["valid"][b]
        L = int(want["lengths"][b])
        assert int(got["lengths"][b]) == L
        np.testing.assert_array_equal(got["actions"][b, :L], want["actions"][b, :L])
        np.testing.assert_allclose(got["lp"][b, :L], want["lp"][b, :L], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t_cap", ["A", 64])
def test_sharded_rollout_matches_jax(world, t_cap):
    """The port's sharded rollout on JAX's per-shard noise equals JAX's
    ``sharded_rollout`` (actions up to the terminal, log-probs, lengths,
    validity) at t_cap = A (every sample valid) and 64."""
    key = 1685 if t_cap == "A" else t_cap
    got, want = world["out"][0]["rollout_exact"][key], world["jax"]["rollout_exact"][key]
    if t_cap == "A":
        assert got["valid"].all()
    _assert_rollout(got, want, 3)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(world["out"][r]["rollout_exact"][key]["actions"],
                                      got["actions"])


def test_replicated_oracle_gumbels_replays_the_sharded_noise(world):
    """The port's own per-rank noise (generators seeded from the seed and
    the rank) assembled by ``replicated_oracle_gumbels``: the dense sampler
    on it reproduces the sharded rollout."""
    from gflownet_spai_tpu_torch.gfn.rollout import gumbel_topk_rollout
    from gflownet_spai_tpu_torch.models.policies import forward_policy_logits
    from gflownet_spai_tpu_torch.parallel import replicated_oracle_gumbels

    _env, graph = _t_problem(BCS)
    fwd = world["inputs"]["rollout_exact"]["params"].forward
    g = replicated_oracle_gumbels(9, 1685, 1688, 4, 3)
    logits = forward_policy_logits(fwd, graph, 1685, 4)
    want = gumbel_topk_rollout(logits.expand(3, 1685), None, 1684, gumbels=g)
    got = world["out"][0]["rollout_exact"]["own"]
    np.testing.assert_array_equal(got["actions"], _np(want.actions))
    np.testing.assert_allclose(got["lp"], _np(want.fwd_logprobs), rtol=1e-5, atol=1e-6)


def _oracle_rollout(inp, graph, A, tau=1.0):
    from gflownet_spai_tpu_torch.gfn.rollout import gumbel_topk_rollout
    from gflownet_spai_tpu_torch.models.policies import forward_policy_logits

    g = torch.as_tensor(np.concatenate(inp["noise"], axis=1)[:, :A])
    logits = forward_policy_logits(inp["params"].forward, graph, A, 4)
    return logits, gumbel_topk_rollout((logits / tau).expand(g.shape[0], A), None, A - 1,
                                       gumbels=g)


def test_sharded_rollout_temperature(world):
    """τ tempers the sort only: the trajectories of the dense tempered
    sampler on the same noise, the untempered policy's log-probs."""
    from gflownet_spai_tpu_torch.gfn.rollout import trajectory_logprobs

    _env, graph = _t_problem(BCS)
    got = world["out"][0]["rollout_temperature"]
    logits, want = _oracle_rollout(world["inputs"]["rollout_temperature"], graph, 1685, 2.5)
    assert got["valid"].all()
    np.testing.assert_array_equal(got["actions"], _np(want.actions))
    np.testing.assert_allclose(got["lp"], _np(trajectory_logprobs(logits, want.actions)),
                               rtol=1e-5, atol=1e-6)


def test_sharded_rollout_short_tcap_with_trained_policy(world):
    """A terminal-biased head keeps every sample valid at t_cap 32 and
    matches the dense sampler; the untrained policy weight-0s every one."""
    from gflownet_spai_tpu_torch.gfn.rollout import gumbel_topk_rollout
    from gflownet_spai_tpu_torch.models.policies import forward_policy_logits

    _env, graph = _t_problem(BCS)
    got = world["out"][0]["rollout_short_tcap"]
    assert got["trained"]["valid"].all() and got["trained"]["lengths"].max() <= 32
    assert not got["untrained"]["valid"].any()
    inp = world["inputs"]["rollout_short_tcap"]
    fwd = inp["params"].forward
    fc_b = fwd.fc_b.clone()
    fc_b[1684] += 12.0
    logits = forward_policy_logits(fwd._replace(fc_b=fc_b), graph, 1685, 4)
    g = torch.as_tensor(np.concatenate(inp["noise"], axis=1)[:, :1685])
    want = gumbel_topk_rollout(logits.expand(4, 1685), None, 1684, gumbels=g)
    for b in range(4):
        L = int(want.lengths[b])
        np.testing.assert_array_equal(got["trained"]["actions"][b, :L], _np(want.actions[b, :L]))


def test_sharded_rollout_edge_feats_matches_jax_logits(world):
    """The value-aware channel added from each rank's feature rows: the
    assembled per-rank logits equal JAX's ``forward_policy_logits`` with a
    nonzero feat_w, and differ from feat_w = 0."""
    o = world["out"]
    A = world["jax"]["rollout_edge_feats"].shape[0]
    got = np.concatenate([o[r]["rollout_edge_feats"]["feats"]["logits_local"]
                          for r in range(WORLD)])[:A]
    # float32 logits of two GAT implementations: atol 1e-6 of the largest
    want = world["jax"]["rollout_edge_feats"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    zero = np.concatenate([o[r]["rollout_edge_feats"]["zero"]["logits_local"]
                           for r in range(WORLD)])[:A]
    assert np.abs(zero[:A - 1] - got[:A - 1]).max() > 1e-3


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_sampler_step_gradients_match_jax(world, shape):
    """The sharded train step (TB, SGD lr 1) at (1, 4) and (2, 2): the loss
    and every parameter's delta equal JAX's step, and autograd of the
    replicated oracle loss (each dp group's assembled noise through the
    single-device sampler)."""
    o = world["out"][0]["sampler_tb"][shape]
    j = world["jax"]["sampler_tb"][shape]
    np.testing.assert_allclose(o["loss"], j["loss"], rtol=2e-4)
    np.testing.assert_allclose(o["rewards"], j["rewards"], rtol=2e-4)
    assert o["valid"].all()
    paths = list(o["deltas"])
    got = dict(o["deltas"])
    for path in ("/forward/fc_w", "/forward/fc_b"):
        got[path] = _head_whole(world["out"], "sampler_tb", shape, shape, path)
    _assert_deltas(got, dict(zip(paths, j["deltas"])), f"jax {shape}")
    inp = world["inputs"]["sampler_tb"]
    env, graph = _t_problem(LF10)
    noise = [np.concatenate(n, axis=1)[:, :85] for n in inp["noise"][shape]]
    ref = _port_oracle(inp["params"], env, graph, _t_cfg(85, backward="linear"), noise,
                       grads=True)
    np.testing.assert_allclose(o["loss"], ref["loss"], rtol=2e-4)
    for path in ("/forward/fc_w", "/forward/fc_b"):
        assert np.all(got[path][..., 85:] == 0)
        got[path] = got[path][..., :85]
    _assert_deltas(got, ref["deltas"], f"oracle {shape}")


def _assert_step_matches_jax(world, name, A, what, key=None, rel=1e-4):
    """The (2, 2) step ``name`` (its ``key`` entry where given): loss,
    rewards and every SGD(lr 1) delta (the head's two rows slices side by
    side, padding columns included) equal JAX's step on the same per-shard
    noise.  Returns the deltas with the head cut to its ``A`` live
    columns."""
    o, j = world["out"][0][name], world["jax"][name]
    o = o if key is None else o[key]
    np.testing.assert_allclose(o["loss"], j["loss"], rtol=2e-4)
    np.testing.assert_allclose(o["rewards"], j["rewards"], rtol=2e-4)
    got = dict(o["deltas"])
    for path in ("/forward/fc_w", "/forward/fc_b"):
        got[path] = _head_whole(world["out"], name, key, (2, 2), path)
    _assert_deltas(got, dict(zip(o["deltas"], j["deltas"])), f"jax {what}", rel=rel)
    for path in ("/forward/fc_w", "/forward/fc_b"):
        assert np.all(got[path][..., A:] == 0)
        got[path] = got[path][..., :A]
    return got


def test_sharded_sampler_subtb_matches_oracle(world):
    """SubTB(λ 0.9) at (2, 2) on JAX's per-shard noise: the loss and SGD(lr
    1) deltas equal JAX's step and autograd of the replicated oracle."""
    inp = world["inputs"]["sampler_subtb"]
    env, graph = _t_problem(LF10)
    cfg = _t_cfg(85, backward="linear", loss="subtb", subtb_lambda=0.9)
    noise = [np.concatenate(n, axis=1)[:, :85] for n in inp["noise"]]
    ref = _port_oracle(inp["params"], env, graph, cfg, noise, loss_kind="subtb", grads=True)
    o = world["out"][0]["sampler_subtb"]
    assert o["valid"].all() and (o["lengths"] > 1).all()
    got = _assert_step_matches_jax(world, "sampler_subtb", 85, "subtb")
    np.testing.assert_allclose(o["loss"], ref["loss"], rtol=2e-4)
    _assert_deltas(got, ref["deltas"], "subtb")


def test_sharded_sampler_replay_matches_oracle(world):
    """Replayed trajectories re-scored from the gathered logits at weight
    valid/dp: the loss and SGD(lr 1) deltas equal JAX's step on the same
    noise and buffer, and the dp mean of the per-group oracle."""
    inp = world["inputs"]["sampler_replay"]
    env, graph = _t_problem(LF10)
    noise = [np.concatenate(n, axis=1)[:, :85] for n in inp["noise"]]
    ref = _port_oracle(inp["params"], env, graph, _t_cfg(85, backward="linear"), noise,
                       replay=inp["replay"], grads=True)
    o = world["out"][0]["sampler_replay"]
    assert o["valid"].all() and o["actions"].shape == (4, 85)
    got = _assert_step_matches_jax(world, "sampler_replay", 85, "replay")
    np.testing.assert_allclose(o["loss"], ref["loss"], rtol=2e-4)
    _assert_deltas(got, ref["deltas"], "replay")


def test_sharded_sampler_partial_subtb_signal_at_short_tcap(world):
    o = world["out"][0]["sampler_partial"]
    part, zero = o[True], o[False]
    assert not part["valid"].any() and (part["lengths"] == 16).all()
    assert np.isfinite(part["loss"]) and part["loss"] > 0
    assert any(np.abs(d).max() > 0 for d in part["deltas"].values())
    assert not zero["valid"].any() and zero["loss"] == 0.0


def test_sharded_sampler_composes_with_window_order_env(world):
    o = world["out"][0]["sampler_window"]
    assert np.isfinite(o["hist"]).all() and o["valid"].all()
    assert np.isfinite(o["rewards"]).all()


def test_sharded_gat_pooled_matches_jax(world):
    """The tile-sharded forward at R 4 (K1 per rank, one all_gather, K3 on
    the rank's window plan, K1, psum pool) equals JAX's replicated
    ``forward_policy_pooled``; its gradient (each rank's loss share, rows
    sum) as SGD(lr 1) deltas equals JAX's."""
    j = world["jax"]["gat_pooled"]
    for r in range(WORLD):
        np.testing.assert_allclose(world["out"][r]["gat_pooled"]["pooled"], j["pooled"],
                                   rtol=1e-5, atol=1e-6)
    got = world["out"][0]["gat_pooled"]["grads"]
    want = dict(zip(got, j["grads"]))
    _assert_deltas({p: -g for p, g in got.items()}, {p: -w for p, w in want.items()},
                   "pooled")


def test_sharded_sampler_with_sharded_gat(world):
    """The sampler step (SubTB) over the tile-sharded GAT at (2, 2) equals
    JAX's step over its tile-sharded GAT on the same noise, and the
    replicated oracle (loss and SGD deltas); a few Adam steps stay
    finite."""
    inp = world["inputs"]["sampler_gat"]
    env, tg = _tiled_problem()
    A = env.num_actions
    noise = [np.concatenate(n, axis=1)[:, :A] for n in inp["noise"]]
    ref = _port_oracle(inp["params"], env, tg, _t_cfg(A, backward="linear", loss="subtb"),
                       noise, loss_kind="subtb", grads=True)
    o = world["out"][0]["sampler_gat"]
    got = _assert_step_matches_jax(world, "sampler_gat", A, "sharded gat", key="step")
    np.testing.assert_allclose(o["step"]["loss"], ref["loss"], rtol=2e-4)
    # the repo's bound for the tiled GAT's float32 gradients (5e-4 of the
    # group's largest, tests/test_torch_train.py): the SubTB loss sums the
    # layer's 7k edge terms in another order on each side
    _assert_deltas(got, ref["deltas"], "sharded gat", rel=5e-4)
    assert np.isfinite(o["train"]["hist"]).all() and o["train"]["valid"].all()


def test_sharded_sampler_train_step_edge_feats(world):
    o = world["out"][0]["sampler_feats"]
    assert np.isfinite(o["hist"]).all() and np.isfinite(o["rewards"]).all()
    assert float(o["feat_w"][0]) != 0.0           # the channel got a gradient


def test_dp_step_gradients_match_jax(world):
    """The dp step at (2, 2) (TB, LSTM backward, SGD lr 1) on JAX's noise:
    loss, rewards and every parameter's delta equal JAX's step."""
    o, j = world["out"][0]["dp_tb"], world["jax"]["dp_tb"]
    np.testing.assert_allclose(o["loss"], j["loss"], rtol=2e-4)
    np.testing.assert_allclose(o["rewards"], j["rewards"], rtol=2e-4)
    _assert_deltas(o["deltas"], dict(zip(o["deltas"], j["deltas"])), "dp")


@pytest.mark.parametrize("backend", ["rowblock", "dia"])
def test_dp_fast_reward_matches_single_device(world, backend):
    """The dp step on the rowblock (2, 2) and DIA (4, 1) rewards equals the
    mean over dp groups of the single-device loss on each group's noise."""
    inp = world["inputs"]["dp_fast"][backend]
    env, graph = _t_problem("poisson32" if backend == "rowblock" else "olm500_like",
                            reward_path="rowblock", dia=backend == "dia")
    ref = _port_oracle(inp["params"], env, graph,
                       _t_cfg(env.num_actions, backward="linear"), inp["noise"])
    o = world["out"][0]["dp_fast"][backend]
    np.testing.assert_allclose(o["loss"], ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(o["rewards"], ref["rewards"], rtol=2e-4)


def test_dp_replay_weighting_matches_single_device(world):
    """Replays weighted valid/dp: the dp loss equals the closed form — every
    fresh trajectory at weight 1 and the replay set once at weight valid."""
    from gflownet_spai_tpu_torch.env.spai import batched_rewards
    from gflownet_spai_tpu_torch.gfn.gflownet import backward_logprobs
    from gflownet_spai_tpu_torch.gfn.loss import log_reward, trajectory_balance_loss
    from gflownet_spai_tpu_torch.gfn.rollout import trajectory_logprobs
    from gflownet_spai_tpu_torch.models.policies import (forward_policy_alpha,
                                                         forward_policy_logits)

    inp = world["inputs"]["dp_replay"]
    env, graph = _t_problem(LF10)
    o = world["out"][0]["dp_replay"]
    p = inp["params"]
    cfg = _t_cfg(85, backward="linear")
    acts = torch.cat([torch.as_tensor(o["actions"]), torch.as_tensor(inp["replay"][0])])
    logits = forward_policy_logits(p.forward, graph, 85, 4)
    rew = batched_rewards(env, acts, forward_policy_alpha(p.forward))
    w = torch.cat([torch.ones(4), torch.as_tensor(inp["replay"][1]).float()])
    want = trajectory_balance_loss(p.log_z, log_reward(rew),
                                   trajectory_logprobs(logits, acts).sum(-1),
                                   backward_logprobs(p, cfg, acts).sum(-1), weights=w)
    np.testing.assert_allclose(o["loss"], float(want), rtol=2e-5)


def test_dp_train_step_runs_and_improves(world):
    o = world["out"][0]["dp_improves"]
    assert np.isfinite(o["hist"]).all() and o["rewards"].shape == (8,)
    assert np.mean(o["hist"][-10:]) < np.mean(o["hist"][:10])


def test_train_loop_sharded_and_dp_adapters(world):
    """``train`` on the (2, 2) mesh: the sharded sampler with replay, SubTB
    and temperature, then a resume from its checkpoint (the padded head
    stored whole, cut again); the dp adapter with replay and SubTB.  Finite
    losses, the buffer filled, rank 0 alone writes."""
    o = world["out"]
    s = o[0]["train_loop"]
    assert np.isfinite(s["sharded"]["hist"]).all() and len(s["sharded"]["hist"]) == 6
    assert np.isfinite(s["sharded"]["replay"]).any()
    assert s["sharded"]["fc_w"].shape == (4, 43)        # the rank's column slice
    assert s["resumed"]["epoch"] == 8 and len(s["resumed"]["hist"]) == 2
    assert np.isfinite(s["resumed"]["hist"]).all()
    assert np.isfinite(s["dp"]["hist"]).all()
    assert np.isfinite(s["dp"]["replay"]).sum() >= 4
    for r in range(1, WORLD):
        np.testing.assert_array_equal(o[r]["train_loop"]["dp"]["hist"], s["dp"]["hist"])
    blob = torch.load(os.path.join(world["dir"], "sharded_run", "checkpoint", "epoch_8.pt"),
                      weights_only=True)
    assert tuple(blob["params"]["/forward/fc_w"].shape) == (4, 86)
    log = os.path.join(world["dir"], "dp_run", "training_log.csv")
    assert len(open(log).read().splitlines()) == 7


def test_graft_dryrun_multichip(world):
    assert all(o["dryrun"] is True for o in world["out"])


# --- on one process (the 1×1 mesh, no process group) ----------------------

def test_dp_matches_single_device_gradients():
    """dp = rows = 1 reproduces JAX's unsharded ``loss_fn`` at the dp
    group's folded key."""
    jax, jnp = _j()
    from gflownet_spai_tpu.gfn.gflownet import loss_fn
    from gflownet_spai_tpu_torch.parallel import make_dp_train_step, make_mesh

    env, graph = _j_problem(LF10)
    tp = _t_params(85)
    cfg, p = _j_cfg(85), _to_jax(tp)
    key = jax.random.PRNGKey(42)
    sub = jax.random.fold_in(key, 0)
    want = float(jax.jit(lambda q, k: loss_fn(q, env, graph, cfg, k, 4)[0])(p, sub))
    tenv, tgraph = _t_problem(LF10)
    step, _ = make_dp_train_step(make_mesh(1, 1, "cpu"), tenv, tgraph, _t_cfg(85), SGD(0.0),
                                 batch_size=4)
    g = torch.as_tensor(np.asarray(jax.random.gumbel(sub, (4, 85), jnp.float32)))
    out = step(tp, (), 0, gumbels=g)
    np.testing.assert_allclose(float(out[2]), want, rtol=1e-5)


def test_sharded_params_from_jax_equals_jax_shard_head():
    """``convert.sharded_params_from_jax``: JAX's parameters as one rows
    rank's — the trunk whole, the head padded (``pad_head``) and cut to the
    rank's columns of JAX's ``shard_head``."""
    jax, _ = _j()
    from gflownet_spai_tpu.parallel import make_mesh, shard_head
    from gflownet_spai_tpu_torch.convert import sharded_params_from_jax

    from gflownet_spai_tpu.parallel import pad_head as j_pad_head
    from gflownet_spai_tpu_torch.parallel import pad_head

    tp = _t_params(85, backward="linear")
    jp = _to_jax(tp)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    for n in (1, 2, 4):
        np.testing.assert_array_equal(_np(pad_head(tp.forward, n).fc_w),
                                      np.asarray(j_pad_head(jp.forward, n).fc_w))
    head = shard_head(make_mesh(1, 4), jp.forward)
    for j in range(4):
        p = sharded_params_from_jax(tree, 4, j, device="cpu")
        np.testing.assert_array_equal(_np(p.forward.fc_w),
                                      np.asarray(head.fc_w)[:, 22 * j:22 * (j + 1)])
        np.testing.assert_array_equal(_np(p.forward.fc_b),
                                      np.asarray(head.fc_b)[22 * j:22 * (j + 1)])
        np.testing.assert_array_equal(_np(p.forward.gat1.w_src), np.asarray(jp.forward.gat1.w_src))
        np.testing.assert_array_equal(_np(p.backward.emb_v), np.asarray(jp.backward.emb_v))


def test_cap_ladder_decisions():
    from gflownet_spai_tpu_torch.train.loop import CapLadder

    lad = CapLadder(cap=4096, cap_min=64, margin=4.0, window=3)
    full = np.full(16, 100)
    term = np.ones(16, bool)
    assert lad.observe(full, term) is None
    assert lad.observe(full, term) is None
    assert lad.observe(full, term) == 512
    assert lad.cap == 512
    short = np.full(16, 10)
    assert lad.observe(short, term) is None
    assert lad.observe(short, term) is None
    assert lad.observe(short, term) == 64
    lad2 = CapLadder(cap=1024, cap_min=64, margin=4.0, window=2)
    mixed = np.array([True] * 9 + [False] * 7)
    assert lad2.observe(short, mixed) is None
    assert lad2.observe(short, mixed) is None
    assert lad2.cap == 1024
    lad3 = CapLadder(cap=128, cap_min=64, margin=4.0, window=1)
    assert lad3.observe(np.full(8, 100), np.ones(8, bool)) is None
    assert lad3.cap == 128
    # a shrunken cap whose termination rate collapses grows back ×2
    lad4 = CapLadder(cap=1024, cap_min=64, margin=4.0, window=1)
    assert lad4.observe(np.full(4, 10), np.ones(4, bool)) == 64
    assert lad4.observe(np.full(4, 64), np.zeros(4, bool)) == 128


def test_dp_adapter_replay_width_follows_its_step(tmp_path):
    """The dp step rolls out whole trajectories, so its adapter widens a
    buffer that ``t_cap`` sized (JAX's adapter fails to concatenate the
    two widths there); the 1×1 mesh, no process group."""
    from gflownet_spai_tpu_torch.train import TrainConfig
    from gflownet_spai_tpu_torch.train.loop import _make_dp_step_adapter, setup

    cfg = TrainConfig(matrix=LF10, platform="cpu", t_cap=16, replay_size=4,
                      batch_size=4, out_dir=str(tmp_path))
    _, _, env, graph, mcfg, opt, state = setup(cfg)
    assert state.replay.actions.shape == (4, 16)
    step = _make_dp_step_adapter(cfg, env, graph, mcfg, opt)
    for _ in range(2):
        state, metrics = step(state)
        assert torch.isfinite(metrics["loss"])
    assert state.replay.actions.shape == (4, 85) and torch.isfinite(state.replay.rewards).any()


def test_sharded_sampler_cli_on_one_process(tmp_path):
    """``--sampler sharded`` on one process runs the 1×1 mesh (no process
    group): finite losses, a checkpoint."""
    from gflownet_spai_tpu_torch.train.__main__ import main as train_main

    run = str(tmp_path / "run")
    assert train_main(["--platform", "cpu", "--sampler", "sharded", "--epochs", "3",
                       "--loss", "subtb", "--backward", "linear", "--replay-size", "4",
                       "--t-cap", "32", "--out-dir", run, "--log-every", "1"]) == 0
    assert (tmp_path / "run" / "checkpoint" / "epoch_3.pt").exists()
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    import json

    assert [json.loads(x)["t_cap"] for x in lines] == [32] * 3


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)

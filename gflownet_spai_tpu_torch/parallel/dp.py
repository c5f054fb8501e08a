"""Data-parallel and row-parallel training step over a (dp, rows) mesh
(counterpart of ``gflownet_spai_tpu/parallel/dp.py``).

Replicated policy parameters, the trajectory batch split over ``dp``,
gradients averaged over ``dp``.  The reward residual composes with every
env backend:

* **pair** (COO plan)   — the pair lists split over ``rows``, partial C
  values summed by a ``psum``, then the Frobenius scalar;
* **rowblock**          — each size-class bucket's rows split over
  ``rows``, the partial squared residuals summed by a ``psum`` (the
  replicated overflow sub-plan divided by the ``rows`` size first);
* **dia**               — the band is small and gather-free: replicated,
  ``rows`` unused by the reward.

The ranks of one ``dp`` group draw the same noise (a generator seeded from
the step's seed and the dp index), so their partial residuals belong to
the same trajectories.  The residual carries no parameter gradient, so
every rank's gradient is already the gradient of its group's loss; the
step averages it over ``dp``.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..env import spai, spai_dia
from ..gfn import gflownet as gfn
from ..gfn.gflownet import tree_leaves, tree_replace
from ..gfn.loss import (log_reward, subtb_loss, trajectory_balance_loss,
                        vargrad_loss)
from ..gfn.rollout import gumbel_noise, gumbel_topk_rollout, trajectory_logprobs
from ..models import policies as pol
from ..sparse import rowblock as _rowblock
from .mesh import Mesh, all_gather, pmean, psum, reduce_grads


def _pad_pairs(env: spai.SpaiEnv, n_shards: int) -> spai.SpaiEnv:
    """Pad the SpGEMM pair lists to a multiple of ``n_shards``.  Padding
    pairs go to a dump slot appended to the output pattern, which the
    residual leaves out (``real_out``: the genuine slots)."""
    plan = env.plan
    npairs = plan.npairs
    pad = -(-npairs // n_shards) * n_shards - npairs
    if pad == 0:
        return env
    new = copy.copy(plan)
    z = lambda v, k: torch.full((k,), v, dtype=plan.pair_a.dtype, device=plan.pair_a.device)
    new.pair_a = torch.cat([plan.pair_a, z(0, pad)])
    new.pair_b = torch.cat([plan.pair_b, z(0, pad)])
    new.pair_out = torch.cat([plan.pair_out, z(plan.out_nnz, pad)])
    new.out_row = torch.cat([plan.out_row, z(-1, 1)])
    new.out_col = torch.cat([plan.out_col, z(-2, 1)])
    new.out_nnz = plan.out_nnz + 1
    new.npairs = npairs + pad
    new.real_out = plan.out_nnz
    return dataclasses.replace(env, plan=new)


def _pad_rowblock(plan: _rowblock.RowBlockPlan,
                  n_shards: int) -> _rowblock.RowBlockPlan:
    """Pad each bucket's row count to a multiple of ``n_shards``: zero G
    blocks, windows at the appended zero slot, no diagonal — padding rows
    add exactly 0.  The contiguous-window metadata is dropped (the padded
    row counts invalidate its slices), so windows go through ``win_idx``."""
    gram = plan.compress == "gram"
    gv, wi, dp_, ln, oh = [], [], [], [], []
    lins = plan.lin if gram else (None,) * len(plan.gvals)
    ohs = plan.onehot if plan.onehot else (None,) * len(plan.gvals)
    for g, w, d, li, o in zip(plan.gvals, plan.win_idx, plan.diag_pos, lins, ohs):
        r = g.shape[0]
        cp = g.shape[2] if gram or plan.layout != "cm" else g.shape[1]
        pad = -(-r // n_shards) * n_shards - r
        if pad:
            g = torch.cat([g, g.new_zeros((pad,) + tuple(g.shape[1:]))])
            w = torch.cat([w, w.new_full((pad, w.shape[1]), plan.nnz_m)])
            d = torch.cat([d, d.new_full((pad,), cp)])
            if li is not None:
                li = torch.cat([li, li.new_zeros((pad, li.shape[1]))])
            if o is not None:
                o = torch.cat([o, o.new_zeros((pad, o.shape[1]))])
        gv.append(g); wi.append(w); dp_.append(d); ln.append(li); oh.append(o)
    return dataclasses.replace(
        plan, gvals=tuple(gv), win_idx=tuple(wi), diag_pos=tuple(dp_),
        lin=tuple(ln) if gram else plan.lin,
        onehot=tuple(oh) if plan.onehot else plan.onehot, win_off=(), win_w=())


def _rows_block(mesh: Mesh, t: torch.Tensor, axis: str = "rows") -> torch.Tensor:
    """This rank's block of ``t``'s leading axis (a multiple of the axis
    size)."""
    n = t.shape[0] // mesh.size(axis)
    i = mesh.index(axis)
    return t[i * n:(i + 1) * n]


def _residual_body(mesh: Mesh, orig_data, out_nnz: int, n: int, real_out: int,
                   m_vals, pa, pb, po, orow, ocol):
    """Rows-sharded ‖M·A − I‖_F from the rank's pair block ``pa, pb, po``:
    [B, nnz] (replicated) → [B]."""
    prod = m_vals[:, pa] * orig_data[pb]                      # [B, pairs/R]
    partial_out = prod.new_zeros((m_vals.shape[0], out_nnz)).index_add_(-1, po, prod)
    c = psum(mesh, partial_out, "rows")[:, :real_out]
    diag = (orow == ocol)[:real_out]
    s2 = torch.sum(c * c, dim=-1)
    sd = torch.sum(torch.where(diag[None, :], c, 0.0), dim=-1)
    return torch.sqrt(s2 - 2.0 * sd + n)


def _local_rowblock(mesh: Mesh, rb: _rowblock.RowBlockPlan) -> _rowblock.RowBlockPlan:
    """The rank's bucket rows of a padded plan, with no overflow sub-plan
    and no constant (the caller adds both once)."""
    blk = lambda ts: tuple(_rows_block(mesh, t) for t in ts)
    return dataclasses.replace(
        rb, gvals=blk(rb.gvals), win_idx=blk(rb.win_idx), diag_pos=blk(rb.diag_pos),
        lin=blk(rb.lin) if rb.compress == "gram" else rb.lin,
        onehot=blk(rb.onehot) if rb.onehot else rb.onehot,
        ov_groups=(), n_missing_diag=0, n_bucket_diag=0)


def _rowblock_residual_body(mesh: Mesh, rb: _rowblock.RowBlockPlan,
                            local: _rowblock.RowBlockPlan, m_vals) -> torch.Tensor:
    """Rows-sharded rowblock residual: the rank's bucket rows' partial
    Σ(y − δ)², the replicated overflow part divided by the ``rows`` size,
    summed by a ``psum``; the constant added once, clamped at 0 (the gram
    form can dip below near a zero residual).  [B, nnz_m] → [B]."""
    acc = _rowblock.residual_sq_batch(local, m_vals)
    acc = acc + _rowblock._overflow_residual_sq(rb, m_vals) / mesh.size("rows")
    acc = psum(mesh, acc, "rows") + (rb.n_missing_diag + rb.n_bucket_diag)
    return torch.sqrt(torch.clamp_min(acc, 0.0))


def _make_residual_provider(mesh: Mesh, env):
    """``(env_padded, fn)`` with ``fn(keep [b, E]) -> (res_norms [b],
    kept_nnz [b])`` on this rank, the residual split over ``rows`` by the
    env's backend (module docstring)."""
    if isinstance(env, spai_dia.SpaiDiaEnv):
        def fn_dia(keep):
            return (spai_dia.residual_norms(env, keep),
                    spai_dia.kept_nnz(env, keep))
        return env, fn_dia

    rows = mesh.size("rows")
    seed_data = env.seed.data
    if env.rb is not None:
        rb = _pad_rowblock(env.rb, rows)
        env = dataclasses.replace(env, rb=rb)
        local = _local_rowblock(mesh, rb)

        def fn_rb(keep):
            m_vals = seed_data[None, :] * keep.to(seed_data.dtype)
            res = _rowblock_residual_body(mesh, rb, local, m_vals)
            return res, keep.sum(-1).to(res.dtype)
        return env, fn_rb

    real_out = env.plan.out_nnz
    env = _pad_pairs(env, rows)
    plan = env.plan
    pa, pb, po = (_rows_block(mesh, t) for t in (plan.pair_a, plan.pair_b, plan.pair_out))
    orig = env.original.data

    def fn_pair(keep):
        m_vals = seed_data[None, :] * keep.to(seed_data.dtype)
        res = _residual_body(mesh, orig, plan.out_nnz, env.n, real_out, m_vals,
                             pa, pb, po, plan.out_row, plan.out_col)
        return res, keep.sum(-1).to(res.dtype)
    return env, fn_pair


def sharded_residual_norms(mesh: Mesh, env: spai.SpaiEnv, m_vals: torch.Tensor,
                           real_out: int | None = None) -> torch.Tensor:
    """Rows-sharded pair-plan residual: [B, nnz] masked values (replicated)
    → [B] norms on every rank.  ``env`` must be padded by ``_pad_pairs``
    when rows > 1 (``real_out`` defaults to the slots before its dump
    slot)."""
    plan = env.plan
    real = real_out if real_out is not None else getattr(plan, "real_out", plan.out_nnz)
    pa, pb, po = (_rows_block(mesh, t) for t in (plan.pair_a, plan.pair_b, plan.pair_out))
    return _residual_body(mesh, env.original.data, plan.out_nnz, env.n, real,
                          m_vals, pa, pb, po, plan.out_row, plan.out_col)


def sharded_rowblock_residual_norms(mesh: Mesh, env: spai.SpaiEnv,
                                    m_vals: torch.Tensor) -> torch.Tensor:
    """Rows-sharded rowblock residual: [B, nnz] masked values → [B] norms;
    the buckets are padded to the ``rows`` size here."""
    rb = _pad_rowblock(env.rb, mesh.size("rows"))
    return _rowblock_residual_body(mesh, rb, _local_rowblock(mesh, rb), m_vals)


def fold_seed(seed: int, *indices: int) -> int:
    """A generator seed for one shard: ``seed`` folded with mesh indices
    (the counterpart of ``jax.random.fold_in``)."""
    s = int(seed) % (2**61 - 1)
    for i in indices:
        s = (s * 1_000_003 + int(i) + 1) % (2**61 - 1)
    return s


def reward_terms(env, res_fn, actions: torch.Tensor, alpha, cfg) -> tuple:
    """(rewards, log rewards) of [b, T] action lists through the sharded
    residual ``res_fn``; the residual carries no parameter gradient."""
    with torch.no_grad():
        keep = spai.keep_mask_from_actions(actions, env.num_edges)
        res, kept_nnz = res_fn(keep)
    res_ratio = res / env.baseline_residual
    comp_ratio = 2.0 * kept_nnz * env.seed.shape[1] / env.baseline_flops
    rewards = (alpha * (1 - res_ratio) + (1 - alpha) * (1 - comp_ratio)) * 1000.0
    return rewards, getattr(cfg, "reward_beta", 1.0) * log_reward(rewards)


def gfn_loss(params, cfg, actions, fwd_lp, log_r, lengths, weights, terminated=None):
    """The configured objective (TB, VarGrad or SubTB(λ)) on one batch."""
    back_lp = gfn.backward_logprobs(params, cfg, actions)
    if cfg.loss == "vargrad":
        return vargrad_loss(log_r, fwd_lp.sum(-1), back_lp.sum(-1), weights=weights)
    if cfg.loss == "subtb":
        return subtb_loss(pol.flow_head_logF(params.flow, actions), log_r, fwd_lp,
                          back_lp, lengths, lam=cfg.subtb_lambda, weights=weights,
                          terminated=terminated)
    return trajectory_balance_loss(params.log_z, log_r, fwd_lp.sum(-1),
                                   back_lp.sum(-1), weights=weights)


def effective_alpha(params, cfg, like: torch.Tensor) -> torch.Tensor:
    if cfg.alpha_fixed >= 0:
        return torch.tensor(cfg.alpha_fixed, dtype=like.dtype, device=like.device)
    return pol.forward_policy_alpha(params.forward)


def grad_step(mesh: Mesh, opt, params, opt_state, loss_share, loss_value,
              sharded=(), rows_sum=True):
    """Gradients of the rank's ``loss_share`` → global gradients
    (``mesh.reduce_grads``) → the optimizer update on every rank (fed the
    global ``loss_value``).  Returns (params, opt_state)."""
    named = tree_leaves(params)
    leaves = [x for _, x in named]
    grads = torch.autograd.grad(loss_share, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    idx = tuple(i for i, (p, _) in enumerate(named) if p in sharded)
    grads = reduce_grads(mesh, grads, sharded=idx, rows_sum=rows_sum)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, value=loss_value.detach())
        new = [x.detach() + u for x, u in zip(leaves, updates)]
    return tree_replace(params, iter(new)), opt_state


def with_grad(params):
    """``params`` with fresh leaves that require gradients."""
    return tree_replace(params, (x.detach().requires_grad_(True)
                                 for _, x in tree_leaves(params)))


def make_dp_train_step(mesh: Mesh, env, graph, cfg: gfn.GFlowNetConfig, opt,
                       batch_size: int, replay_samples: int = 0):
    """Train step over the mesh's (dp, rows) axes.  Returns
    ``(step_fn, padded_env)``:

    ``step_fn(params, opt_state, seed, r_actions=None, r_valid=None,
    gumbels=None) -> (params, opt_state, loss, rewards [batch],
    actions [batch, A])`` on every rank.  The rank's dp group rolls out
    ``batch_size / dp`` trajectories with noise from a generator seeded by
    (``seed``, dp index), or from ``gumbels`` ([b_local, A], the group's
    noise) when given; the residual is split over ``rows``; loss and
    gradients are averaged over ``dp``; the optimizer runs replicated.

    With ``replay_samples > 0`` the step takes ``(r_actions [S, T],
    r_valid [S])`` (the same on every rank), re-scored on every dp group
    with loss weight ``valid/dp``: the dp mean then equals the
    single-device weighted loss for TB / SubTB (VarGrad stays
    approximate: the mean of per-group variances is not the global
    variance)."""
    dp = mesh.size("dp")
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} not divisible by dp={dp}")
    b_local = batch_size // dp
    env, res_fn = _make_residual_provider(mesh, env)
    A = cfg.num_actions

    def step_fn(params, opt_state, seed, r_actions=None, r_valid=None, gumbels=None):
        p = with_grad(params)
        logits = pol.forward_policy_logits(p.forward, graph, A, cfg.hidden_dim, cfg.heads)
        alpha = effective_alpha(p, cfg, logits)
        sample_logits = logits / cfg.temperature if cfg.temperature != 1.0 else logits
        if gumbels is None:
            gen = torch.Generator(device=logits.device).manual_seed(
                fold_seed(seed, mesh.index("dp")))
            gumbels = gumbel_noise((b_local, A), gen, logits.dtype, logits.device)
        roll = gumbel_topk_rollout(sample_logits.expand(b_local, A), None,
                                   terminal_action=A - 1, gumbels=gumbels)
        fresh = roll.actions.detach()
        fwd_lp = roll.fwd_logprobs
        if cfg.temperature != 1.0:
            fwd_lp = trajectory_logprobs(logits, fresh)
        actions, lengths, weights = fresh, roll.lengths, None
        if replay_samples:
            r_actions = r_actions.to(fresh.dtype)
            actions = torch.cat([fresh, r_actions], 0)
            fwd_lp = torch.cat([fwd_lp, trajectory_logprobs(logits, r_actions)], 0)
            lengths = torch.cat([lengths, (r_actions >= 0).sum(-1).to(lengths.dtype)], 0)
            weights = torch.cat([fwd_lp.new_ones((b_local,)),
                                 r_valid.to(fwd_lp.dtype) / dp], 0)
        rewards, log_r = reward_terms(env, res_fn, actions, alpha, cfg)
        loss = gfn_loss(p, cfg, actions, fwd_lp, log_r, lengths, weights)
        loss_all = pmean(mesh, loss.detach(), "dp")
        params, opt_state = grad_step(mesh, opt, p, opt_state, loss, loss_all,
                                      rows_sum=False)
        rew = all_gather(mesh, rewards[:b_local].detach(), "dp", tiled=True)
        acts = all_gather(mesh, fresh, "dp", tiled=True)
        return params, opt_state, loss_all, rew, acts

    return step_fn, env

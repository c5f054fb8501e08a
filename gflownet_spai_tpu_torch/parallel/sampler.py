"""Sharded Gumbel-top-k sampler: rollouts at huge action spaces
(counterpart of ``gflownet_spai_tpu/parallel/sampler.py``).

No rank materialises a [B, A] tensor:

1. each ``rows`` rank perturbs its logit slice (its column slice of the
   head, ``tp.shard_head``) with its own Gumbel noise and takes a local
   top-``t_cap``;
2. an ``all_gather`` of the R·t_cap candidates merges into the global
   top-``t_cap``: exactly the first t_cap entries of the global perturbed
   descending order, since every rank contributed its own top t_cap;
3. the trajectory is the merged prefix up to the terminal action; its
   per-step log-probs come from suffix sums over the prefix plus the
   ``psum``'d tail mass (additions only).

When the terminal lands inside the prefix, the trajectory and its
log-probs equal ``gfn.rollout.gumbel_topk_rollout`` on the concatenated
per-shard noise (``replicated_oracle_gumbels``); other samples are flagged
``valid=False``.  The noise of rank (d, j) comes from a generator seeded
with (seed, d, j) on the logits' device, or is given (``gumbels``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..gfn.rollout import Rollout, gumbel_noise, trajectory_logprobs
from ..models import policies as pol
from .dp import (_make_residual_provider, effective_alpha, fold_seed, gfn_loss,
                 grad_step, reward_terms, with_grad)
from .mesh import Mesh, all_gather, pmax, pmean, psum
from .tp import shard_head

_HEAD = ("/forward/fc_w", "/forward/fc_b")


class ShardedRollout(NamedTuple):
    rollout: Rollout            # actions / log-probs padded to T = min(t_cap, R·k)
    valid: torch.Tensor         # bool[B]: the terminal action inside the prefix
    logits_local: torch.Tensor  # [A_pad / R] this rank's logits (diagnostics)


def _padded_action_feats(graph, num_actions: int, a_pad: int):
    """[A_pad, F] action-feature rows matching the padded head, or None
    when the graph carries none (the head's column order is the action-id
    order, so the column sharding slices both alike)."""
    feats = getattr(graph, "action_feats", None)
    if feats is None:
        return None
    feats = feats[:num_actions]
    return torch.nn.functional.pad(feats, (0, 0, 0, a_pad - feats.shape[0]))


def shard_noise(seed: int, dp_index: int, rows_index: int, batch: int, a_loc: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """The [batch, a_loc] Gumbel noise rank (dp_index, rows_index) draws."""
    gen = torch.Generator(device=device or "cpu").manual_seed(
        fold_seed(seed, dp_index, rows_index))
    return gumbel_noise((batch, a_loc), gen, dtype, device)


def replicated_oracle_gumbels(seed: int, num_actions: int, a_pad: int, n_shards: int,
                              batch_size: int, dtype=torch.float32,
                              device=None) -> torch.Tensor:
    """The exact noise ``sharded_rollout`` draws from ``seed``, assembled
    on one device ([B, num_actions]): fed to ``gumbel_topk_rollout`` it
    gives the sharded rollout."""
    a_loc = a_pad // n_shards
    parts = [shard_noise(seed, 0, j, batch_size, a_loc, dtype, device)
             for j in range(n_shards)]
    return torch.cat(parts, dim=1)[:, :num_actions]


def _local_logits(mesh, fwd, pooled, feats_loc, num_actions, axis):
    """The rank's [a_loc] logits (−inf past ``num_actions``) and their
    global action ids."""
    a_loc = fwd.fc_w.shape[1]
    l_loc = pooled @ fwd.fc_w + fwd.fc_b
    if feats_loc is not None:
        l_loc = l_loc + feats_loc @ fwd.feat_w
    gids = mesh.index(axis) * a_loc + torch.arange(a_loc, device=l_loc.device)
    live = gids < num_actions
    return torch.where(live, l_loc, float("-inf")), gids, live


def _prefix(mesh, l_loc, gids, live, g, temperature, t_cap, terminal, partial, axis):
    """The merged top-``t_cap`` prefix of the perturbed order and its
    per-step log-probs (differentiable in ``l_loc``).  Returns (actions,
    fwd_lp, lengths, valid), each over the [b, top] prefix."""
    R = mesh.size(axis)
    a_loc = l_loc.shape[0]
    b = g.shape[0]
    pert = l_loc.detach()[None, :] / temperature + g
    k_loc = min(t_cap, a_loc)
    pv, pi = torch.topk(pert, k_loc, dim=-1)
    cand_id = gids[pi]
    flat_pv = all_gather(mesh, pv, axis).permute(1, 0, 2).reshape(b, R * k_loc)
    flat_id = all_gather(mesh, cand_id, axis).permute(1, 0, 2).reshape(b, R * k_loc)
    top = min(t_cap, R * k_loc)
    sel = torch.topk(flat_pv, top, dim=-1).indices
    s_id = torch.gather(flat_id, -1, sel)                       # [b, top]

    # the prefix's logits: each rank contributes the ones it holds
    lid = s_id - mesh.index(axis) * a_loc
    mine = (lid >= 0) & (lid < a_loc)
    l_mine = torch.where(mine, l_loc[lid.clamp(0, a_loc - 1)], 0.0)
    l_full = psum(mesh, l_mine, axis)
    # an lse shift: its gradient contribution cancels, so no gradient
    m = pmax(mesh, torch.max(torch.where(live, l_loc.detach(), -1e30)), axis)
    sumexp = psum(mesh, torch.sum(torch.where(live, torch.exp(l_loc - m), 0.0)), axis)
    ex = torch.exp(l_full - m)
    tail = torch.clamp_min(sumexp - ex.sum(-1, keepdim=True), 0.0)
    suffix = torch.flip(torch.cumsum(torch.flip(ex, [-1]), -1), [-1]) + tail
    step_lp = l_full - (m + torch.log(torch.clamp_min(suffix, 1e-30)))

    hit = s_id == terminal
    valid = hit.any(-1)
    kpos = torch.argmax(hit.int(), dim=-1)
    t_ids = torch.arange(top, device=s_id.device)[None, :]
    if partial:
        on_traj = torch.where(valid[:, None], t_ids <= kpos[:, None], True)
    else:
        on_traj = (t_ids <= kpos[:, None]) & valid[:, None]
    actions = torch.where(on_traj, s_id, -1)
    fwd_lp = torch.where(on_traj, step_lp, 0.0)
    lengths = torch.where(valid, kpos + 1, top)
    return actions, fwd_lp, lengths, valid


def sharded_rollout(mesh: Mesh, p: pol.ForwardPolicyParams, graph, num_actions: int,
                    hidden_dim: int, seed: int, batch_size: int, t_cap: int,
                    heads: int = 4, axis: str = "rows", temperature: float = 1.0,
                    gumbels: torch.Tensor | None = None) -> ShardedRollout:
    """Roll out a batch with the head matmul and the Gumbel top-k sharded
    over ``axis``; ``p`` carries the rank's column slice (``shard_head``).
    Noise: ``gumbels`` ([B, A_pad / R], this rank's) or a generator seeded
    with (``seed``, 0, rank's ``axis`` index).  ``temperature`` tempers the
    sort only: the log-probs are the untempered policy's.  With ``p.feat_w``
    and the graph's ``action_feats`` the value-aware channel is added from
    the rank's feature rows."""
    with torch.no_grad():
        pooled = pol.forward_policy_pooled(p, graph, hidden_dim, heads)
        R, j = mesh.size(axis), mesh.index(axis)
        a_loc = p.fc_w.shape[1]
        feats = (_padded_action_feats(graph, num_actions, a_loc * R)
                 if p.feat_w is not None else None)
        feats_loc = None if feats is None else feats[j * a_loc:(j + 1) * a_loc]
        l_loc, gids, live = _local_logits(mesh, p, pooled, feats_loc, num_actions, axis)
        if gumbels is None:
            gumbels = shard_noise(seed, 0, j, batch_size, a_loc, l_loc.dtype, l_loc.device)
        actions, fwd_lp, lengths, valid = _prefix(
            mesh, l_loc, gids, live, gumbels, temperature, t_cap, num_actions - 1,
            False, axis)
    return ShardedRollout(rollout=Rollout(actions=actions, fwd_logprobs=fwd_lp,
                                          lengths=lengths),
                          valid=valid, logits_local=l_loc)


def make_sharded_sampler_train_step(mesh: Mesh, env, graph, cfg, opt, batch_size: int,
                                    t_cap: int, axis: str = "rows",
                                    replay_samples: int = 0,
                                    partial_subtb: bool = True):
    """Train step whose rollout is sharded too: the action head, the Gumbel
    top-k sort and the per-step log-probs run over ``axis`` with no rank
    holding a [B, A] tensor; the reward residual splits over ``rows``
    through ``parallel.dp``'s providers; the batch splits over ``dp``.

    Returns ``(step_fn, shard_fwd, padded_env)``.  ``shard_fwd(params)``
    gives the rank's parameters (the head's column slice); ``step_fn(
    params, opt_state, seed, r_actions=None, r_valid=None, gumbels=None) ->
    (params, opt_state, loss, rewards, valid, lengths[, actions])``, the
    last four gathered over ``dp`` ([batch] and [batch, t_cap]) on every
    rank, ``actions`` only with replay.  ``gumbels``: this rank's
    [batch / dp, A_pad / R] noise (else a generator seeded with (seed, dp
    index, rows index)).

    Loss: TB, VarGrad or SubTB(λ) over prefixes capped at ``t_cap``.  With
    ``loss="subtb"`` and ``partial_subtb`` a sample whose terminal missed
    the prefix trains as a partial trajectory (the learned flow at the
    truncation point); under TB / VarGrad it is weight-0.  Replayed
    trajectories ([S, t_cap], the same on every rank) are re-scored from
    the all-gathered [A_pad] logits, loss weight ``valid/dp``.  A tiled
    graph with a window plan runs the tile-sharded GAT (``parallel.gat``)
    when R > 1.  ``cfg.temperature`` tempers the sort only.  Gradients:
    each rank back-propagates ``loss / R``, the replicated parameters'
    gradients are summed over ``rows``, all are averaged over ``dp``."""
    dp, R = mesh.size("dp"), mesh.size(axis)
    j = mesh.index(axis)
    partial = bool(partial_subtb) and cfg.loss == "subtb"
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} not divisible by dp={dp}")
    b_local = batch_size // dp
    env, res_fn = _make_residual_provider(mesh, env)

    A = cfg.num_actions
    a_pad = -(-A // R) * R
    a_loc = a_pad // R
    use_feats = bool(getattr(cfg, "edge_feats", False))
    feats_loc = None
    if use_feats:
        feats = _padded_action_feats(graph, A, a_pad)
        if feats is None:
            raise ValueError("cfg.edge_feats=True but the graph carries no "
                             "action_feats (models.policies.*_from_seed builds them)")
        feats_loc = feats[j * a_loc:(j + 1) * a_loc]

    gat = None
    if R > 1 and isinstance(graph, pol.TiledGraphInputs) and graph.srcwin is not None:
        from .gat import local_shard, shard_tiled_graph

        sg, meta = shard_tiled_graph(graph, R)
        gat = (local_shard(sg, meta, j), meta)

    def shard_fwd(params):
        return params._replace(forward=shard_head(mesh, params.forward, axis))

    def step_fn(params, opt_state, seed, r_actions=None, r_valid=None, gumbels=None):
        p = with_grad(params)
        fwd = p.forward
        if gat is not None:
            from .gat import sharded_policy_pooled

            pooled = sharded_policy_pooled(mesh, fwd, gat[0], gat[1], cfg.hidden_dim,
                                           cfg.heads, axis)
        else:
            pooled = pol.forward_policy_pooled(fwd, graph, cfg.hidden_dim, cfg.heads)
        l_loc, gids, live = _local_logits(mesh, fwd, pooled, feats_loc, A, axis)
        if gumbels is None:
            gumbels = shard_noise(seed, mesh.index("dp"), j, b_local, a_loc,
                                  l_loc.dtype, l_loc.device)
        actions, fwd_lp, lengths, valid = _prefix(
            mesh, l_loc, gids, live, gumbels, cfg.temperature, t_cap, A - 1, partial,
            axis)
        actions = actions.detach()
        terminated = valid
        w = (torch.ones_like(fwd_lp[:, 0]) if partial else valid.to(fwd_lp.dtype))
        if replay_samples:
            pad = t_cap - actions.shape[1]
            if pad:
                actions = torch.nn.functional.pad(actions, (0, pad), value=-1)
                fwd_lp = torch.nn.functional.pad(fwd_lp, (0, pad))
            fresh = actions
            # re-scored from ONE [A_pad] logits vector per rank
            full_l = all_gather(mesh, l_loc, axis, tiled=True)
            r_actions = r_actions.to(actions.dtype)
            actions = torch.cat([actions, r_actions], 0)
            fwd_lp = torch.cat([fwd_lp, trajectory_logprobs(full_l, r_actions)], 0)
            lengths = torch.cat([lengths, (r_actions >= 0).sum(-1).to(lengths.dtype)], 0)
            w = torch.cat([w, r_valid.to(fwd_lp.dtype) / dp], 0)
            terminated = torch.cat([terminated, torch.ones_like(r_valid)], 0)
        alpha = effective_alpha(p, cfg, pooled)
        rewards, log_r = reward_terms(env, res_fn, actions, alpha, cfg)
        loss = gfn_loss(p, cfg, actions, fwd_lp, log_r, lengths, w,
                        terminated=terminated if partial else None)
        loss_all = pmean(mesh, loss.detach(), "dp")
        params, opt_state = grad_step(mesh, opt, p, opt_state, loss / R, loss_all,
                                      sharded=_HEAD)
        gather = lambda t: all_gather(mesh, t.detach(), "dp", tiled=True)
        out = (params, opt_state, loss_all, gather(rewards[:b_local]), gather(valid),
               gather(lengths[:b_local]))
        if replay_samples:
            out = out + (gather(fresh),)
        return out

    return step_fn, shard_fwd, env

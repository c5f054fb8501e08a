"""The SPAI GFlowNet's parameters, configuration, sampler and loss
(counterpart of ``gflownet_spai_tpu/gfn/gflownet.py``).

One GATv2 forward pass gives the static action logits, one Gumbel-top-k
sort samples the whole batch of trajectories, the rewards replay the
action lists through the env's fixed-pattern residual plan, the backward
policy scores the trajectories, and TB / SubTB / VarGrad closes the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..env import spai, spai_dia
from ..models import policies as pol
from .loss import (log_reward, subtb_loss, trajectory_balance_loss,
                   vargrad_loss)
from .rollout import Rollout, gumbel_topk_rollout, trajectory_logprobs


def _batched_rewards(env, actions: torch.Tensor, alpha) -> torch.Tensor:
    """The batched reward of whichever env this is (pair / row-block plan,
    or the DIA band)."""
    if isinstance(env, spai_dia.SpaiDiaEnv):
        return spai_dia.batched_rewards(env, actions, alpha)
    return spai.batched_rewards(env, actions, alpha)


class GFlowNetParams(NamedTuple):
    forward: pol.ForwardPolicyParams
    backward: object            # Backward/LinearBackwardParams, or None (uniform)
    log_z: torch.Tensor         # trained log-partition estimate
    flow: pol.FlowHeadParams | None = None   # state flows (SubTB-λ only)


class GFlowNetConfig(NamedTuple):
    hidden_dim: int = 4          # reference GFlowNet100.py:180
    heads: int = 4               # reference policy.py:19
    num_actions: int = 0         # nnz + 1 (env-dependent)
    loss: str = "tb"             # tb | vargrad | subtb
    temperature: float = 1.0     # rollout sampling temperature (>1 explores)
    alpha_fixed: float = -1.0    # >=0 pins the reward mix α (learned if <0)
    subtb_lambda: float = 0.9    # λ for loss="subtb"
    backward: str = "lstm"       # lstm (reference parity) | linear | uniform
    reward_beta: float = 1.0     # reward exponent: P(x) ∝ R(x)^β
    edge_feats: bool = False     # value-aware action-head channel
    terminal_bias: float = 0.0   # initial terminal-logit offset
    t_cap: int = 0               # >0 caps rollouts at t_cap steps


def tree_leaves(tree, prefix: str = "") -> list:
    """``[(path, tensor)]`` of a params tree (nested NamedTuples; ``None``
    fields are skipped), in field order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in tree_leaves(getattr(tree, f), f"{prefix}/{f}")]
    return []


def tree_replace(tree, leaves):
    """``tree`` with its tensor leaves replaced, in ``tree_leaves`` order,
    by the items of the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_replace(getattr(tree, f), leaves)
                            for f in tree._fields))
    return tree


def init_params(gen: torch.Generator, cfg: GFlowNetConfig, dtype=torch.float32,
                device=None) -> GFlowNetParams:
    """Random parameters drawn from the CPU generator ``gen``, placed on
    ``device``."""
    from .._device import resolve_device

    device = resolve_device(device)
    if cfg.backward == "linear":
        backward = pol.linear_backward_init(gen, cfg.hidden_dim, cfg.num_actions,
                                            dtype=dtype)
    elif cfg.backward == "uniform":
        backward = None
    else:
        backward = pol.backward_policy_init(gen, cfg.hidden_dim, cfg.num_actions,
                                            dtype=dtype)
    params = GFlowNetParams(
        forward=pol.forward_policy_init(
            gen, cfg.hidden_dim, cfg.num_actions, heads=cfg.heads, dtype=dtype,
            terminal_bias=cfg.terminal_bias, edge_feats=cfg.edge_feats),
        backward=backward,
        log_z=torch.zeros((), dtype=dtype),
        flow=(pol.flow_head_init(cfg.num_actions, dtype)
              if cfg.loss == "subtb" else None),
    )
    return tree_replace(params, (x.to(device) for _, x in tree_leaves(params)))


def backward_logprobs(params: GFlowNetParams, cfg: GFlowNetConfig,
                      actions: torch.Tensor) -> torch.Tensor:
    """[B, T] actions → [B, T] log P_B under the configured backward policy."""
    if cfg.backward == "linear":
        return pol.linear_backward_batch(params.backward, actions)
    if cfg.backward == "uniform":
        return pol.uniform_backward_logprobs(actions, cfg.num_actions - 1)
    return pol.backward_policy_batch(params.backward, actions, cfg.hidden_dim)


class SampleOut(NamedTuple):
    rollout: Rollout
    rewards: torch.Tensor   # [B]
    alpha: torch.Tensor     # scalar (sigmoid of the learned mixing parameter)
    logits: torch.Tensor    # [A] static policy logits


def sample(params: GFlowNetParams, env, graph,
           cfg: GFlowNetConfig, generator: torch.Generator,
           batch_size: int) -> SampleOut:
    """Roll out a batch and score the terminal states through the env.
    ``generator`` lives on the device of the params and env."""
    logits = pol.forward_policy_logits(params.forward, graph, cfg.num_actions,
                                       cfg.hidden_dim, cfg.heads)
    alpha = pol.forward_policy_alpha(params.forward)
    if cfg.alpha_fixed >= 0:
        alpha = torch.tensor(cfg.alpha_fixed, dtype=logits.dtype,
                             device=logits.device)
    sample_logits = logits / cfg.temperature if cfg.temperature != 1.0 else logits
    rollout = gumbel_topk_rollout(
        sample_logits.expand(batch_size, cfg.num_actions), generator,
        terminal_action=cfg.num_actions - 1,
        t_cap=cfg.t_cap if cfg.t_cap > 0 else None)
    if cfg.temperature != 1.0:
        # re-score under the untempered policy (off-policy exploration)
        rollout = rollout._replace(fwd_logprobs=trajectory_logprobs(
            logits, rollout.actions.detach()))
    rewards = _batched_rewards(env, rollout.actions, alpha)
    return SampleOut(rollout=rollout, rewards=rewards, alpha=alpha, logits=logits)


def loss_fn(params: GFlowNetParams, env, graph,
            cfg: GFlowNetConfig, generator: torch.Generator, batch_size: int,
            replay=None):
    """The configured loss on one sampled batch; returns (loss, aux dict).

    Gradients flow through the per-step forward log-probs (differentiable
    in the logits along the sampled, grad-free action order), the backward
    policy, α (through the reward mix) and log Z or the flow head.
    ``replay``: optional ``(actions [R, T], valid [R])`` from the top-k
    buffer, re-scored under the current logits and α; invalid slots are
    weight-0.  With ``t_cap``, samples whose terminal missed the prefix
    train as partial trajectories under SubTB and are weight-0 under TB
    and VarGrad."""
    out = sample(params, env, graph, cfg, generator, batch_size)
    actions = out.rollout.actions
    fwd_lp = out.rollout.fwd_logprobs
    log_r = cfg.reward_beta * log_reward(out.rewards)
    lengths = out.rollout.lengths
    weights = terminated = None
    if cfg.t_cap > 0:
        terminated = torch.any(actions == cfg.num_actions - 1, dim=-1)
        if cfg.loss != "subtb":
            weights = terminated.to(fwd_lp.dtype)
    if replay is not None:
        r_actions, r_valid = replay
        r_fwd = trajectory_logprobs(out.logits, r_actions)
        r_rewards = _batched_rewards(env, r_actions, out.alpha)
        actions = torch.cat([actions, r_actions], 0)
        fwd_lp = torch.cat([fwd_lp, r_fwd], 0)
        log_r = torch.cat([log_r, cfg.reward_beta * log_reward(r_rewards)], 0)
        lengths = torch.cat([lengths, (r_actions >= 0).sum(-1).to(lengths.dtype)], 0)
        fresh_w = (torch.ones((batch_size,), dtype=fwd_lp.dtype,
                              device=fwd_lp.device) if weights is None else weights)
        weights = torch.cat([fresh_w, r_valid.to(fwd_lp.dtype)], 0)
        if terminated is not None:
            # replay entries are complete trajectories
            terminated = torch.cat([terminated, torch.ones_like(r_valid)], 0)
    back_lp = backward_logprobs(params, cfg, actions)
    if cfg.loss == "vargrad":
        loss = vargrad_loss(log_r, fwd_lp.sum(-1), back_lp.sum(-1), weights=weights)
    elif cfg.loss == "subtb":
        loss = subtb_loss(pol.flow_head_logF(params.flow, actions), log_r, fwd_lp,
                          back_lp, lengths, lam=cfg.subtb_lambda, weights=weights,
                          terminated=terminated)
    else:
        loss = trajectory_balance_loss(params.log_z, log_r, fwd_lp.sum(-1),
                                       back_lp.sum(-1), weights=weights)
    aux = {"rewards": out.rewards, "alpha": out.alpha,
           "lengths": out.rollout.lengths, "loss": loss,
           "actions": out.rollout.actions}
    return loss, aux

"""The SPAI GFlowNet's parameters, configuration and sampler (counterpart of
``gflownet_spai_tpu/gfn/gflownet.py:31-150``; ``loss_fn`` comes with the
training slice).

One GATv2 forward pass gives the static action logits, one Gumbel-top-k
sort samples the whole batch of trajectories, and the rewards replay the
action lists through the env's fixed-pattern residual plan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..env import spai
from ..models import policies as pol
from .rollout import Rollout, gumbel_topk_rollout, trajectory_logprobs


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


def _params_to(tree, device):
    """Move every tensor of a params tree (nested NamedTuples) to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        return type(tree)(*(_params_to(x, device) for x in tree))
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
    return _params_to(params, device)


class SampleOut(NamedTuple):
    rollout: Rollout
    rewards: torch.Tensor   # [B]
    alpha: torch.Tensor     # scalar (sigmoid of the learned mixing parameter)
    logits: torch.Tensor    # [A] static policy logits


def sample(params: GFlowNetParams, env: spai.SpaiEnv, graph,
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
    rewards = spai.batched_rewards(env, rollout.actions, alpha)
    return SampleOut(rollout=rollout, rewards=rewards, alpha=alpha, logits=logits)

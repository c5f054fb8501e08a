"""Trajectory sampler for static logits (counterpart of
``gflownet_spai_tpu/gfn/rollout.py:30-163``).

The SPAI rollout never changes the policy's input graph, only the
taken-action mask, so sequentially sampling a masked categorical without
replacement from fixed logits is the Plackett–Luce order distribution: one
Gumbel perturbation and one sort sample every trajectory of a batch, and
the prefix up to the terminal action is the trajectory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.scan import suffix_logsumexp


class Rollout(NamedTuple):
    """Batched trajectories: ``-1``-padded actions, per-step forward
    log-probs (0 on padding) and lengths (terminal step included)."""
    actions: torch.Tensor       # int64[B, T]
    fwd_logprobs: torch.Tensor  # float[B, T]
    lengths: torch.Tensor       # int64[B]


def gumbel_noise(shape, generator: torch.Generator, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Standard Gumbel samples −log(−log U), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u = torch.clamp_min(u, torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def gumbel_topk_rollout(logits: torch.Tensor, generator: torch.Generator | None,
                        terminal_action: int,
                        gumbels: torch.Tensor | None = None,
                        t_cap: int | None = None) -> Rollout:
    """Sample a batch of delete-until-terminal trajectories.

    ``logits``: [B, A] (terminal included).  Noise comes from ``generator``
    on the logits' device, or from ``gumbels`` ([B, A]) when given.
    Trajectories pad to T = A, or to T = ``t_cap`` when ``t_cap < A``: then
    a sample whose terminal misses the prefix keeps the whole prefix
    (length t_cap, no terminal action), and the per-step log-probs of the
    prefix use prefix sums plus the total tail mass."""
    B, A = logits.shape
    g = gumbels if gumbels is not None else gumbel_noise(
        (B, A), generator, logits.dtype, logits.device)
    if t_cap is not None and t_cap < A:
        cap = int(t_cap)
        idx = torch.topk(logits + g, cap, dim=-1).indices        # [B, cap]
        sorted_logits = torch.gather(logits, -1, idx)
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        sumexp = torch.sum(torch.exp(logits - m), -1, keepdim=True)
        ex = torch.exp(sorted_logits - m)
        tail = torch.clamp_min(sumexp - torch.sum(ex, -1, keepdim=True), 0.0)
        suffix = torch.flip(torch.cumsum(torch.flip(ex, [-1]), -1), [-1]) + tail
        step_lp = sorted_logits - (m + torch.log(torch.clamp_min(suffix, 1e-30)))
        hit = idx == terminal_action
        found = hit.any(dim=-1)
        k = torch.argmax(hit.int(), dim=-1)
        t_ids = torch.arange(cap, device=logits.device)[None, :]
        on_traj = torch.where(found[:, None], t_ids <= k[:, None], True)
        return Rollout(actions=torch.where(on_traj, idx, -1),
                       fwd_logprobs=torch.where(on_traj, step_lp, 0.0),
                       lengths=torch.where(found, k + 1, cap))
    order = torch.argsort(-(logits + g), dim=-1, stable=True)  # descending
    sorted_logits = torch.gather(logits, -1, order)
    step_lp = sorted_logits - suffix_logsumexp(sorted_logits)
    k = torch.argmax((order == terminal_action).int(), dim=-1)
    on_traj = torch.arange(A, device=logits.device)[None, :] <= k[:, None]
    return Rollout(actions=torch.where(on_traj, order, -1),
                   fwd_logprobs=torch.where(on_traj, step_lp, 0.0),
                   lengths=k + 1)


def trajectory_logprobs(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Per-step log-probs of given ``-1``-padded trajectories ([..., T])
    under sequential masked-categorical semantics, in O(A + T) each: the
    remaining set at step t is the disjoint union of the never-taken
    actions and the taken suffix, so
    denom_t = logaddexp(lse(untaken), suffix-lse(taken logits)[t])."""
    A = logits.shape[0]
    valid = actions >= 0
    a_safe = torch.where(valid, actions, 0).long()
    taken = torch.where(valid, logits[a_safe],
                        torch.tensor(float("-inf"), dtype=logits.dtype,
                                     device=logits.device))
    idx = torch.where(valid, actions, A).long()
    mask = torch.ones(actions.shape[:-1] + (A + 1,), dtype=torch.bool,
                      device=logits.device)
    mask.scatter_(-1, idx, False)
    mask = mask[..., :A]
    any_un = mask.any(dim=-1, keepdim=True)
    masked = torch.where(mask, logits, float("-inf"))
    un_lse = torch.where(
        any_un, torch.logsumexp(torch.where(any_un, masked, 0.0), -1, keepdim=True),
        float("-inf"))
    denom = torch.logaddexp(un_lse, suffix_logsumexp(taken))
    return torch.where(valid, taken - denom, 0.0)


def sequential_logprobs(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Oracle: per-step log-probs of one ``-1``-padded trajectory [T] by
    stepping a taken-mask (O(A·T))."""
    taken = torch.zeros_like(logits, dtype=torch.bool)
    out = []
    for a in actions.tolist():
        if a < 0:
            out.append(logits.new_zeros(()))
            continue
        masked = torch.where(taken, float("-inf"), logits)
        out.append(masked[a] - torch.logsumexp(masked, 0))
        taken[a] = True
    return torch.stack(out)

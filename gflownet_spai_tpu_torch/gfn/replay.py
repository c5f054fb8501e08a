"""Top-k reward replay buffer for off-policy TB/SubTB training (counterpart
of ``gflownet_spai_tpu/gfn/replay.py``).

The buffer keeps the K best unique trajectories seen so far; each epoch a
few of them are re-scored under the current policy
(``rollout.trajectory_logprobs``).  Empty slots carry reward −inf and are
weight-0 in the loss.  Actions are int64 here (the port's index type);
trajectory signatures keep the JAX package's int32 wraparound arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_NEG = float("-inf")


class ReplayBuffer(NamedTuple):
    actions: torch.Tensor   # int64 [K, T], -1 padded
    rewards: torch.Tensor   # [K], -inf marks an empty slot


def replay_init(capacity: int, traj_len: int, dtype=torch.float32,
                device=None) -> ReplayBuffer:
    return ReplayBuffer(
        actions=torch.full((capacity, traj_len), -1, dtype=torch.int64,
                           device=device),
        rewards=torch.full((capacity,), _NEG, dtype=dtype, device=device))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value with the same low 32 bits."""
    return ((x + 2**31) % 2**32) - 2**31


def _signatures(actions: torch.Tensor) -> torch.Tensor:
    """[N, T] → [N, 2] order-sensitive int32 trajectory hashes, computed in
    int64 and wrapped as the JAX package's int32 arithmetic wraps."""
    T = actions.shape[-1]
    t = torch.arange(T, dtype=torch.int64, device=actions.device)
    w1 = _wrap32(t * 1103515245 + 97) | 1
    w2 = _wrap32(t * 40503 + 1013904223) | 1
    a = actions.to(torch.int64) + 2
    return torch.stack([_wrap32(_wrap32(a * w1).sum(-1)),
                        _wrap32(_wrap32(a * w2).sum(-1))], dim=-1)


def replay_update(buf: ReplayBuffer, actions: torch.Tensor,
                  rewards: torch.Tensor) -> ReplayBuffer:
    """Merge a batch into the buffer and keep the top K unique by reward."""
    K = buf.rewards.shape[0]
    cand_a = torch.cat([buf.actions, actions.to(buf.actions.dtype)], 0)
    cand_r = torch.cat([buf.rewards, rewards.to(buf.rewards.dtype)], 0)
    sig = _signatures(cand_a)
    order = torch.argsort(sig[:, 0], stable=True)
    s_sorted = sig[order]
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=sig.device),
                     (s_sorted[1:] == s_sorted[:-1]).all(-1)])
    r_sorted = torch.where(dup, _NEG, cand_r[order])
    top = torch.topk(r_sorted, K).indices
    # r_sorted keeps duplicates −inf-marked even when they make the cut
    return ReplayBuffer(actions=cand_a[order[top]], rewards=r_sorted[top])


def replay_resize(buf: ReplayBuffer, traj_len: int) -> ReplayBuffer:
    """Change the trajectory width: growing pads with −1; shrinking empties
    entries that no longer fit."""
    K, T = buf.actions.shape
    if traj_len == T:
        return buf
    if traj_len > T:
        pad = buf.actions.new_full((K, traj_len - T), -1)
        return buf._replace(actions=torch.cat([buf.actions, pad], 1))
    fits = (buf.actions[:, traj_len:] < 0).all(dim=1)
    return ReplayBuffer(
        actions=torch.where(fits[:, None], buf.actions[:, :traj_len], -1),
        rewards=torch.where(fits, buf.rewards, _NEG))


def replay_logits(buf: ReplayBuffer, prioritized: float = 0.0) -> torch.Tensor:
    """[K] sampling logits over the buffer: −inf on empty slots; with
    ``prioritized`` α > 0, −α·log(1 + rank) (rank 0 = best reward)."""
    filled = torch.isfinite(buf.rewards)
    if prioritized > 0.0:
        rank = torch.argsort(torch.argsort(-buf.rewards, stable=True), stable=True)
        return torch.where(filled, -prioritized * torch.log1p(
            rank.to(buf.rewards.dtype)), _NEG)
    return torch.where(filled, 0.0, _NEG).to(buf.rewards.dtype)


def replay_sample(buf: ReplayBuffer, generator: torch.Generator, num: int,
                  prioritized: float = 0.0):
    """Draw ``num`` filled slots with replacement from ``generator`` (on the
    buffer's device).  Returns (actions [num, T], rewards [num], valid
    [num]); ``valid`` is false while the buffer is empty."""
    filled = torch.isfinite(buf.rewards)
    logits = replay_logits(buf, prioritized)
    any_filled = filled.any()
    probs = torch.softmax(torch.where(any_filled, logits,
                                      torch.zeros_like(logits)), dim=0)
    idx = torch.multinomial(probs, num, replacement=True, generator=generator)
    return buf.actions[idx], buf.rewards[idx], any_filled & filled[idx]

"""GFlowNet objectives in log space (counterpart of
``gflownet_spai_tpu/gfn/loss.py``): trajectory balance with a trained
log Z, sub-trajectory balance SubTB(λ) against learned state flows, and
VarGrad.  Rewards are clamped at a floor before the log, so every sample
keeps training (the reference's log of a non-positive reward is NaN)."""

from __future__ import annotations

import torch


def log_reward(rewards: torch.Tensor, floor: float = 1e-9) -> torch.Tensor:
    """log(max(R, floor))."""
    return torch.log(torch.clamp_min(rewards, floor))


def _weighted_mean(x: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return x.mean()
    w = weights.to(x.dtype)
    return torch.sum(w * x) / torch.clamp_min(torch.sum(w), 1e-30)


def trajectory_balance_loss(log_z, log_rewards, fwd_logprob_sum,
                            back_logprob_sum, weights=None) -> torch.Tensor:
    """Mean squared TB discrepancy over a batch; inputs [B] except the
    scalar ``log_z``; ``weights`` [B] down-weights entries."""
    delta = log_z + fwd_logprob_sum - log_rewards - back_logprob_sum
    return _weighted_mean(delta * delta, weights)


def subtb_loss(log_flows, log_rewards, fwd_logprobs, back_logprobs, lengths,
               lam: float = 0.9, weights=None, terminated=None) -> torch.Tensor:
    """SubTB(λ) (Madan et al. 2022) in O(T) per trajectory.

    Per trajectory with states s_0..s_L (flow at s_L := R) the loss is
    Σ_{i<j} λ^{j−i} A_ij² / Σ_{i<j} λ^{j−i} with A_ij = c_i − c_j,
    c_t = log F(s_t) − P_t (P_t the prefix sum of log P_F − log P_B); the
    pair sum collapses to per-j terms S_j c_j² − 2 c_j M_j + Q_j whose
    λ-discounted prefix aggregates M and Q are ``ops.scan.linear_scan``s.

    ``log_flows`` [B, T+1]; ``fwd_logprobs``/``back_logprobs`` [B, T];
    ``lengths`` [B] actions incl. the terminal one.  ``terminated`` [B]
    (default all true): entries that never reached the terminal keep the
    learned flow at ``lengths[b]`` instead of the reward."""
    from ..ops.scan import linear_scan

    B, T = fwd_logprobs.shape
    dtype, dev = fwd_logprobs.dtype, fwd_logprobs.device
    lam = float(lam)
    prefix = torch.cat([fwd_logprobs.new_zeros((B, 1)),
                        torch.cumsum(fwd_logprobs - back_logprobs, dim=-1)], -1)
    t_ids = torch.arange(T + 1, device=dev)[None, :]
    L = lengths[:, None]
    at_end = t_ids == L
    if terminated is not None:
        at_end = at_end & terminated[:, None]
    logF = torch.where(at_end, log_rewards[:, None], log_flows)
    valid = t_ids <= L
    c = torch.where(valid, logF - prefix, 0.0)
    a = torch.full((B, T), lam, dtype=dtype, device=dev)
    zeros = c.new_zeros((B, 1))
    m = torch.cat([zeros, linear_scan(a, lam * c[:, :-1], axis=-1)], -1)
    q = torch.cat([zeros, linear_scan(a, lam * c[:, :-1] ** 2, axis=-1)], -1)
    jf = t_ids.to(dtype)
    s = jf if lam == 1.0 else lam * (1.0 - torch.pow(lam, jf)) / (1.0 - lam)
    term = s * c * c - 2.0 * c * m + q
    wmask = (t_ids >= 1) & valid
    total = torch.sum(torch.where(wmask, term, 0.0), dim=-1)
    wsum = torch.sum(torch.where(wmask, s, 0.0), dim=-1)
    # the guard is a normal float32: a length-0 (weight-0 replay) entry
    # must give 0/1e-30, not 0/0
    return _weighted_mean(total / torch.clamp_min(wsum, 1e-30), weights)


def vargrad_loss(log_rewards, fwd_logprob_sum, back_logprob_sum,
                 weights=None) -> torch.Tensor:
    """Batch variance of δ = log R + Σ log P_B − Σ log P_F (TB with log Z
    replaced by its per-batch estimate)."""
    delta = log_rewards + back_logprob_sum - fwd_logprob_sum
    if weights is None:
        return torch.var(delta, unbiased=False)
    mean = _weighted_mean(delta, weights)
    return _weighted_mean((delta - mean) ** 2, weights)

"""SPAI preconditioner environment on the pair-plan reward path
(counterpart of ``gflownet_spai_tpu/env/spai.py:40-359``).

A state is a boolean keep-mask over the seed pattern's edges; the reward
``‖M·A − I‖_F`` runs through a fixed-pattern SpGEMM plan built once on the
host, so a batched reward is one gather · multiply · ``index_add_`` over
``[B, npairs]`` on the device.  The row-block reward backend, built for the
TPU's matrix unit, comes with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..sparse.convert import coo_to_scipy
from ..sparse.ops import SpGEMMPlan, frobenius_sq_minus_identity
from ..sparse.types import COO


@dataclasses.dataclass(frozen=True)
class SpaiEnv:
    """Static environment: the seed M0 (its edge set is the action space),
    the matrix it is scored against, the pair plan of M0 · original and
    the baseline scalars — tensors on one device."""

    seed: COO
    original: COO
    plan: SpGEMMPlan
    baseline_residual: torch.Tensor
    baseline_flops: float
    rb: None = None   # row-block plan: not in this slice

    @property
    def n(self) -> int:
        return self.seed.shape[0]

    @property
    def num_edges(self) -> int:
        return self.seed.nnz

    @property
    def num_actions(self) -> int:
        """nnz + 1: one delete-action per edge plus the terminal action."""
        return self.seed.nnz + 1

    @property
    def terminal_action(self) -> int:
        return self.seed.nnz


def _to_scipy(m: COO):
    return coo_to_scipy(m).astype(np.float64)


def _baseline_residual_host(original: COO) -> float:
    """‖A·A − I‖_F in float64 on the host."""
    import scipy.sparse as sp

    a = _to_scipy(original)
    c = (a @ a - sp.eye(original.shape[0], format="csr")).tocoo()
    return float(np.sqrt(np.sum(c.data * c.data)))


def _seed_residual_host(seed: COO, original: COO) -> float:
    """‖M₀·A − I‖_F for the untouched seed, in float64 on the host."""
    import scipy.sparse as sp

    c = (_to_scipy(seed) @ _to_scipy(original)
         - sp.eye(original.shape[0], format="csr")).tocoo()
    return float(np.sqrt(np.sum(c.data * c.data)))


#: ``baseline="matrix"`` is non-discriminating when ‖A·A−I‖ exceeds this
#: multiple of ‖M₀·A−I‖ (see ``resolve_baseline``).
DEGENERACY_FACTOR = 20.0


def resolve_baseline(seed: COO, original: COO, baseline: str) -> str:
    """Resolve ``matrix``/``identity``/``auto`` to a concrete mode, warning
    when the matrix baseline cannot rank the preconditioners the seed
    reaches: ``auto`` picks ``identity`` whenever ‖A·A−I‖ > 20·‖M₀·A−I‖."""
    return _resolve_baseline_with_value(seed, original, baseline)[0]


def _resolve_baseline_with_value(seed: COO, original: COO, baseline: str):
    """(mode, ‖A·A−I‖ or None), so make_env never computes A·A twice."""
    if baseline == "identity":
        return "identity", None
    if baseline not in ("matrix", "auto"):
        raise ValueError(f"unknown baseline {baseline!r}")
    base = _baseline_residual_host(original)
    seed_res = _seed_residual_host(seed, original)
    if not base > DEGENERACY_FACTOR * max(seed_res, 1e-30):
        return "matrix", base
    detail = (
        f"reward baseline ‖A·A−I‖={base:.3e} is {base / max(seed_res, 1e-30):.0f}× "
        f"the seed residual ‖M0·A−I‖={seed_res:.3e}: the residual term of the "
        "reward saturates near its maximum for EVERY reachable pattern and the "
        "flops term drives the policy toward deleting everything "
        "(env.spai.make_env docstring; measured on orsirr_like)."
    )
    if baseline == "auto":
        warnings.warn("reward_baseline='auto' resolved to 'identity': " + detail,
                      stacklevel=2)
        return "identity", None
    warnings.warn("DEGENERATE reward baseline: " + detail +
                  " Pass reward_baseline='identity' (or 'auto').", stacklevel=2)
    return "matrix", base


def make_env(seed: COO, original: Optional[COO] = None,
             reward_path: str = "pair", baseline: str = "matrix",
             device=None) -> SpaiEnv:
    """Build the environment on ``device``.  ``original`` defaults to
    ``seed`` (the reference training script's baseline wiring); pass the true A for
    the corrected objective.  ``baseline``: ``matrix`` = ‖A·A − I‖_F,
    ``identity`` = √n, ``auto`` = ``matrix`` unless degenerate for this
    seed (``resolve_baseline``)."""
    if reward_path == "rowblock":
        raise NotImplementedError(
            "reward_path='rowblock' (sparse/rowblock.py) comes with the "
            "rowblock/DIA slice of the port; use reward_path='pair'")
    if reward_path != "pair":
        raise ValueError(f"unknown reward_path {reward_path!r}")
    device = resolve_device(device)
    same = original is None or original is seed
    if original is None:
        original = seed
    baseline, _ = _resolve_baseline_with_value(seed, original, baseline)
    seed_d = seed.to(device)
    orig_d = seed_d if same else original.to(device)
    plan = SpGEMMPlan(seed, original, device=device)
    dtype = seed_d.data.dtype
    if baseline == "identity":
        base_res = torch.tensor(np.sqrt(float(original.shape[0])), dtype=dtype,
                                device=device)
    else:
        base_plan = plan if same else SpGEMMPlan(original, original, device=device)
        base_vals = base_plan.numeric(orig_d.data, orig_d.data)
        base_res = torch.sqrt(frobenius_sq_minus_identity(
            base_plan.out_row, base_plan.out_col, base_vals, original.shape[0]))
    return SpaiEnv(seed=seed_d, original=orig_d, plan=plan,
                   baseline_residual=base_res,
                   baseline_flops=2.0 * original.nnz * original.shape[1])


# ---------------------------------------------------------------------------
# State transitions and rewards
# ---------------------------------------------------------------------------

def keep_mask_from_actions(actions: torch.Tensor, num_edges: int) -> torch.Tensor:
    """[..., T] action lists (``-1``-padded, may hold the terminal index)
    → [..., num_edges] keep masks: every listed edge is deleted."""
    valid = (actions >= 0) & (actions < num_edges)
    idx = torch.where(valid, actions, num_edges).long()
    keep = torch.ones(actions.shape[:-1] + (num_edges + 1,), dtype=torch.bool,
                      device=actions.device)
    keep.scatter_(-1, idx, False)
    return keep[..., :num_edges]


def batched_residual_norms(env: SpaiEnv, keep: torch.Tensor) -> torch.Tensor:
    """[B, num_edges] keep masks → [B] residual norms ‖M·original − I‖_F."""
    m_vals = env.seed.data * keep.to(env.seed.data.dtype)
    c_vals = env.plan.numeric(m_vals, env.original.data)
    return torch.sqrt(frobenius_sq_minus_identity(
        env.plan.out_row, env.plan.out_col, c_vals, env.n))


def rewards_from_keep(env: SpaiEnv, keep: torch.Tensor, alpha) -> torch.Tensor:
    """[B, num_edges] keep masks → [B] rewards:
    1000 · (α(1 − res/baseline) + (1 − α)(1 − flops/baseline_flops))."""
    res_ratio = batched_residual_norms(env, keep) / env.baseline_residual
    nnz = torch.sum(keep.to(env.seed.data.dtype), dim=-1)
    comp_ratio = 2.0 * nnz * env.seed.shape[1] / env.baseline_flops
    metric = alpha * (1.0 - res_ratio) + (1.0 - alpha) * (1.0 - comp_ratio)
    return metric * 1000.0


def batched_rewards(env: SpaiEnv, actions: torch.Tensor, alpha) -> torch.Tensor:
    """``actions``: int[B, T] (-1 padded) → rewards [B]."""
    return rewards_from_keep(env, keep_mask_from_actions(actions, env.num_edges),
                             alpha)

"""SPAI preconditioner environment on the pair-plan reward path
(counterpart of ``gflownet_spai_tpu/env/spai.py``).

A state is a boolean keep-mask over the seed pattern's edges; the reward
``‖M·A − I‖_F`` runs through a fixed-pattern plan built once on the host,
one of two interchangeable backends (same semantics, tested equal):

* ``plan``, the pair plan: a batched reward is one gather · multiply ·
  ``index_add_`` over ``[B, npairs]`` on the device;
* ``rb``, the row-block plan (``sparse.rowblock``): bucketed dense G
  blocks make the batched reward a handful of batched matrix products,
  the default for large unstructured seeds (``train.loop.setup``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..sparse import rowblock as _rowblock
from ..sparse.convert import coo_to_scipy
from ..sparse.ops import SpGEMMPlan, frobenius_sq_minus_identity
from ..sparse.types import COO, to_numpy


@dataclasses.dataclass(frozen=True)
class SpaiEnv:
    """Static environment: the seed M0 (its edge set is the action space),
    the matrix it is scored against, the plan of M0 · original (the pair
    plan, or ``rb``, the row-block plan, with ``plan`` None) and the
    baseline scalars — tensors on one device."""

    seed: COO
    original: COO
    plan: Optional[SpGEMMPlan]
    baseline_residual: torch.Tensor
    baseline_flops: float
    rb: Optional[_rowblock.RowBlockPlan] = None

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
             device=None, rowblock_dtype=None, rowblock_layout: str = "cm",
             rowblock_class_step: float = 1.5, rowblock_compress: str = "none",
             rowblock_order: str = "sorted") -> SpaiEnv:
    """Build the environment on ``device``.  ``original`` defaults to
    ``seed`` (the reference training script's baseline wiring); pass the true A for
    the corrected objective.  ``baseline``: ``matrix`` = ‖A·A − I‖_F,
    ``identity`` = √n, ``auto`` = ``matrix`` unless degenerate for this
    seed (``resolve_baseline``).

    ``reward_path``: ``pair`` or ``rowblock`` (``sparse.rowblock``; the
    ``rowblock_*`` arguments are its plan's options, ``rowblock_dtype`` its
    G-block storage dtype, default the seed's).  A window-order plan
    defines the edge enumeration: the env's seed (action ids, policy
    graph, keep masks) follows its ``edge_perm``."""
    if reward_path not in ("pair", "rowblock"):
        raise ValueError(f"unknown reward_path {reward_path!r}")
    device = resolve_device(device)
    same = original is None or original is seed
    if original is None:
        original = seed
    baseline, cached_base = _resolve_baseline_with_value(seed, original, baseline)
    if reward_path == "rowblock":
        return _make_rowblock_env(seed, original, baseline, cached_base, device,
                                  rowblock_dtype, rowblock_layout,
                                  rowblock_class_step, rowblock_compress,
                                  rowblock_order)
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


def _make_rowblock_env(seed: COO, original: COO, baseline: str, cached_base,
                       device, dtype, layout, class_step, compress, order) -> SpaiEnv:
    """The env on the row-block plan; the baselines on the host in float64
    (no pair plan is built)."""
    host = seed.numpy()
    sdtype = torch.as_tensor(host.data[:0]).dtype
    rb = _rowblock.build_rowblock_plan(
        seed, original, gemm_dtype=dtype or sdtype, layout=layout,
        class_step=class_step, compress=compress, order=order, device=device)
    if rb.edge_perm is not None:
        # each bucket's m-value windows become contiguous slices
        p = to_numpy(rb.edge_perm)
        host = COO(row=host.row[p], col=host.col[p], data=host.data[p],
                   shape=host.shape)
    base = (np.sqrt(float(original.shape[0])) if baseline == "identity" else
            cached_base if cached_base is not None else
            _baseline_residual_host(original))
    return SpaiEnv(seed=host.to(device), original=original.to(device), plan=None,
                   baseline_residual=torch.tensor(base, dtype=sdtype, device=device),
                   baseline_flops=2.0 * original.nnz * original.shape[1], rb=rb)


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


def masked_values(env: SpaiEnv, keep: torch.Tensor) -> torch.Tensor:
    """Values of the thinned preconditioner M on the seed pattern."""
    return env.seed.data * keep.to(env.seed.data.dtype)


def residual_norm(env: SpaiEnv, keep: torch.Tensor) -> torch.Tensor:
    """``‖M·original − I‖_F`` for one keep mask [num_edges], M the seed
    values masked by ``keep``, through whichever plan the env carries."""
    m_vals = masked_values(env, keep)
    if env.rb is not None:
        return _rowblock.residual_norm_batch(env.rb, m_vals[None, :])[0]
    c_vals = env.plan.numeric(m_vals, env.original.data)
    return torch.sqrt(frobenius_sq_minus_identity(
        env.plan.out_row, env.plan.out_col, c_vals, env.n))


def matrix_flops(env: SpaiEnv, keep: torch.Tensor) -> torch.Tensor:
    """2·nnz(M)·ncols for one keep mask."""
    return 2.0 * torch.sum(keep.to(env.seed.data.dtype)) * env.seed.shape[1]


def evaluate_preconditioner(env: SpaiEnv, keep: torch.Tensor, alpha) -> torch.Tensor:
    """α(1 − res/baseline) + (1 − α)(1 − flops/baseline_flops) for one
    keep mask."""
    res_ratio = residual_norm(env, keep) / env.baseline_residual
    comp_ratio = matrix_flops(env, keep) / env.baseline_flops
    return alpha * (1.0 - res_ratio) + (1.0 - alpha) * (1.0 - comp_ratio)


def reward(env: SpaiEnv, keep: torch.Tensor, alpha) -> torch.Tensor:
    """Terminal reward of one keep mask: the metric × 1000."""
    return evaluate_preconditioner(env, keep, alpha) * 1000.0


def reward_from_actions(env: SpaiEnv, actions: torch.Tensor, alpha) -> torch.Tensor:
    """The reward of one ``-1``-padded action list [T]; equals
    ``batched_rewards(env, actions[None], alpha)[0]``."""
    return reward(env, keep_mask_from_actions(actions, env.num_edges), alpha)


def batched_residual_norms(env: SpaiEnv, keep: torch.Tensor) -> torch.Tensor:
    """[B, num_edges] keep masks → [B] residual norms ‖M·original − I‖_F,
    through whichever plan the env carries."""
    m_vals = masked_values(env, keep)
    if env.rb is not None:
        return _rowblock.residual_norm_batch(env.rb, m_vals)
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

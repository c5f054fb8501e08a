"""SPAI environment on the DIA path for banded matrices (counterpart of
``gflownet_spai_tpu/env/spai_dia.py``).

Same reward semantics as ``env.spai``, with the seed and A in DIA form:

* the edge / action enumeration is **(diagonal, row) order**: each
  diagonal's edges form one contiguous segment of the action space, and
  a keep mask lands on the band storage through one gather;
* ``M·A`` comes from the banded DIA × DIA product (``ops.dia.spgemm_dia``),
  shifted elementwise products in place of the pair plan's gathers.

Rewards agree with ``env.spai`` for corresponding edge *sets*; the policy
graph is built from ``edge_coo``, so its edge ids equal the action ids.
The batched reward is plain PyTorch, elementwise products and sums in a
fixed order, so a second call gives the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.dia import (DIA, coo_to_dia, dia_to_coo, frobenius_sq_minus_identity_dia,
                       frobenius_sq_minus_identity_dia_batch, spgemm_dia,
                       spgemm_dia_batch)
from ..sparse.types import COO, to_numpy
from . import spai


@dataclasses.dataclass(frozen=True, eq=False)
class SpaiDiaEnv:
    seed: DIA                     # seed pattern values (M0)
    original: DIA                 # A
    # per-diagonal contiguous edge segments: edge e of diagonal s covers rows
    # [row_start[s], row_start[s] + seg_len[s]) at flat offset seg_off[s]
    row_start: Tuple[int, ...]
    seg_len: Tuple[int, ...]
    seg_off: Tuple[int, ...]
    baseline_residual: torch.Tensor
    baseline_flops: float
    # the band slot of every edge: data.view(-1)[slot[e]] is edge e's value
    slot: torch.Tensor = dataclasses.field(repr=False)
    # 1 where the edge's seed value is nonzero (kept_nnz counts only those)
    nonzero: torch.Tensor = dataclasses.field(repr=False)

    @property
    def n(self) -> int:
        return self.seed.n

    @property
    def num_edges(self) -> int:
        return int(self.seg_off[-1] + self.seg_len[-1]) if self.seg_len else 0

    @property
    def num_actions(self) -> int:
        return self.num_edges + 1

    @property
    def terminal_action(self) -> int:
        return self.num_edges


def has_phantom_slots(seed_d: DIA) -> int:
    """Number of in-range diagonal slots holding a stored ZERO.  The DIA
    action enumeration is slot-based (contiguous per diagonal); zero-valued
    slots would become phantom edges that diverge from the COO env's
    nnz-based action space and flop counts."""
    data = to_numpy(seed_d.data)
    n = seed_d.n
    phantom = 0
    for s, d in enumerate(seed_d.offsets):
        start, length = max(0, -d), n - abs(d)
        phantom += int((data[s, start:start + length] == 0).sum())
    return phantom


def _repad(d: DIA, n_pad: int) -> DIA:
    return dataclasses.replace(
        d, data=torch.nn.functional.pad(d.data, (0, n_pad - d.n_pad)))


def make_dia_env(seed: COO | DIA, original: COO | DIA, allow_phantom: bool = False,
                 baseline: str = "matrix", device=None) -> SpaiDiaEnv:
    """The DIA env on ``device`` (CUDA unless the caller asks for another).
    ``baseline``: ``matrix`` = ‖A·A − I‖_F, ``identity`` = √n, ``auto`` =
    ``matrix`` unless degenerate for this seed (``spai.resolve_baseline``).
    A seed with stored zeros inside its diagonals is refused unless
    ``allow_phantom``."""
    device = resolve_device(device)
    seed_d = (seed if isinstance(seed, DIA) else coo_to_dia(seed, device=device)).to(device)
    orig_d = (original if isinstance(original, DIA)
              else coo_to_dia(original, device=device)).to(device)
    phantom = has_phantom_slots(seed_d)
    if phantom and not allow_phantom:
        raise ValueError(
            f"seed pattern has {phantom} zero-valued slots inside its "
            "diagonals; the DIA action space would diverge from the COO "
            "env's (phantom edges). Use the COO env (env_format='coo') or "
            "pass allow_phantom=True.")
    if orig_d.n_pad != seed_d.n_pad:
        target = max(orig_d.n_pad, seed_d.n_pad)
        seed_d, orig_d = _repad(seed_d, target), _repad(orig_d, target)
    n, n_pad = seed_d.n, seed_d.n_pad
    row_start, seg_len, seg_off, slots = [], [], [], []
    off_acc = 0
    for s, d in enumerate(seed_d.offsets):
        start, length = max(0, -d), n - abs(d)
        row_start.append(start)
        seg_len.append(length)
        seg_off.append(off_acc)
        slots.append(s * n_pad + np.arange(start, start + length))
        off_acc += length
    slot = np.concatenate(slots) if slots else np.zeros(0, np.int64)
    mode = spai.resolve_baseline(dia_to_coo(seed_d), dia_to_coo(orig_d), baseline)
    dtype = seed_d.data.dtype
    if mode == "identity":
        base_res = torch.tensor(float(n) ** 0.5, dtype=dtype, device=device)
    else:
        base_res = torch.sqrt(frobenius_sq_minus_identity_dia(spgemm_dia(orig_d, orig_d)))
    slot_t = torch.as_tensor(slot, device=device)
    return SpaiDiaEnv(
        seed=seed_d, original=orig_d, row_start=tuple(row_start),
        seg_len=tuple(seg_len), seg_off=tuple(seg_off),
        baseline_residual=base_res,
        baseline_flops=2.0 * orig_d.nnz * orig_d.shape[1],
        slot=slot_t,
        nonzero=(seed_d.data.reshape(-1)[slot_t] != 0).to(dtype))


def edge_coo(env: SpaiDiaEnv) -> COO:
    """Seed edges as a host COO *in the (diagonal, row) action enumeration*:
    build the policy graph from it so GAT edge ids match action ids."""
    data = to_numpy(env.seed.data)
    rows, cols, vals = [], [], []
    for s, d in enumerate(env.seed.offsets):
        i = np.arange(env.row_start[s], env.row_start[s] + env.seg_len[s])
        rows.append(i)
        cols.append(i + d)
        vals.append(data[s, i])
    return COO(row=np.concatenate(rows).astype(np.int32),
               col=np.concatenate(cols).astype(np.int32),
               data=np.concatenate(vals), shape=env.seed.shape)


def masked_seed_data(env: SpaiDiaEnv, keep: torch.Tensor) -> torch.Tensor:
    """[..., num_edges] keep masks → the masked seed diagonals [...,
    ndiags, n_pad] (slots outside every segment stay 0)."""
    dtype = env.seed.data.dtype
    mask = keep.new_zeros(keep.shape[:-1] + (env.seed.data.numel(),), dtype=dtype)
    mask[..., env.slot] = keep.to(dtype)
    return env.seed.data * mask.reshape(keep.shape[:-1] + tuple(env.seed.data.shape))


def masked_seed(env: SpaiDiaEnv, keep: torch.Tensor) -> DIA:
    """One [num_edges] keep mask applied to the seed, as a DIA matrix."""
    return dataclasses.replace(env.seed, data=masked_seed_data(env, keep))


def residual_norms(env: SpaiDiaEnv, keep: torch.Tensor) -> torch.Tensor:
    """[..., num_edges] keep masks → ‖M·A − I‖_F per mask."""
    c, offsets = spgemm_dia_batch(masked_seed_data(env, keep), env.seed.offsets,
                                  env.original)
    return torch.sqrt(frobenius_sq_minus_identity_dia_batch(c, offsets, env.n))


def kept_nnz(env: SpaiDiaEnv, keep: torch.Tensor) -> torch.Tensor:
    """Count of kept edges with a nonzero seed value (zero-valued phantom
    slots, possible under ``allow_phantom``, cost no flops)."""
    return torch.sum(keep.to(env.nonzero.dtype) * env.nonzero, dim=-1)


def rewards_from_keep(env: SpaiDiaEnv, keep: torch.Tensor, alpha) -> torch.Tensor:
    """[..., num_edges] keep masks → rewards:
    1000 · (α(1 − res/baseline) + (1 − α)(1 − flops/baseline_flops))."""
    res_ratio = residual_norms(env, keep) / env.baseline_residual
    comp_ratio = 2.0 * kept_nnz(env, keep) * env.seed.shape[1] / env.baseline_flops
    metric = alpha * (1.0 - res_ratio) + (1.0 - alpha) * (1.0 - comp_ratio)
    return metric * 1000.0


def residual_norm(env: SpaiDiaEnv, keep: torch.Tensor) -> torch.Tensor:
    """One [num_edges] keep mask → ‖M·A − I‖_F (a scalar)."""
    return residual_norms(env, keep[None])[0]


def reward(env: SpaiDiaEnv, keep: torch.Tensor, alpha) -> torch.Tensor:
    """One [num_edges] keep mask → its reward (a scalar)."""
    return rewards_from_keep(env, keep[None], alpha)[0]


def reward_from_actions(env: SpaiDiaEnv, actions: torch.Tensor, alpha) -> torch.Tensor:
    """One -1-padded trajectory [T] → its reward (a scalar)."""
    return batched_rewards(env, actions[None], alpha)[0]


def batched_rewards(env: SpaiDiaEnv, actions: torch.Tensor, alpha) -> torch.Tensor:
    """``actions``: int[B, T] (-1 padded) → rewards [B]."""
    return rewards_from_keep(
        env, spai.keep_mask_from_actions(actions, env.num_edges), alpha)

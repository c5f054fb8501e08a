"""Validation helpers (counterpart of ``gflownet_spai_tpu/solvers/validate.py``).
This slice brings ``best_sampled_matrix`` only; the GMRES validation comes
with the validation slice of the port."""

from __future__ import annotations

import torch

from ..env import spai
from ..sparse.types import COO


def best_sampled_matrix(env, actions: torch.Tensor, rewards: torch.Tensor) -> COO:
    """The highest-reward sampled preconditioner of a batch of
    trajectories, as a COO matrix on the env's device."""
    best = int(torch.argmax(rewards))
    keep = spai.keep_mask_from_actions(actions[best], env.num_edges)
    seed = env.seed
    return COO(row=seed.row, col=seed.col,
               data=seed.data * keep.to(seed.data.dtype), shape=seed.shape)

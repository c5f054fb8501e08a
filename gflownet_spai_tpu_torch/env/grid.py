"""Toy 2-D grid environment, the GFlowNet sanity check (counterpart of
``gflownet_spai_tpu/env/grid.py``; reference grid.py:5-34).

Actions are {down, right, terminate} on integer cell indices; the reward
has known modes on ring bands around the centre, so a sampler and loss that
train correctly show it in seconds.  Every function takes a tensor of cell
indices of any shape (a batch of states)."""

from __future__ import annotations

import dataclasses

import torch

DOWN, RIGHT, TERMINATE = 0, 1, 2
NUM_ACTIONS = 3


@dataclasses.dataclass(frozen=True)
class GridEnv:
    size: int

    @property
    def state_dim(self) -> int:
        return self.size * self.size

    @property
    def num_actions(self) -> int:
        return NUM_ACTIONS


def update(env: GridEnv, idx: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Cell index after an action (TERMINATE keeps the cell)."""
    idx = torch.where(action == DOWN, idx + env.size, idx)
    return torch.where(action == RIGHT, idx + 1, idx)


def mask(env: GridEnv, idx: torch.Tensor) -> torch.Tensor:
    """Legal-action mask [..., 3]: no RIGHT on the right edge, no DOWN on
    the bottom edge; TERMINATE always legal."""
    one = idx + 1
    right_edge = (one > 0) & (one % env.size == 0)
    bottom_edge = one > env.size * (env.size - 1)
    return torch.stack([~bottom_edge, ~right_edge, torch.ones_like(right_edge)], dim=-1)


def reward(env: GridEnv, idx: torch.Tensor) -> torch.Tensor:
    """Banded reward R0 + R1·[ring 1] + R2·[ring 2], float32."""
    coord = torch.stack([idx // env.size, idx % env.size], dim=-1)
    R0, R1, R2 = 1e-2, 0.5, 2.0
    norm = torch.abs(coord.double() / (env.size - 1) - 0.5)
    r1 = torch.prod((0.25 < norm).float(), dim=-1)
    r2 = torch.prod(((0.3 < norm) & (norm < 0.4)).float(), dim=-1)
    return R0 + R1 * r1 + R2 * r2

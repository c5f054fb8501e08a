"""The SPAI preconditioner environments (the pair / row-block env and the
DIA env, ``spai_dia``), their ILU seed patterns and the toy grid env."""

from . import grid, spai_dia
from .ilu import ilu0, seed_pattern, spilu_lu
from .spai import (SpaiEnv, batched_rewards, evaluate_preconditioner,
                   keep_mask_from_actions, make_env, masked_values, matrix_flops,
                   residual_norm, resolve_baseline, reward, reward_from_actions,
                   rewards_from_keep)

__all__ = [
    "ilu0", "seed_pattern", "spilu_lu", "SpaiEnv", "batched_rewards",
    "evaluate_preconditioner", "keep_mask_from_actions", "make_env",
    "masked_values", "matrix_flops", "residual_norm", "resolve_baseline",
    "reward", "reward_from_actions", "rewards_from_keep", "grid", "spai_dia",
]

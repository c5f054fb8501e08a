"""The SPAI preconditioner environment and its ILU seed patterns."""

from .ilu import ilu0, seed_pattern, spilu_lu
from .spai import (SpaiEnv, batched_rewards, keep_mask_from_actions, make_env,
                   resolve_baseline, rewards_from_keep)

__all__ = [
    "ilu0", "seed_pattern", "spilu_lu", "SpaiEnv", "batched_rewards",
    "keep_mask_from_actions", "make_env", "resolve_baseline",
    "rewards_from_keep",
]

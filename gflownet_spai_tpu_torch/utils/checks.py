"""Invariant checks (counterpart of ``gflownet_spai_tpu/utils/checks.py``
:25-50): the reference's manual checks (SURVEY.md §4) as validators."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..sparse.types import to_numpy


def find_duplicate_actions(actions, ignore_value: int = -1) -> List[Tuple[int, int]]:
    """[(sample, action)] for any action appearing more than once in a
    trajectory.  ``actions``: [B, T] with padding = ``ignore_value``."""
    a = to_numpy(actions)
    dups = []
    for b in range(a.shape[0]):
        traj = a[b][a[b] != ignore_value]
        vals, counts = np.unique(traj, return_counts=True)
        dups.extend((b, int(v)) for v in vals[counts > 1])
    return dups


def check_rollout_invariants(rollout, terminal_action: int) -> None:
    """Asserts the masking/padding invariants of a Rollout (host-side)."""
    a = to_numpy(rollout.actions)
    lp = to_numpy(rollout.fwd_logprobs)
    lens = to_numpy(rollout.lengths)
    assert not find_duplicate_actions(a), "repeated action in a trajectory"
    for b in range(a.shape[0]):
        k = lens[b]
        assert a[b, k - 1] == terminal_action, f"sample {b}: no terminal at end"
        assert (a[b, k:] == -1).all(), f"sample {b}: non-pad after terminal"
        assert (lp[b, k:] == 0.0).all(), f"sample {b}: nonzero pad log-prob"
        assert np.all(lp[b, :k] <= 1e-7), f"sample {b}: positive log-prob"

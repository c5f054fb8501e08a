"""Invariant checks and NaN screens (counterpart of
``gflownet_spai_tpu/utils/checks.py``):

* ``find_duplicate_actions``   — no action repeats within a trajectory;
* ``check_rollout_invariants`` — padding after the terminal action, the
  terminal present, forward log-probs 0 on padding;
* ``finite_or_skip``           — the NaN/Inf loss guard as a combinator,
  with no host sync;
* ``checkify_nan_screen``      — a wrapper that raises at the first
  operation giving a NaN or an inf (a debugging tool).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

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


def finite_or_skip(loss: torch.Tensor, grads):
    """(loss, grads) → (grads zeroed where the loss is not finite, skipped
    flag): a zero update on a non-finite loss, decided on the device (no
    host sync).  ``grads`` is a tensor or a pytree of tensors."""
    good = torch.isfinite(loss)
    grads = tree_map(lambda g: torch.where(good, g, torch.zeros_like(g))
                     if isinstance(g, torch.Tensor) else g, grads)
    return grads, ~good


class _NanScreen(TorchFunctionMode):
    """Checks every floating-point tensor that a torch operation returns."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(func, '__name__', func)} produced a NaN or an inf")
        return out


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def checkify_nan_screen(fn: Callable) -> Callable:
    """Wrap ``fn`` so that it raises ``FloatingPointError`` at the first
    torch operation inside it that gives a floating-point tensor holding a
    NaN or an inf.  Every checked output costs a host sync: a debugging
    tool, not for the hot path."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NanScreen():
            return fn(*args, **kwargs)

    return wrapper

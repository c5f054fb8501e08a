"""Utilities: invariant checks and post-hoc reporting.  The profiling
helpers come with the multi-device slice."""

from .checks import check_rollout_invariants, find_duplicate_actions
from .reporting import render_training_report, trend_summary

__all__ = ["check_rollout_invariants", "find_duplicate_actions",
           "render_training_report", "trend_summary"]

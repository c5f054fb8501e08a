"""Utilities: profiling and tracing, invariant checks and NaN screens,
post-hoc reporting."""

from .checks import (check_rollout_invariants, checkify_nan_screen,
                     find_duplicate_actions, finite_or_skip)
from .profiling import (log_memory_usage, malloc_usage, profiler_trace,
                        roofline_report, timed)
from .reporting import render_training_report, trend_summary

__all__ = [
    "log_memory_usage", "malloc_usage", "profiler_trace", "roofline_report",
    "timed",
    "check_rollout_invariants", "checkify_nan_screen",
    "find_duplicate_actions", "finite_or_skip",
    "render_training_report", "trend_summary",
]

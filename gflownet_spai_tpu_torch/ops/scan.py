"""Suffix log-sum-exp (counterpart of ``gflownet_spai_tpu/ops/scan.py:75-90``,
forward only: the analytic adjoint comes with the training slice)."""

from __future__ import annotations

import torch


def suffix_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """s_t = logsumexp(x[t:]) along the last axis."""
    return torch.logcumsumexp(x.flip(-1), dim=-1).flip(-1)

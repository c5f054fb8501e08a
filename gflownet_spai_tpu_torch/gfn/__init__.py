"""GFlowNet core: the Gumbel-top-k rollout and the sampler."""

from .gflownet import (GFlowNetConfig, GFlowNetParams, SampleOut, init_params,
                       sample)
from .rollout import (Rollout, gumbel_topk_rollout, sequential_logprobs,
                      trajectory_logprobs)

__all__ = [
    "GFlowNetConfig", "GFlowNetParams", "SampleOut", "init_params", "sample",
    "Rollout", "gumbel_topk_rollout", "sequential_logprobs",
    "trajectory_logprobs",
]

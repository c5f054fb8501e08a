"""GFlowNet core: the Gumbel-top-k rollout, the sampler, the losses and the
replay buffer."""

from .gflownet import (GFlowNetConfig, GFlowNetParams, SampleOut,
                       backward_logprobs, init_params, loss_fn, sample)
from .loss import (log_reward, subtb_loss, trajectory_balance_loss,
                   vargrad_loss)
from .replay import (ReplayBuffer, replay_init, replay_resize, replay_sample,
                     replay_update)
from .rollout import (Rollout, gumbel_topk_rollout, scan_rollout,
                      sequential_logprobs, trajectory_logprobs)

__all__ = [
    "GFlowNetConfig", "GFlowNetParams", "SampleOut", "backward_logprobs",
    "init_params", "loss_fn", "sample", "log_reward", "subtb_loss",
    "trajectory_balance_loss", "vargrad_loss", "ReplayBuffer", "replay_init",
    "replay_resize", "replay_sample", "replay_update", "Rollout",
    "gumbel_topk_rollout", "scan_rollout", "sequential_logprobs", "trajectory_logprobs",
]

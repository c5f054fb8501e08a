"""Policy models: the GATv2 forward policy, the backward policies (LSTM,
uniform, linear) and the SubTB flow head."""

from .gat import GATv2Params, gatv2_apply, gatv2_apply_tiled, gatv2_init
from .policies import (BackwardPolicyParams, FlowHeadParams,
                       ForwardPolicyParams, GraphInputs, LinearBackwardParams,
                       TiledGraphInputs, backward_policy_batch,
                       flow_head_logF, forward_policy_alpha,
                       forward_policy_init, forward_policy_logits,
                       graph_from_seed, linear_backward_batch,
                       tiled_graph_from_seed, uniform_backward_logprobs)

__all__ = [
    "GATv2Params", "gatv2_apply", "gatv2_apply_tiled", "gatv2_init",
    "ForwardPolicyParams", "GraphInputs", "TiledGraphInputs",
    "forward_policy_alpha", "forward_policy_init", "forward_policy_logits",
    "graph_from_seed", "tiled_graph_from_seed", "BackwardPolicyParams",
    "FlowHeadParams", "LinearBackwardParams", "backward_policy_batch",
    "flow_head_logF", "linear_backward_batch", "uniform_backward_logprobs",
]

"""Policy models: the GATv2 forward policy and the parameter containers of
the backward policies and flow head."""

from .gat import GATv2Params, gatv2_apply, gatv2_apply_tiled, gatv2_init
from .policies import (ForwardPolicyParams, GraphInputs, TiledGraphInputs,
                       forward_policy_alpha, forward_policy_init,
                       forward_policy_logits, graph_from_seed,
                       tiled_graph_from_seed)

__all__ = [
    "GATv2Params", "gatv2_apply", "gatv2_apply_tiled", "gatv2_init",
    "ForwardPolicyParams", "GraphInputs", "TiledGraphInputs",
    "forward_policy_alpha", "forward_policy_init", "forward_policy_logits",
    "graph_from_seed", "tiled_graph_from_seed",
]

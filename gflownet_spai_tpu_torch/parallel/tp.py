"""Action-head (logit) sharding over the ``rows`` axis (counterpart of
``gflownet_spai_tpu/parallel/tp.py``).

The forward policy's only large tensor is the action head
``fc_w: [hidden, max_num_actions]``.  The GATv2 trunk and mean pool are
small and replicated; each ``rows`` rank holds a column slice of the
(padded) head and computes its slice of the logits.
"""

from __future__ import annotations

import torch

from ..models import policies as pol
from .mesh import Mesh, all_gather


def pad_head(p: pol.ForwardPolicyParams, n_shards: int) -> pol.ForwardPolicyParams:
    """Pad the head's action dim with zeros to a multiple of the shard
    count (padded logits are cut off by ``num_actions`` downstream)."""
    A = p.fc_w.shape[1]
    pad = -(-A // n_shards) * n_shards - A
    if pad == 0:
        return p
    return p._replace(fc_w=torch.nn.functional.pad(p.fc_w, (0, pad)),
                      fc_b=torch.nn.functional.pad(p.fc_b, (0, pad)))


def head_slice(p: pol.ForwardPolicyParams, n_shards: int,
               index: int) -> pol.ForwardPolicyParams:
    """Rank ``index``'s column slice of the padded head."""
    p = pad_head(p, n_shards)
    a_loc = p.fc_w.shape[1] // n_shards
    cols = slice(index * a_loc, (index + 1) * a_loc)
    return p._replace(fc_w=p.fc_w[:, cols].contiguous(),
                      fc_b=p.fc_b[cols].contiguous())


def shard_head(mesh: Mesh, p: pol.ForwardPolicyParams,
               axis: str = "rows") -> pol.ForwardPolicyParams:
    """This rank's forward parameters: the trunk as given (replicated), the
    head padded and cut to the rank's column slice."""
    return head_slice(p, mesh.size(axis), mesh.index(axis))


def sharded_policy_logits(mesh: Mesh, p: pol.ForwardPolicyParams, g,
                          num_actions: int, hidden_dim: int, heads: int = 4,
                          axis: str = "rows") -> torch.Tensor:
    """Action logits [num_actions] (on every rank) with the head matmul
    sharded over ``axis``: ``p`` carries the rank's column slice
    (``shard_head``).  Matches ``forward_policy_logits`` without the
    value-aware channel."""
    pooled = pol.forward_policy_pooled(p, g, hidden_dim, heads)
    local = pooled @ p.fc_w + p.fc_b
    return all_gather(mesh, local, axis, tiled=True)[:num_actions]

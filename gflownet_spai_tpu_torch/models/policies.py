"""Forward (GATv2) policy, backward policies and the flow head
(counterpart of ``gflownet_spai_tpu/models/policies.py``).

Forward policy: GATv2(1 → hidden, 4 heads, edge_dim = 1) → ReLU →
GATv2(4·hidden → hidden, 1 head) → ReLU → mean pool over the 2n nodes →
Linear(hidden → max_num_actions) → the live nnz + 1 logits.  The policy
returns logits; everything downstream stays in log space.

Backward policies (``policies.py:302-438`` in JAX): the reference-parity
LSTM (``nn.LSTM`` through ``torch.func.functional_call`` on the params
tree), the closed-form uniform-parent policy and the gated linear
recurrence on ``ops.scan.linear_scan``; and the SubTB flow head.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .gat import (GatBucket, GATv2Params, gatv2_apply, gatv2_apply_tiled,
                  gatv2_init)


class ForwardPolicyParams(NamedTuple):
    gat1: GATv2Params
    gat2: GATv2Params
    fc_w: torch.Tensor     # [hidden, max_num_actions]
    fc_b: torch.Tensor     # [max_num_actions]
    alpha: torch.Tensor    # learned reward-mix scalar, init 0
    feat_w: torch.Tensor | None = None   # [F] value-aware logit channel


class GraphInputs(NamedTuple):
    """Static seed graph: all-ones node features over 2n nodes, edges =
    seed nonzeros, edge features = seed values."""
    x: torch.Tensor          # [2n, 1]
    edge_src: torch.Tensor   # int64[nnz]
    edge_dst: torch.Tensor   # int64[nnz]
    edge_attr: torch.Tensor  # [nnz, 1]
    action_feats: torch.Tensor | None = None   # [nnz+1, F]


class TiledGraphInputs(NamedTuple):
    """The static graph in the node-tile layout: per-edge arrays
    pre-permuted into [T·S] slot order with self-loops and their
    mean-filled edge features appended."""
    x: torch.Tensor          # [1, 1]: uniform node features
    src_t: torch.Tensor      # int32[T·S]
    dst_t: torch.Tensor      # int32[T·S]
    attr_t: torch.Tensor     # [T·S, 1]
    tiles: object            # ops.segment.SegTiles
    srcwin: object = None    # ops.segment.SrcWindows
    action_feats: torch.Tensor | None = None
    gat_buckets: tuple | None = None   # tuple[GatBucket]


def action_features(seed) -> torch.Tensor:
    """[nnz+1, 1] static per-action features: log(|v| / geomean|v|) of each
    edge, 0 for the terminal action."""
    logv = torch.log(torch.abs(seed.data) + 1e-30)
    f = logv - torch.mean(logv)
    return torch.cat([f, f.new_zeros(1)])[:, None]


def graph_from_seed(seed, device=None) -> GraphInputs:
    """``seed``: COO (numpy or tensors) → the per-edge graph on ``device``."""
    device = resolve_device(device)
    s = seed.to(device)
    return GraphInputs(
        x=torch.ones((2 * seed.shape[0], 1), dtype=s.data.dtype, device=device),
        edge_src=s.row, edge_dst=s.col, edge_attr=s.data[:, None],
        action_feats=action_features(s),
    )


def tiled_graph_from_seed(seed, tile_nodes: int = 128,
                          bucket_step: float | None = 1.5,
                          device=None) -> TiledGraphInputs:
    """Host-side build of the tile-layout graph (self-loops with the mean
    edge feature appended, as GATv2Conv's ``fill_value='mean'``), moved to
    ``device``."""
    from ..ops.segment import (build_seg_buckets, build_seg_tiles,
                               build_src_windows, to_tiles)

    device = resolve_device(device)
    h = seed.numpy()
    n2 = 2 * seed.shape[0]
    loops = np.arange(n2, dtype=np.int64)
    src = torch.as_tensor(np.concatenate([h.row.astype(np.int64), loops]))
    dst = np.concatenate([h.col.astype(np.int64), loops])
    data = torch.as_tensor(h.data)
    attr = torch.cat([data, torch.full((n2,), float(torch.mean(data)),
                                       dtype=data.dtype)])
    host = torch.device("cpu")
    tiles = build_seg_tiles(dst, n2, tile_nodes=tile_nodes, device=host)
    src_t = to_tiles(tiles, src)
    gat_buckets = None
    if bucket_step is not None:
        sb = build_seg_buckets(dst, n2, tile_nodes=tile_nodes,
                               class_step=bucket_step, device=host)
        bks = []
        for tb, idx in zip(sb.tiles, sb.tile_idx):
            src_b = to_tiles(tb, src)
            bks.append(GatBucket(
                tiles=tb.to(device), tile_idx=idx.to(device),
                src_t=src_b.to(torch.int32).to(device),
                attr_t=to_tiles(tb, attr)[:, None].to(device),
                srcwin=build_src_windows(tb, src_b, n2, device=device)))
        gat_buckets = tuple(bks)
    return TiledGraphInputs(
        x=torch.ones((1, 1), dtype=data.dtype, device=device),
        src_t=src_t.to(torch.int32).to(device),
        dst_t=to_tiles(tiles, torch.as_tensor(dst)).to(torch.int32).to(device),
        attr_t=to_tiles(tiles, attr)[:, None].to(device),
        tiles=tiles.to(device),
        srcwin=build_src_windows(tiles, src_t, n2, device=device),
        action_feats=action_features(seed.to(device)),
        gat_buckets=gat_buckets,
    )


def forward_policy_init(gen: torch.Generator, hidden_dim: int,
                        max_num_actions: int, node_features: int = 1,
                        heads: int = 4, dtype=torch.float32,
                        terminal_bias: float = 0.0,
                        edge_feats: bool = False) -> ForwardPolicyParams:
    """``terminal_bias`` raises the terminal action's initial logit (a
    start-short curriculum for huge action spaces)."""
    lim = (1.0 / hidden_dim) ** 0.5
    fc_b = torch.zeros(max_num_actions, dtype=dtype)
    if terminal_bias:
        fc_b[max_num_actions - 1] = terminal_bias
    gat1 = gatv2_init(gen, node_features, hidden_dim, heads, dtype=dtype)
    gat2 = gatv2_init(gen, heads * hidden_dim, hidden_dim, 1, dtype=dtype)
    fc_w = (torch.rand((hidden_dim, max_num_actions), generator=gen,
                       dtype=dtype) * 2.0 - 1.0) * lim
    return ForwardPolicyParams(
        gat1=gat1, gat2=gat2, fc_w=fc_w, fc_b=fc_b,
        alpha=torch.zeros((), dtype=dtype),
        feat_w=torch.zeros(1, dtype=dtype) if edge_feats else None,
    )


def forward_policy_pooled(p: ForwardPolicyParams, g, hidden_dim: int,
                          heads: int = 4) -> torch.Tensor:
    """GATv2 ×2 + global mean pool → the [hidden] graph embedding.
    ``TiledGraphInputs`` ride the tile kernels; ``GraphInputs`` the
    per-edge scatter path."""
    if isinstance(g, TiledGraphInputs):
        n_nodes = g.tiles.num_nodes
        kw = dict(srcwin=g.srcwin, buckets=g.gat_buckets)
        h = gatv2_apply_tiled(p.gat1, g.x, g.tiles, g.src_t, g.dst_t, g.attr_t,
                              n_nodes, heads, hidden_dim, **kw)
        h = torch.relu(h)
        h = gatv2_apply_tiled(p.gat2, h, g.tiles, g.src_t, g.dst_t, g.attr_t,
                              n_nodes, 1, hidden_dim, **kw)
    else:
        n_nodes = g.x.shape[0]
        h = gatv2_apply(p.gat1, g.x, g.edge_src, g.edge_dst, g.edge_attr,
                        n_nodes, heads, hidden_dim)
        h = torch.relu(h)
        h = gatv2_apply(p.gat2, h, g.edge_src, g.edge_dst, g.edge_attr,
                        n_nodes, 1, hidden_dim)
    return torch.relu(h).mean(dim=0)


def forward_policy_logits(p: ForwardPolicyParams, g, num_actions: int,
                          hidden_dim: int, heads: int = 4) -> torch.Tensor:
    """Action logits [num_actions] for the static seed graph (one forward
    per rollout: the graph never changes, only the taken-action mask)."""
    pooled = forward_policy_pooled(p, g, hidden_dim, heads)
    logits = (pooled @ p.fc_w + p.fc_b)[:num_actions]
    if p.feat_w is not None and g.action_feats is not None:
        logits = logits + g.action_feats[:num_actions] @ p.feat_w
    return logits


def forward_policy_alpha(p: ForwardPolicyParams) -> torch.Tensor:
    return torch.sigmoid(p.alpha)


# ---------------------------------------------------------------------------
# Flow head (SubTB-λ) and backward policies
# ---------------------------------------------------------------------------

class FlowHeadParams(NamedTuple):
    """log F(s_t) = w · [1, t̂, t̂², t̂³] + Σ_{u≤t} d[a_u] (SubTB-λ only)."""
    poly_w: torch.Tensor   # [4]
    edge_d: torch.Tensor   # [max_num_actions]


def flow_head_init(max_num_actions: int, dtype=torch.float32) -> FlowHeadParams:
    return FlowHeadParams(poly_w=torch.zeros(4, dtype=dtype),
                          edge_d=torch.zeros(max_num_actions, dtype=dtype))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` through ``index_select``, whose backward is an
    ``index_add_``.  Advanced indexing's backward sorts the indices and
    serialises on repeats, and the −1-padded action lists clamp every
    padding slot to row 0 (most of a [B, t_cap] batch)."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def flow_head_logF(p: FlowHeadParams, actions: torch.Tensor) -> torch.Tensor:
    """[B, T] ``-1``-padded actions → [B, T+1] log F(s_t), t = 0..T, with
    t̂ = t/T."""
    B, T = actions.shape
    w = p.poly_w
    t_hat = (torch.arange(T + 1, dtype=w.dtype, device=w.device) / T)[None, :]
    base = w[0] + w[1] * t_hat + w[2] * t_hat ** 2 + w[3] * t_hat ** 3
    valid = actions >= 0
    d = torch.where(valid, take_rows(p.edge_d, torch.clamp_min(actions, 0)), 0.0)
    cum = torch.cat([d.new_zeros((B, 1)), torch.cumsum(d, dim=-1)], dim=-1)
    return base + cum


def _masked_log_softmax(logits: torch.Tensor, n_valid: torch.Tensor,
                        T: int) -> torch.Tensor:
    """log-softmax of ``logits[..., :T]`` over the first ``n_valid`` entries
    of each row, read at every step; 0 past ``n_valid``."""
    keep = torch.arange(T, device=logits.device) < n_valid[..., None]
    masked = torch.where(keep, logits[..., :T], float("-inf"))
    return torch.where(keep, torch.log_softmax(masked, dim=-1), 0.0)

class BackwardPolicyParams(NamedTuple):
    """LSTM backward policy (reference parity)."""
    w_ih: torch.Tensor   # [input_dim, 4*hidden]
    w_hh: torch.Tensor   # [hidden, 4*hidden]
    b: torch.Tensor      # [4*hidden]
    fc_w: torch.Tensor   # [hidden, max_num_actions]
    fc_b: torch.Tensor   # [max_num_actions]


def _uniform(gen, shape, lim, dtype):
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * lim


def _lstm_module(p: BackwardPolicyParams) -> tuple:
    """An ``nn.LSTM`` shell and its weights in PyTorch's layout: gates in
    (i, f, g, o) order as the JAX split, ``weight_ih_l0 = w_ihᵀ``,
    ``weight_hh_l0 = w_hhᵀ``, ``bias_ih_l0 = b``, ``bias_hh_l0 = 0``."""
    hidden = p.w_hh.shape[0]
    lstm = torch.nn.LSTM(p.w_ih.shape[0], hidden, batch_first=True,
                         device="meta", dtype=p.w_ih.dtype)
    weights = {"weight_ih_l0": p.w_ih.T, "weight_hh_l0": p.w_hh.T,
               "bias_ih_l0": p.b, "bias_hh_l0": torch.zeros_like(p.b)}
    return lstm, weights


def backward_policy_batch(p: BackwardPolicyParams, actions: torch.Tensor,
                          hidden_dim: int) -> torch.Tensor:
    """[B, T] ``-1``-padded actions → [B, T] per-step log P_B of the LSTM
    backward policy (reference parity); padding contributes 0.

    The LSTM reads the raw action ids as scalars over the whole padded
    sequence; padding is trailing, so the state after the last valid step
    is the output at ``n_valid − 1`` (zeros when nothing is valid), which
    equals the JAX scan's carry frozen on padding."""
    B, T = actions.shape
    valid = actions >= 0
    n_valid = valid.sum(-1)
    lstm, weights = _lstm_module(p)
    xs = actions.to(p.w_ih.dtype)[..., None]
    cudnn = torch.backends.cudnn
    # PyTorch's own LSTM, not cuDNN's: cuDNN packs the weights into one
    # buffer in place, which fails on these views of the parameters, and
    # would run in TF32 by default; the native path multiplies in float32
    with cudnn.flags(enabled=False, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out, _ = torch.func.functional_call(lstm, weights, (xs,))
    last = torch.clamp_min(n_valid - 1, 0)
    h_last = out[torch.arange(B, device=out.device), last]
    h_last = torch.where((n_valid > 0)[:, None], h_last, 0.0)
    logits = h_last @ p.fc_w + p.fc_b
    return _masked_log_softmax(logits, n_valid, T)


def backward_policy_logprobs(p: BackwardPolicyParams, actions: torch.Tensor,
                             hidden_dim: int) -> torch.Tensor:
    """One trajectory: [T] actions → [T] log P_B (``backward_policy_batch``)."""
    return backward_policy_batch(p, actions[None], hidden_dim)[0]


def uniform_backward_logprobs(actions: torch.Tensor,
                              terminal_action: int) -> torch.Tensor:
    """[B, T] actions → [B, T] log P_B of the uniform-parent policy: −log t
    at the t-th deletion, 0 on the terminal step and on padding."""
    deletion = (actions >= 0) & (actions != terminal_action)
    t_idx = torch.cumsum(deletion.to(torch.int32), dim=-1)
    return torch.where(deletion, -torch.log(t_idx.to(torch.float32)), 0.0)


def backward_policy_init(gen: torch.Generator, hidden_dim: int,
                         max_num_actions: int, input_dim: int = 1,
                         dtype=torch.float32) -> BackwardPolicyParams:
    lim = (1.0 / hidden_dim) ** 0.5
    return BackwardPolicyParams(
        w_ih=_uniform(gen, (input_dim, 4 * hidden_dim), lim, dtype),
        w_hh=_uniform(gen, (hidden_dim, 4 * hidden_dim), lim, dtype),
        b=torch.zeros(4 * hidden_dim, dtype=dtype),
        fc_w=_uniform(gen, (hidden_dim, max_num_actions), lim, dtype),
        fc_b=torch.zeros(max_num_actions, dtype=dtype),
    )


class LinearBackwardParams(NamedTuple):
    """Gated linear-recurrence backward policy."""
    emb_g: torch.Tensor   # [max_num_actions] per-action gate pre-activation
    emb_v: torch.Tensor   # [max_num_actions, hidden]
    fc_w: torch.Tensor    # [hidden, max_num_actions]
    fc_b: torch.Tensor    # [max_num_actions]


def linear_backward_init(gen: torch.Generator, hidden_dim: int,
                         max_num_actions: int,
                         dtype=torch.float32) -> LinearBackwardParams:
    lim = (1.0 / hidden_dim) ** 0.5
    return LinearBackwardParams(
        emb_g=torch.ones(max_num_actions, dtype=dtype),
        emb_v=_uniform(gen, (max_num_actions, hidden_dim), lim, dtype),
        fc_w=_uniform(gen, (hidden_dim, max_num_actions), lim, dtype),
        fc_b=torch.zeros(max_num_actions, dtype=dtype),
    )


def linear_backward_batch(p: LinearBackwardParams,
                          actions: torch.Tensor) -> torch.Tensor:
    """[B, T] ``-1``-padded actions → [B, T] log P_B of the gated linear
    recurrence h_t = a_t·h_{t−1} + b_t, a_t = σ(emb_g[act_t]) (1 on
    padding, so the carry freezes), b_t = (1 − a_t)·emb_v[act_t] (0 on
    padding), read out at the last step (``ops.scan.linear_scan``)."""
    from ..ops.scan import linear_scan

    T = actions.shape[-1]
    valid = actions >= 0
    idx = torch.clamp_min(actions, 0)
    a = torch.where(valid, torch.sigmoid(take_rows(p.emb_g, idx)), 1.0)[..., None]
    b = torch.where(valid[..., None], (1.0 - a) * take_rows(p.emb_v, idx), 0.0)
    h = linear_scan(a, b, axis=-2)
    logits = h[..., -1, :] @ p.fc_w + p.fc_b
    return _masked_log_softmax(logits, valid.sum(-1), T)


def linear_backward_logprobs(p: LinearBackwardParams,
                             actions: torch.Tensor) -> torch.Tensor:
    """One trajectory: [T] actions → [T] log P_B (``linear_backward_batch``)."""
    return linear_backward_batch(p, actions[None])[0]

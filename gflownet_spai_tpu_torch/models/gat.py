"""GATv2 layers (counterpart of ``gflownet_spai_tpu/models/gat.py:29-201``).

``score = aᵀ · LeakyReLU(W_s x_j + W_t x_i + W_e e_ij)``, multi-head with
concatenation, self-loops with mean-filled edge features, bias on the
output.  Two substrates with the same semantics:

* ``gatv2_apply``       — per-edge tensors with ``scatter_reduce`` /
  ``index_add_`` segment ops (small graphs, and the plain reference);
* ``gatv2_apply_tiled`` — the node-tile layout (``ops.segment``) with the
  fused tile kernel K1 and, for non-uniform layers, the windowed gather K3.

Parameters keep the JAX layout (``w_src`` is [in, H·out], and so on).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.gat_fused import gat_tile_fused
from ..ops.segment import gather_rows_windows


class GATv2Params(NamedTuple):
    w_src: torch.Tensor   # [in, H*out]   source transform (PyG lin_l)
    w_dst: torch.Tensor   # [in, H*out]   target transform (PyG lin_r)
    w_edge: torch.Tensor  # [edge_dim, H*out]
    b_src: torch.Tensor   # [H*out]
    att: torch.Tensor     # [H, out]
    bias: torch.Tensor    # [H*out] if concat else [out]


class GatBucket(NamedTuple):
    """One slot-width class of the bucketed layout: ``tiles`` (SegTiles
    over T_b tiles at width S_b), ``tile_idx`` (bucket tile → global tile)
    and the bucket's slot-ordered ``src_t``, ``attr_t`` and window plan."""
    tiles: object
    tile_idx: torch.Tensor
    src_t: torch.Tensor
    attr_t: torch.Tensor
    srcwin: object


def _glorot(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    lim = (6.0 / (shape[0] + shape[-1])) ** 0.5
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * lim


def gatv2_init(gen: torch.Generator, in_dim: int, out_dim: int, heads: int,
               edge_dim: int = 1, concat: bool = True,
               dtype=torch.float32) -> GATv2Params:
    """Glorot-uniform weights, zero biases (drawn from a CPU generator)."""
    return GATv2Params(
        w_src=_glorot(gen, (in_dim, heads * out_dim), dtype),
        w_dst=_glorot(gen, (in_dim, heads * out_dim), dtype),
        w_edge=_glorot(gen, (edge_dim, heads * out_dim), dtype),
        b_src=torch.zeros(heads * out_dim, dtype=dtype),
        att=_glorot(gen, (heads, out_dim), dtype),
        bias=torch.zeros(heads * out_dim if concat else out_dim, dtype=dtype),
    )


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over variable-size segments: ``scores`` [E, H], ids [E]."""
    idx = segment_ids[:, None].expand_as(scores)
    seg_max = scores.new_full((num_segments, scores.shape[1]), float("-inf"))
    seg_max = seg_max.scatter_reduce(0, idx, scores, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(scores - seg_max[segment_ids])
    denom = ex.new_zeros(seg_max.shape).index_add_(0, segment_ids, ex)
    return ex / torch.clamp_min(denom[segment_ids], 1e-38)


def gatv2_apply(p: GATv2Params, x: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, edge_attr: torch.Tensor,
                num_nodes: int, heads: int, out_dim: int,
                concat: bool = True, negative_slope: float = 0.2,
                add_self_loops: bool = True) -> torch.Tensor:
    """One GATv2 layer on per-edge tensors.  ``x``: [N, in]; edges COO
    (src → dst); ``edge_attr``: [E, edge_dim].  Returns [N, H·out]
    (concat) or [N, out]."""
    H, D = heads, out_dim
    xs = x @ p.w_src + p.b_src
    xd = x @ p.w_dst
    ea = edge_attr @ p.w_edge
    edge_src, edge_dst = edge_src.long(), edge_dst.long()
    if add_self_loops:
        loop_idx = torch.arange(num_nodes, device=x.device)
        edge_src = torch.cat([edge_src, loop_idx])
        edge_dst = torch.cat([edge_dst, loop_idx])
        mean_ea = ea.mean(dim=0, keepdim=True)   # PyG fill_value='mean'
        ea = torch.cat([ea, mean_ea.expand(num_nodes, H * D)])
    src_feat = xs[edge_src]
    msg = (src_feat + xd[edge_dst] + ea).reshape(-1, H, D)
    act = torch.nn.functional.leaky_relu(msg, negative_slope)
    scores = torch.einsum("ehd,hd->eh", act, p.att)
    alpha = segment_softmax(scores, edge_dst, num_nodes)
    weighted = src_feat.reshape(-1, H, D) * alpha[..., None]
    out = weighted.new_zeros((num_nodes, H, D)).index_add_(0, edge_dst, weighted)
    out = out.reshape(num_nodes, H * D) if concat else out.mean(dim=1)
    return out + p.bias


def gatv2_apply_tiled(p: GATv2Params, x: torch.Tensor, tiles, src_t, dst_t,
                      attr_t: torch.Tensor, num_nodes: int, heads: int,
                      out_dim: int, concat: bool = True,
                      negative_slope: float = 0.2, srcwin=None,
                      buckets=None) -> torch.Tensor:
    """``gatv2_apply`` on the node-tile layout: per-edge arrays arrive
    pre-permuted into [T·S] slot order with self-loops appended
    (``models.policies.tiled_graph_from_seed``).  ``x.shape[0] == 1``
    declares uniform node features (layer 1 of the policy): xs/xd are one
    broadcast row each.  Non-uniform source rows are gathered by K3 through
    the window plan, which such layers must be given (``srcwin``, or each
    bucket's).  Each bucket (or the single layout) is one K1 launch."""
    if p.w_edge.shape[0] != 1:
        raise NotImplementedError(
            "gatv2_apply_tiled with edge_dim != 1 needs the unfused segment "
            "kernels K5-K7, which a later slice of the port brings")
    H, D = heads, out_dim
    HD = H * D
    T = tiles.tiles
    uniform = x.shape[0] == 1
    xs = x @ p.w_src + p.b_src                     # [N or 1, H*D]
    xd = x @ p.w_dst
    w_e, att = p.w_edge[0].contiguous(), p.att.reshape(H, D).contiguous()

    def src_rows(plan, tl, s_t):
        if uniform:
            return xs
        return gather_rows_windows(plan, tl, s_t, xs)

    if not uniform and (srcwin is None if buckets is None
                        else any(bk.srcwin is None for bk in buckets)):
        raise ValueError("gatv2_apply_tiled: non-uniform node features need "
                         "the window plan (srcwin) of every layout they run "
                         "on; build it with tiled_graph_from_seed")
    if buckets is not None:
        # one fused launch per slot-width class; node blocks are stitched
        # through global tile order with one [T_b, TN, HD] gather/scatter
        TN = tiles.tile_nodes
        xd_r = None
        if not uniform:
            xd_r = torch.nn.functional.pad(
                xd, (0, 0, 0, tiles.n_pad - xd.shape[0])).reshape(T, TN, HD)
        out_r = xs.new_zeros((T, TN, HD))
        for bk in buckets:
            tb = bk.tiles
            idx = bk.tile_idx.long()
            xd_b = xd if uniform else xd_r[idx].reshape(tb.n_pad, HD)
            out_b = gat_tile_fused(tb, bk.attr_t.reshape(-1),
                                   src_rows(bk.srcwin, tb, bk.src_t), xd_b,
                                   w_e, att, negative_slope=negative_slope)
            out_r[idx] = out_b.reshape(tb.tiles, TN, HD)
        out = out_r.reshape(tiles.n_pad, HD)[:num_nodes]
    else:
        xd_in = xd if uniform else torch.nn.functional.pad(
            xd, (0, 0, 0, tiles.n_pad - xd.shape[0]))
        out = gat_tile_fused(tiles, attr_t.reshape(-1),
                             src_rows(srcwin, tiles, src_t), xd_in, w_e, att,
                             negative_slope=negative_slope)[:num_nodes]
    out = out if concat else out.reshape(num_nodes, H, D).mean(dim=1)
    return out + p.bias

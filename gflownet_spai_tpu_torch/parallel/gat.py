"""Tile-sharded GATv2 policy forward (counterpart of
``gflownet_spai_tpu/parallel/gat.py``).

The node-tile layout (``ops.segment.SegTiles``) makes tiles independent,
so the tile axis splits over ``rows``:

* layer 1 (uniform node features: the policy graph's all-ones x) runs K1
  (``ops.gat_fused.gat_tile_fused``) on the rank's tile block only;
* layer 2's source-row gather crosses tiles, so the layer-1 output is
  transformed locally (``h_loc @ w_src``: the small [n_loc, hidden] node
  tensor) and all-gathered once; K3 (``ops.segment.gather_rows_windows``)
  reads it through the rank's window plan, whose outlier list was split
  per rank on the host; then K1 again;
* the global mean pool is a masked local sum and a ``psum``.

The backward runs K2 and K4 through the same autograd Functions.  The
sharded forward takes the uniform tile layout only: the train setup builds
no ``gat_buckets`` for the sharded sampler.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.policies import ForwardPolicyParams, TiledGraphInputs
from ..ops.gat_fused import gat_tile_fused
from ..ops.segment import SegTiles, SrcWindows, gather_rows_windows
from .mesh import Mesh, all_gather, psum

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ShardedTiledGraph(NamedTuple):
    """Per-tile graph arrays padded so the tile axis splits evenly over
    ``rows``; every leading dim is T_pad (or T_pad·S, R·O), so rank j's
    block is the j-th of R equal slices (``local_shard``)."""
    x: torch.Tensor          # [1, 1] uniform node features (replicated)
    src_t: torch.Tensor      # int32[T_pad·S]
    attr_t: torch.Tensor     # [T_pad·S, 1]
    local_dst: torch.Tensor  # int32[T_pad, S]
    lsrc: torch.Tensor       # int32[T_pad, S] window-local src (2·win = miss)
    blk: torch.Tensor        # int32[T_pad]
    out_slot: torch.Tensor   # int32[R·O] shard-LOCAL flat slot ids (T_loc·S pad)
    out_src: torch.Tensor    # int32[R·O]


class ShardedGraphMeta(NamedTuple):
    tiles: int            # T_pad (global)
    slots: int
    tile_nodes: int
    num_nodes: int
    win: int
    rows_pad: int
    n_shards: int


class LocalTiledGraph(NamedTuple):
    """One rank's block: its tile layout, window plan and slot arrays."""
    x: torch.Tensor
    src_t: torch.Tensor
    attr: torch.Tensor       # [T_loc·S] edge scalars in slot order
    tiles: SegTiles
    srcwin: SrcWindows
    index: int


def shard_tiled_graph(g: TiledGraphInputs, n_shards: int):
    """Pad and re-lay a TiledGraphInputs for tile-sharded execution (on the
    host; the arrays come back on ``g``'s device).  Returns
    ``(ShardedTiledGraph, ShardedGraphMeta)``."""
    t0, sw = g.tiles, g.srcwin
    if sw is None:
        raise ValueError("shard_tiled_graph needs a srcwin plan "
                         "(tiled_graph_from_seed builds one)")
    if g.gat_buckets:
        print("shard_tiled_graph: dropping gat_buckets (sharded GAT runs "
              "the uniform tile layout)", flush=True)
    dev = g.src_t.device
    T, S, TN = t0.tiles, t0.slots, t0.tile_nodes
    T_pad = _round_up(T, n_shards)
    pad_t = T_pad - T
    np_ = lambda t: t.detach().cpu().numpy()
    ld = np_(t0.local_dst).astype(np.int32)
    src = np_(g.src_t).reshape(T, S)
    attr = np_(g.attr_t).reshape(T, S)
    lsrc = np_(sw.lsrc).astype(np.int32)
    blk = np_(sw.blk).astype(np.int32)
    if pad_t:
        # empty tiles: every slot is padding (local_dst = TN, lsrc = 2·win)
        ld = np.concatenate([ld, np.full((pad_t, S), TN, np.int32)])
        src = np.concatenate([src, np.zeros((pad_t, S), src.dtype)])
        attr = np.concatenate([attr, np.zeros((pad_t, S), attr.dtype)])
        lsrc = np.concatenate([lsrc, np.full((pad_t, S), 2 * sw.win, np.int32)])
        blk = np.concatenate([blk, np.zeros((pad_t,), np.int32)])
    # the outlier fixups by owning rank, with rank-local slot ids, every
    # rank's list padded to one common lane-rounded length
    T_loc = T_pad // n_shards
    o_slot, o_src = np_(sw.out_slot), np_(sw.out_src)
    real = o_slot < T * S
    o_slot, o_src = o_slot[real], o_src[real]
    owner = o_slot // (T_loc * S)
    per = [(o_slot[owner == s] - s * T_loc * S, o_src[owner == s])
           for s in range(n_shards)]
    o_max = _round_up(max([len(p[0]) for p in per] + [1]), _LANE)
    slot_out = np.full((n_shards, o_max), T_loc * S, np.int32)
    src_out = np.zeros((n_shards, o_max), np.int32)
    for s, (sl, sr) in enumerate(per):
        slot_out[s, :len(sl)] = sl
        src_out[s, :len(sr)] = sr
    t = lambda a: torch.as_tensor(a, device=dev)
    sg = ShardedTiledGraph(
        x=g.x, src_t=t(src.reshape(-1).astype(np.int32)),
        attr_t=t(attr.reshape(-1, 1)), local_dst=t(ld), lsrc=t(lsrc), blk=t(blk),
        out_slot=t(slot_out.reshape(-1)), out_src=t(src_out.reshape(-1)))
    meta = ShardedGraphMeta(tiles=T_pad, slots=S, tile_nodes=TN,
                            num_nodes=t0.num_nodes, win=sw.win,
                            rows_pad=sw.rows_pad, n_shards=n_shards)
    return sg, meta


def local_shard(sg: ShardedTiledGraph, meta: ShardedGraphMeta,
                index: int) -> LocalTiledGraph:
    """Rank ``index``'s block of a sharded graph, its layout and window plan
    made once (K1's run starts and K3's row plan are cached per layout)."""
    R = meta.n_shards
    T_loc, S = meta.tiles // R, meta.slots
    tl = slice(index * T_loc, (index + 1) * T_loc)
    sl = slice(index * T_loc * S, (index + 1) * T_loc * S)
    O = sg.out_slot.shape[0] // R
    ol = slice(index * O, (index + 1) * O)
    local_dst = sg.local_dst[tl].contiguous()
    tiles = SegTiles(perm=torch.zeros((0,), dtype=torch.int32, device=local_dst.device),
                     local_dst=local_dst, num_nodes=meta.num_nodes, num_edges=0,
                     tiles=T_loc, tile_nodes=meta.tile_nodes, slots=S)
    srcwin = SrcWindows(lsrc=sg.lsrc[tl].contiguous(), blk=sg.blk[tl].contiguous(),
                        out_slot=sg.out_slot[ol].contiguous(),
                        out_src=sg.out_src[ol].contiguous(),
                        win=meta.win, rows_pad=meta.rows_pad)
    return LocalTiledGraph(x=sg.x, src_t=sg.src_t[sl].contiguous(),
                           attr=sg.attr_t[sl].reshape(-1).contiguous(),
                           tiles=tiles, srcwin=srcwin, index=index)


def sharded_policy_pooled(mesh: Mesh, p: ForwardPolicyParams, g: LocalTiledGraph,
                          meta: ShardedGraphMeta, hidden_dim: int, heads: int = 4,
                          axis: str = "rows") -> torch.Tensor:
    """The [hidden] pooled policy embedding computed tile-sharded: ``g`` is
    this rank's block (``local_shard``).  Equals
    ``models.policies.forward_policy_pooled`` on the whole graph; its
    gradient follows ``mesh``'s convention (each rank's loss share, then a
    ``rows`` sum of the trunk's gradients)."""
    tiles = g.tiles
    n_loc = tiles.tiles * tiles.tile_nodes
    gid = g.index * n_loc + torch.arange(n_loc, device=g.attr.device)
    node_mask = (gid < meta.num_nodes)[:, None]

    # layer 1 (uniform x: both gathers vanish)
    H1, D1 = heads, hidden_dim
    xs1 = g.x @ p.gat1.w_src + p.gat1.b_src                  # [1, H1·D1]
    xd1 = g.x @ p.gat1.w_dst
    h = gat_tile_fused(tiles, g.attr, xs1, xd1, p.gat1.w_edge[0].contiguous(),
                       p.gat1.att.reshape(H1, D1).contiguous())   # [n_loc, H1·D1]
    h = torch.where(node_mask, torch.relu(h + p.gat1.bias), 0.0)

    # layer 2 (one head): local transform, ONE all_gather of the small node
    # features, the windowed source gather, the local fused kernel
    xs2_loc = h @ p.gat2.w_src + p.gat2.b_src                # [n_loc, D2]
    xd2_loc = h @ p.gat2.w_dst
    xs2 = all_gather(mesh, xs2_loc, axis, tiled=True)
    n_tot = xs2.shape[0]
    if meta.rows_pad > n_tot:
        xs2 = torch.nn.functional.pad(xs2, (0, 0, 0, meta.rows_pad - n_tot))
    else:
        xs2 = xs2[:meta.rows_pad]
    xs2_slot = gather_rows_windows(g.srcwin, tiles, g.src_t, xs2.contiguous())
    h2 = gat_tile_fused(tiles, g.attr, xs2_slot, xd2_loc.contiguous(),
                        p.gat2.w_edge[0].contiguous(),
                        p.gat2.att.reshape(1, hidden_dim).contiguous())
    h2 = torch.where(node_mask, torch.relu(h2 + p.gat2.bias), 0.0)

    # masked global mean pool
    return psum(mesh, torch.sum(h2, dim=0), axis) / meta.num_nodes

"""Node-tile layouts of the GAT's segment structure, the tile segment ops
and the windowed source-row gather (counterpart of
``gflownet_spai_tpu/ops/segment.py``).

The layouts are built once on the host (numpy): edges grouped by
destination node into tiles of ``TN`` consecutive nodes × ``S`` slots
(padded), optionally bucketed by slot width.  The fused GAT kernel
(``ops.gat_fused``) consumes them, and so do the unfused segment ops of
the generic GAT layer: softmax (K5), sum (K6) and node → slot broadcast
(K7), each differentiable with the JAX package's custom VJP.  The layer-2
source-row gather is K3 and its transpose K4, each one launch over every
bucket of a layer (``gather_rows_buckets``).  All five run as CUDA
kernels (``csrc/segment.cu``) on CUDA tensors; on CPU tensors each
computes its plain version (``*_ref``).  Each layout's run starts
(``layout_runs``) are derived once and cached; K1, K2, K5 and K6 read
them.  The tile ops take any local_dst, as the JAX package's onehot kernels
do: a slot whose id lies outside [0, TN) is padding.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build
from .._device import resolve_device
from ..sparse.types import to_numpy

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class SegTiles:
    """Static node-tile layout.  ``perm``: int32[T·S], edge slot → original
    edge index (padding slots point at E, one past the end).
    ``local_dst``: int32[T, S], destination node within the tile (0..TN−1);
    any other id marks a padding slot.  The builders write TN for padding
    and sort each tile's slots by ``local_dst``, padding last; the tile ops
    take any order (``layout_runs``)."""

    perm: torch.Tensor
    local_dst: torch.Tensor
    num_nodes: int
    num_edges: int = 0
    tiles: int = 0
    tile_nodes: int = 0
    slots: int = 0

    @property
    def n_pad(self) -> int:
        return self.tiles * self.tile_nodes

    def to(self, device) -> "SegTiles":
        return dataclasses.replace(self, perm=self.perm.to(device),
                                   local_dst=self.local_dst.to(device))


def _tile_bounds(ids, num_nodes: int, tile_nodes: int):
    ids = np.asarray(ids, np.int64)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    T = _round_up(max(num_nodes, 1), tile_nodes) // tile_nodes
    bounds = np.searchsorted(sorted_ids, np.arange(T + 1) * tile_nodes)
    return len(ids), order, sorted_ids, T, bounds, np.diff(bounds)


def _pack_tiles(sel, S, E, order, sorted_ids, bounds, counts, tile_nodes,
                num_nodes, device) -> SegTiles:
    perm = np.full((len(sel), S), E, np.int64)
    local = np.full((len(sel), S), tile_nodes, np.int64)
    for i, t in enumerate(sel):
        k = int(counts[t])
        perm[i, :k] = order[bounds[t]:bounds[t + 1]]
        local[i, :k] = sorted_ids[bounds[t]:bounds[t + 1]] - t * tile_nodes
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)
    return SegTiles(perm=as_t(perm.reshape(-1)), local_dst=as_t(local),
                    num_nodes=num_nodes, num_edges=E, tiles=len(sel),
                    tile_nodes=tile_nodes, slots=S)


def build_seg_tiles(ids, num_nodes: int, tile_nodes: int = 128,
                    device=None) -> SegTiles:
    """Layout from arbitrary (unsorted) segment ids [E]: ``S`` is the max
    edge count over node tiles, rounded up to 128."""
    device = resolve_device(device)
    E, order, sorted_ids, T, bounds, counts = _tile_bounds(
        ids, num_nodes, tile_nodes)
    S = _round_up(max(int(counts.max()) if T else 1, 1), _LANE)
    return _pack_tiles(range(T), S, E, order, sorted_ids, bounds, counts,
                       tile_nodes, num_nodes, device)


@dataclasses.dataclass(frozen=True)
class SegBuckets:
    """Bucketed-S layout: tiles grouped by edge count into a geometric
    ladder of slot widths.  Bucket ``b`` is a self-contained ``SegTiles``
    over its ``T_b`` tiles at width ``S_b``; ``tile_idx[b]`` maps
    bucket tile → global tile index."""

    tiles: tuple
    tile_idx: tuple

    @property
    def slot_total(self) -> int:
        return sum(t.tiles * t.slots for t in self.tiles)


def build_seg_buckets(ids, num_nodes: int, tile_nodes: int = 128,
                      class_step: float = 1.5, device=None) -> SegBuckets:
    """Bucketed layout build (same inputs as ``build_seg_tiles``).  Ladder
    classes start at 128 slots and grow by ``class_step`` (rounded to 128,
    strictly increasing)."""
    device = resolve_device(device)
    E, order, sorted_ids, T, bounds, counts = _tile_bounds(
        ids, num_nodes, tile_nodes)
    s_max = _round_up(max(int(counts.max()) if T else 1, 1), _LANE)
    ladder = [_LANE]
    while ladder[-1] < s_max:
        ladder.append(min(max(_round_up(int(ladder[-1] * class_step), _LANE),
                              ladder[-1] + _LANE), s_max))
    ladder = np.asarray(ladder, np.int64)
    need = np.maximum(_LANE, ((counts + _LANE - 1) // _LANE) * _LANE)
    cls = np.searchsorted(ladder, need)
    b_tiles, b_idx = [], []
    for c in np.unique(cls):
        sel = np.nonzero(cls == c)[0]
        b_tiles.append(_pack_tiles(sel, int(ladder[c]), E, order, sorted_ids,
                                   bounds, counts, tile_nodes,
                                   len(sel) * tile_nodes, device))
        b_idx.append(torch.as_tensor(sel, dtype=torch.int32, device=device))
    return SegBuckets(tiles=tuple(b_tiles), tile_idx=tuple(b_idx))


def to_tiles(tiles: SegTiles, vals: torch.Tensor) -> torch.Tensor:
    """[E, ...] edge array → [T·S, ...] slot layout; padding slots read an
    appended zero row."""
    ext = torch.cat([vals, vals.new_zeros((1,) + tuple(vals.shape[1:]))])
    return ext[tiles.perm.long()]


def from_tiles(tiles: SegTiles, vals_t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_tiles`` for per-edge outputs: [T·S, ...] slot
    values back to [E, ...] edge order (padding slots dropped)."""
    out = vals_t.new_zeros((tiles.num_edges + 1,) + tuple(vals_t.shape[1:]))
    out[tiles.perm.long()] = vals_t
    return out[:tiles.num_edges]


# ---------------------------------------------------------------------------
# Tile segment ops: softmax (K5), sum (K6), node → slot broadcast (K7)
# ---------------------------------------------------------------------------

def _real(tiles: SegTiles) -> torch.Tensor:
    """bool[T, S]: the slots whose id names a node of the tile, [0, TN)."""
    lid = tiles.local_dst
    return (lid >= 0) & (lid < tiles.tile_nodes)


def _slot_rows(tiles: SegTiles) -> torch.Tensor:
    """int64[T·S]: each slot's row in a per-tile layout of TN + 1 rows
    (row TN of each tile collects its padding slots, whatever their id)."""
    tn = tiles.tile_nodes
    lid = torch.where(_real(tiles), tiles.local_dst, tn).long()
    tile = torch.arange(lid.shape[0], device=lid.device)[:, None]
    return (tile * (tn + 1) + lid).reshape(-1)


def _node_rows(tiles: SegTiles, per_row: torch.Tensor) -> torch.Tensor:
    """[T·(TN + 1), ...] per-row values → [T·TN, ...] (padding rows dropped)."""
    tn = tiles.tile_nodes
    return per_row.reshape((-1, tn + 1) + tuple(per_row.shape[1:]))[:, :tn] \
        .reshape((-1,) + tuple(per_row.shape[1:]))


def segment_softmax_tiles_ref(tiles: SegTiles, scores_t: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: softmax within each node's slots of [T, S] (or
    [T, H, S], per head) scores; padding slots → 0."""
    s = scores_t[:, None] if scores_t.dim() == 2 else scores_t
    T, H, S = s.shape
    rows = _slot_rows(tiles)
    flat = s.permute(0, 2, 1).reshape(T * S, H)
    m = flat.new_full((T * (tiles.tile_nodes + 1), H), float("-inf"))
    m = m.scatter_reduce(0, rows[:, None].expand(-1, H), flat, "amax")
    ex = torch.exp(flat - m[rows])
    den = torch.zeros_like(m).index_add_(0, rows, ex)
    y = ex / torch.clamp_min(den[rows], 1e-30)
    y = torch.where(_real(tiles).reshape(-1, 1), y, 0.0).reshape(T, S, H).permute(0, 2, 1)
    return y if scores_t.dim() == 3 else y[:, 0]


def _run_sums_ref(tiles: SegTiles, v: torch.Tensor) -> torch.Tensor:
    """[T, H, S]: the sum of ``v`` [T, H, S] over each slot's run (0 on
    padding), by the plain K6 and K7 with the heads as the feature axis."""
    T, H, S = v.shape
    per_node = segment_sum_tiles_ref(tiles, v.permute(0, 2, 1).contiguous())
    return segment_broadcast_tiles_ref(
        tiles, per_node.reshape(T, tiles.tile_nodes, H)).permute(0, 2, 1)


def segment_softmax_tiles_bwd_ref(tiles: SegTiles, y: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Plain version of K5's backward: ``y ⊙ (g − Σ_run y·g)`` for [T, H, S]
    outputs ``y`` and cotangents ``g`` (``_softmax_tiles_bwd`` in JAX)."""
    return y * (g - _run_sums_ref(tiles, y * g))


def segment_sum_tiles_ref(tiles: SegTiles, vals_t: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: [T, S, D] slot values → [T·TN, D] per-node
    sums (padding slots add nothing)."""
    T, S, D = vals_t.shape
    out = vals_t.new_zeros((T * (tiles.tile_nodes + 1), D))
    return _node_rows(tiles, out.index_add_(0, _slot_rows(tiles),
                                            vals_t.reshape(T * S, D)))


def segment_max_tiles_ref(tiles: SegTiles, vals_t: torch.Tensor) -> torch.Tensor:
    """[T, S] slot values → [T·TN] per-node max (−inf where a node has no
    slot)."""
    out = vals_t.new_full((vals_t.shape[0] * (tiles.tile_nodes + 1),), float("-inf"))
    return _node_rows(tiles, out.scatter_reduce(0, _slot_rows(tiles),
                                                vals_t.reshape(-1), "amax"))


def segment_broadcast_tiles_ref(tiles: SegTiles, node_vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: [T, TN, D] node values → [T, S, D] slot values
    (each slot reads its node's row; padding slots → 0)."""
    T, TN, D = node_vals.shape
    ext = torch.cat([node_vals, node_vals.new_zeros((T, 1, D))], dim=1)
    return ext.reshape(T * (TN + 1), D)[_slot_rows(tiles)].reshape(T, tiles.slots, D)


_RUNS = WeakIdKeyDictionary()   # local_dst tensor → (starts, order, mean run)


def _runs_entry(tiles: SegTiles):
    """The layout's cached (starts, order, mean run), computed at its first
    call (``layout_runs``)."""
    lid = tiles.local_dst
    hit = _RUNS.get(lid)
    if hit is not None:
        return hit
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    key = torch.where((lid >= 0) & (lid < TN), lid, TN).long()
    counts = torch.zeros((T, TN + 1), dtype=torch.long, device=lid.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    starts = torch.zeros((T, TN + 1), dtype=torch.int32, device=lid.device)
    starts[:, 1:] = counts[:, :TN].cumsum(1)
    in_runs = S < 2 or bool((key[:, 1:] >= key[:, :-1]).all())
    order = None if in_runs else \
        torch.sort(key, dim=1, stable=True).indices.to(torch.int32).contiguous()
    nodes = int((counts[:, :TN] > 0).sum())
    hit = _RUNS[lid] = (starts, order, int(starts[:, TN].sum()) / max(nodes, 1))
    return hit


def layout_runs(tiles: SegTiles):
    """Where each node's run of slots starts, per tile: ``starts`` int32
    [T, TN + 1], node v's slots at positions ``starts[t, v]`` to
    ``starts[t, v + 1] − 1`` and ``starts[t, TN]`` real slots in the tile.
    ``order`` is None when every node's slots are already adjacent, padding
    (local_dst outside [0, TN)) last; else int32 [T, S], the slot within
    the tile at each position (a stable sort by node, padding last).
    Computed once per layout (the local_dst tensor) and cached.  K1, K2
    (``ops.gat_fused``), K5 and K6 read it."""
    return _runs_entry(tiles)[:2]


def _mean_run(tiles: SegTiles) -> float:
    """Mean slots per node that has slots (cached with ``layout_runs``)."""
    return _runs_entry(tiles)[2]


_SLOT_LANES = 8         # K5, K6: most slot lanes a node gets


def _pow2(x) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _slot_lanes(mean_run: float) -> int:
    """Slot lanes a node gets in K6, and a (node, head) in K5 forward and
    backward: a power of two at or above the mean run / 2.4, so a lane
    takes two or three slots of a typical run, at most 8.  They set the
    order of K5's sums."""
    return min(_pow2(-(-mean_run // 2.4)), _SLOT_LANES)


def _sum_lanes(q: int, mean_run: float) -> tuple[int, int]:
    """K6's lanes per node for rows of ``q`` chunks: slot lanes R
    (``_slot_lanes``) and chunk lanes P (a power of two at or above q, at
    most 32 / R; a lane takes chunks p, p + P, ... where q > P).  R alone
    sets the order of the sums, so it does not depend on the row's width or
    alignment."""
    R = _slot_lanes(mean_run)
    return min(_pow2(q), 32 // R), R


def _check_tiles(tiles: SegTiles, x: torch.Tensor, shape, what: str):
    """The kernels take contiguous float32 values of ``shape`` and the
    layout's int32 local_dst on their device (K5 and K6 read its run starts
    and slot order, ``layout_runs``, derived from it)."""
    lid = tiles.local_dst
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous() \
            or tuple(x.shape) != shape:
        raise ValueError(f"{what}: expected a contiguous float32 CUDA tensor of shape "
                         f"{shape}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if lid.device != x.device or lid.dtype != torch.int32 or not lid.is_contiguous() \
            or tuple(lid.shape) != (tiles.tiles, tiles.slots) or tiles.tile_nodes > 4096:
        raise ValueError(f"{what}: the layout's local_dst must be a contiguous int32 "
                         f"[T, S] tensor on {x.device}, with TN <= 4096")


_TILE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SOFTMAX_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SOFTMAX_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SUM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _runs_args(tiles: SegTiles):
    """(starts, order or None, mean run) as the kernels take them."""
    starts, order, mean_run = _runs_entry(tiles)
    return starts.data_ptr(), None if order is None else order.data_ptr(), mean_run


def _softmax_fwd(tiles: SegTiles, scores_t: torch.Tensor) -> torch.Tensor:
    """K5 on CUDA tensors ([T, H, S]), its plain version on CPU tensors.
    The kernel walks each node's run, through the layout's run starts and
    slot order, with ``_slot_lanes`` lanes per (node, head)."""
    if scores_t.device.type == "cpu":
        return segment_softmax_tiles_ref(tiles, scores_t)
    T, H, S = scores_t.shape
    _check_tiles(tiles, scores_t, (tiles.tiles, H, tiles.slots), "segment_softmax_tiles")
    starts, order, mean_run = _runs_args(tiles)
    out = torch.empty_like(scores_t)
    _build.check(_seg_fn("segment_softmax_tiles_fwd", _SOFTMAX_ARGTYPES)(
        starts, order, scores_t.data_ptr(), out.data_ptr(), T, S, H, tiles.tile_nodes,
        _slot_lanes(mean_run), _stream(scores_t)), "segment_softmax_tiles")
    segment_softmax_tiles_mh.launches += 1
    return out


def segment_softmax_tiles_bwd(tiles: SegTiles, y: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """K5's backward, ``y ⊙ (g − Σ_run y·g)`` per node and head ([T, H, S]
    outputs ``y`` and cotangents ``g``; 0 on padding slots): one kernel
    over the runs with K5's lanes on CUDA tensors (strided inputs are
    copied contiguous first), ``segment_softmax_tiles_bwd_ref`` on CPU
    tensors."""
    if y.device.type == "cpu":
        return segment_softmax_tiles_bwd_ref(tiles, y, g)
    y, g = y.contiguous(), g.contiguous()
    T, H, S = y.shape
    for x, nm in ((y, "y"), (g, "g")):
        _check_tiles(tiles, x, (tiles.tiles, H, tiles.slots),
                     f"segment_softmax_tiles_bwd ({nm})")
    starts, order, mean_run = _runs_args(tiles)
    dx = torch.empty_like(y)
    _build.check(_seg_fn("segment_softmax_tiles_bwd", _SOFTMAX_BWD_ARGTYPES)(
        starts, order, y.data_ptr(), g.data_ptr(), dx.data_ptr(), T, S, H,
        tiles.tile_nodes, _slot_lanes(mean_run), _stream(y)),
        "segment_softmax_tiles_bwd")
    segment_softmax_tiles_bwd.launches += 1
    return dx


def _sum_fwd(tiles: SegTiles, vals_t: torch.Tensor) -> torch.Tensor:
    """K6 ([T, S, D] → [T, TN, D]) on CUDA tensors, its plain version on
    CPU tensors.  The kernel walks each node's run from the layout's run
    starts (and slot order, where the slots are not in runs) with
    ``_sum_lanes`` lanes a node; 16-byte chunks where D % 4 == 0 and both
    pointers allow it."""
    T, S, D = vals_t.shape
    if vals_t.device.type == "cpu":
        return segment_sum_tiles_ref(tiles, vals_t).reshape(T, tiles.tile_nodes, D)
    _check_tiles(tiles, vals_t, (tiles.tiles, tiles.slots, D), "segment_sum_tiles")
    starts, order, mean_run = _runs_args(tiles)
    out = torch.empty((T, tiles.tile_nodes, D), dtype=vals_t.dtype, device=vals_t.device)
    vec = D % 4 == 0 and vals_t.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    P, R = _sum_lanes(D // 4 if vec else D, mean_run)
    _build.check(_seg_fn("segment_sum_tiles_fwd", _SUM_ARGTYPES)(
        starts, order, vals_t.data_ptr(), out.data_ptr(), T, S, D, tiles.tile_nodes,
        int(vec), P, R, _stream(vals_t)), "segment_sum_tiles")
    segment_sum_tiles.launches += 1
    return out


def _broadcast_fwd(tiles: SegTiles, node_vals: torch.Tensor) -> torch.Tensor:
    """K7 ([T, TN, D] → [T, S, D]) on CUDA tensors, its plain version on
    CPU tensors."""
    if node_vals.device.type == "cpu":
        return segment_broadcast_tiles_ref(tiles, node_vals)
    T, TN, D = node_vals.shape
    _check_tiles(tiles, node_vals, (tiles.tiles, tiles.tile_nodes, D),
                 "segment_broadcast_tiles")
    out = torch.empty((T, tiles.slots, D), dtype=node_vals.dtype, device=node_vals.device)
    _build.check(_seg_fn("segment_broadcast_tiles_fwd", _TILE_ARGTYPES)(
        tiles.local_dst.data_ptr(), node_vals.data_ptr(), out.data_ptr(), T,
        tiles.slots, D, TN, _stream(node_vals)), "segment_broadcast_tiles")
    segment_broadcast_tiles.launches += 1
    return out


class _SoftmaxTiles(torch.autograd.Function):
    """K5 forward; its backward ``y ⊙ (g − Σ_run y·g)`` in one kernel over
    the runs (``_softmax_tiles_bwd`` in JAX, there a K6 and a K7 with the
    heads as the feature axis)."""

    @staticmethod
    def forward(ctx, scores_t, tiles):
        y = _softmax_fwd(tiles, scores_t)
        ctx.save_for_backward(y)
        ctx.tiles = tiles
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return segment_softmax_tiles_bwd(ctx.tiles, y, g), None


class _SumTiles(torch.autograd.Function):
    """K6 forward, K7 backward (the two are each other's transpose)."""

    @staticmethod
    def forward(ctx, vals_t, tiles):
        ctx.tiles = tiles
        return _sum_fwd(tiles, vals_t)

    @staticmethod
    def backward(ctx, g):
        return _broadcast_fwd(ctx.tiles, g.contiguous()), None


class _BroadcastTiles(torch.autograd.Function):
    """K7 forward, K6 backward."""

    @staticmethod
    def forward(ctx, node_vals, tiles):
        ctx.tiles = tiles
        return _broadcast_fwd(tiles, node_vals)

    @staticmethod
    def backward(ctx, g):
        return _sum_fwd(ctx.tiles, g.contiguous()), None


def segment_softmax_tiles_mh(tiles: SegTiles, scores_t: torch.Tensor) -> torch.Tensor:
    """Multi-head segment softmax [T, H, S] → [T, H, S] (padding → 0):
    K5 on CUDA tensors, differentiable (backward ``segment_softmax_tiles_bwd``)."""
    return _SoftmaxTiles.apply(scores_t.contiguous(), tiles)


def segment_softmax_tiles(tiles: SegTiles, scores_t: torch.Tensor) -> torch.Tensor:
    """Segment softmax over the tile layout: [T, S] → [T, S]."""
    return segment_softmax_tiles_mh(tiles, scores_t[:, None, :])[:, 0, :]


def segment_sum_tiles(tiles: SegTiles, vals_t: torch.Tensor) -> torch.Tensor:
    """Per-node sums [T, S, D] → [T·TN, D]: K6 on CUDA tensors,
    differentiable (backward K7)."""
    out = _SumTiles.apply(vals_t.contiguous(), tiles)
    return out.reshape(tiles.n_pad, vals_t.shape[-1])


def segment_broadcast_tiles(tiles: SegTiles, node_vals: torch.Tensor) -> torch.Tensor:
    """Node → slot broadcast [T, TN, D] → [T, S, D] (padding → 0), the
    gather ``vals[dst]`` of per-node values needed per edge: K7 on CUDA
    tensors, differentiable (backward K6)."""
    return _BroadcastTiles.apply(node_vals.contiguous(), tiles)


# ---------------------------------------------------------------------------
# Windowed source-row gather (K3) and its scatter-add transpose (K4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SrcWindows:
    """Static plan of the per-slot source-row gather ``vals[src_t]``.  Per
    tile a window of 2·``win`` rows starts at row ``blk[t]``·win;
    ``lsrc[t, s]`` = src − blk[t]·win for in-window slots and 2·win (a
    miss, gathered as 0) otherwise.  Out-of-window edges go to the outlier
    list ``(out_slot, out_src)``, written over the gathered rows
    (``out_slot`` = T·S marks padding entries)."""

    lsrc: torch.Tensor      # int32[T, S]
    blk: torch.Tensor       # int32[T]
    out_slot: torch.Tensor  # int32[O]
    out_src: torch.Tensor   # int32[O]
    win: int = 0
    rows_pad: int = 0

    @property
    def n_outliers(self) -> int:
        return int(self.out_slot.shape[0])

    def to(self, device) -> "SrcWindows":
        return dataclasses.replace(
            self, lsrc=self.lsrc.to(device), blk=self.blk.to(device),
            out_slot=self.out_slot.to(device), out_src=self.out_src.to(device))


def build_src_windows(tiles: SegTiles, src_ids, num_rows: int,
                      win: int | None = None, outlier_cap: float = 0.02,
                      device=None) -> SrcWindows:
    """Plan build.  ``src_ids``: int[T·S] global source row per slot.
    ``win`` is auto-picked as the smallest power of two ≥ 128 whose
    windows (centred on each tile's median source) leave at most
    ``outlier_cap`` of the real edges outside, capped at 8192."""
    device = resolve_device(device)
    src = to_numpy(src_ids).astype(np.int64).reshape(tiles.tiles, tiles.slots)
    real = to_numpy(tiles.local_dst) < tiles.tile_nodes
    T, S = src.shape
    med = np.zeros((T,), np.int64)
    for t in range(T):
        r = src[t][real[t]]
        med[t] = np.int64(np.median(r)) if r.size else 0

    def plan(w):
        blk = np.clip(med - w, 0, None) // w
        lsrc = src - (blk * w)[:, None]
        inwin = (lsrc >= 0) & (lsrc < 2 * w) & real
        return blk, lsrc, inwin

    total_real = max(int(real.sum()), 1)
    if win is None:
        win = 128
        while win < 8192:
            _, _, inwin = plan(win)
            if (total_real - int(inwin.sum())) / total_real <= outlier_cap:
                break
            win *= 2
    blk, lsrc, inwin = plan(win)
    miss = real & ~inwin
    o_t, o_s = np.nonzero(miss)
    out_slot = o_t * S + o_s
    out_src = src[miss]
    o_pad = _round_up(max(len(out_slot), 1), _LANE)
    out_slot = np.pad(out_slot, (0, o_pad - len(out_slot)), constant_values=T * S)
    out_src = np.pad(out_src, (0, o_pad - len(out_src)))
    lsrc = np.where(inwin, lsrc, 2 * win)
    rows_pad = (_round_up(max(num_rows, 1), win) // win + 1) * win
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)
    return SrcWindows(lsrc=as_t(lsrc), blk=as_t(blk), out_slot=as_t(out_slot),
                      out_src=as_t(out_src), win=int(win), rows_pad=int(rows_pad))


def gather_rows_windows_ref(plan: SrcWindows, tiles: SegTiles,
                            vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: [T·S, D] slot rows.  In-window slots read
    ``vals[blk·win + lsrc]`` (rows ≥ n read 0, as the zero padding to
    ``rows_pad`` makes them), misses and padding give 0, then the outlier
    list is written over them."""
    n = vals.shape[0]
    lsrc = plan.lsrc.long()
    row = plan.blk.long()[:, None] * plan.win + lsrc
    ok = ((lsrc >= 0) & (lsrc < 2 * plan.win) & (row < n)).reshape(-1)
    got = torch.where(ok[:, None], vals[torch.where(ok, row.reshape(-1), 0)], 0.0)
    n_slots = got.shape[0]
    slot, src = plan.out_slot.long(), plan.out_src.long()
    fix = (slot >= 0) & (slot < n_slots)
    src_ok = ((src >= 0) & (src < n))[:, None]
    got[slot[fix]] = torch.where(src_ok, vals[torch.where(src_ok[:, 0], src, 0)],
                                 0.0)[fix]
    return got


def effective_rows(plan: SrcWindows, n: int) -> torch.Tensor:
    """int64[T·S] source row that each slot reads through the plan: the
    window row for in-window slots below ``n``, ``out_src`` for outlier
    slots, and ``n`` (a dropped row) for misses and padding."""
    lsrc = plan.lsrc.long()
    row = plan.blk.long()[:, None] * plan.win + lsrc
    ok = (lsrc >= 0) & (lsrc < 2 * plan.win) & (row < n)
    row = torch.where(ok, row, n).reshape(-1)
    slot, src = plan.out_slot.long(), plan.out_src.long()
    fix = (slot >= 0) & (slot < row.numel())
    row[slot[fix]] = torch.where((src >= 0) & (src < n), src, n)[fix]
    return row


def scatter_rows_windows_ref(plan: SrcWindows, g: torch.Tensor,
                             n: int) -> torch.Tensor:
    """Plain version of K4, the transpose of ``gather_rows_windows``:
    ``dv[r] = Σ_{slots s reading row r} g[s]`` → [n, D], one
    ``index_add_`` over the plan's effective rows."""
    return scatter_rows_buckets_ref((plan,), (g,), n)


def gather_rows_buckets_ref(plans, vals: torch.Tensor) -> list:
    """Plain version of the all-bucket K3: ``gather_rows_windows_ref`` of
    each bucket's plan."""
    return [gather_rows_windows_ref(p, None, vals) for p in plans]


def scatter_rows_buckets_ref(plans, gs, n: int) -> torch.Tensor:
    """Plain version of the all-bucket K4: the buckets' slot cotangents
    (None for zeros) as one ``index_add_`` onto [n, D] over their effective
    rows laid end to end; on the CPU it adds each row's slots in slot
    order."""
    ref = next(g for g in gs if g is not None)
    D = ref.shape[-1]
    rows = torch.cat([effective_rows(p, n) for p in plans])
    g = torch.cat([ref.new_zeros((p.lsrc.numel(), D)) if g is None else g
                   for p, g in zip(plans, gs)])
    return ref.new_zeros((n + 1, D)).index_add_(0, rows, g)[:n]


_MAX_BUCKETS = 8        # kMaxBuckets in csrc/segment.cu
_HUB_SLOTS = 32         # kHubSlots: rows read by more slots are summed by a warp


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """The slots of one or more window plans laid end to end (plan b's from
    ``offsets[b]``) and the source rows they read.  ``rows``: int32
    [offsets[-1]], each slot's effective source row (``n``: none);
    ``row_ptr``: int32[n + 1], row r's slots are ``slots[row_ptr[r]:
    row_ptr[r + 1]]``, ascending; ``hubs``: int32, the rows read by more
    than ``_HUB_SLOTS`` slots."""

    offsets: tuple
    rows: torch.Tensor
    row_ptr: torch.Tensor
    slots: torch.Tensor
    hubs: torch.Tensor
    n: int


_ROW_PLANS = WeakIdKeyDictionary()   # plans[0].lsrc → [(lsrc weakrefs, n, RowPlan)]


def row_plan(plans, n: int) -> RowPlan:
    """The ``RowPlan`` of ``plans`` (one ``SrcWindows`` per bucket) over
    ``n`` source rows, on the plans' device.  Derived once per layout (the
    plans' lsrc tensors) and ``n``, then cached; K3 and K4 derive it at
    their first call, so a CUDA graph that captures them finds it built."""
    entries = _ROW_PLANS.setdefault(plans[0].lsrc, [])
    for refs, m, rp in entries:
        if m == n and len(refs) == len(plans) \
                and all(r() is p.lsrc for r, p in zip(refs, plans)):
            return rp
    rows = torch.cat([effective_rows(p, n) for p in plans])
    counts = torch.bincount(rows, minlength=n + 1)[:n]
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    row_ptr[1:] = counts.cumsum(0)
    order = torch.sort(rows, stable=True).indices        # by row, then slot
    i32 = lambda x: x.to(torch.int32).contiguous()
    rp = RowPlan(offsets=tuple(int(x) for x in np.cumsum(
                     [0] + [p.lsrc.numel() for p in plans])),
                 rows=i32(rows), row_ptr=i32(row_ptr),
                 slots=i32(order[:int(row_ptr[n])]),
                 hubs=i32(torch.nonzero(counts > _HUB_SLOTS).reshape(-1)), n=n)
    entries.append((tuple(weakref.ref(p.lsrc) for p in plans), n, rp))
    return rp


def _check_rows(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous float32 [rows, D] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def _cuda_row_plan(plans, n: int, D: int, device, what: str) -> RowPlan:
    """The plans' ``RowPlan`` after the checks K3 and K4 share."""
    if not 1 <= len(plans) <= _MAX_BUCKETS:
        raise ValueError(f"{what}: {len(plans)} buckets; the kernel takes 1 to "
                         f"{_MAX_BUCKETS}")
    if any(p.lsrc.device != device for p in plans):
        raise ValueError(f"{what}: the window plans must be on {device}")
    rp = row_plan(plans, n)
    if rp.offsets[-1] * D >= 2**31 or n * D >= 2**31:
        raise ValueError(f"{what}: {rp.offsets[-1]} slots or {n} rows of width "
                         f"{D} do not fit the kernel's int32 indices")
    return rp


_P, _INTS = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_GATHER_ARGTYPES = [_P, _P, _PTRS, _INTS] + [ctypes.c_int] * 3 + [_P]
_SCATTER_ARGTYPES = [_P, _P, _P, _PTRS, _INTS] + [ctypes.c_int] * 4 + [_P, _P]
_FNS: dict = {}


def _seg_fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("segment"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return fn


def _table(rp: RowPlan, ptrs):
    """The kernel's per-bucket table: row pointers (0 for zeros) and slot
    offsets."""
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(rp.offsets))(*rp.offsets))


def _gather_fwd(plans, vals: torch.Tensor) -> list:
    """K3 over every bucket in one launch on CUDA tensors, the plain
    versions on CPU tensors."""
    if vals.device.type == "cpu":
        return gather_rows_buckets_ref(plans, vals)
    _check_rows(vals, "gather_rows_buckets")
    n, D = vals.shape
    rp = _cuda_row_plan(plans, n, D, vals.device, "gather_rows_buckets")
    outs = [torch.empty((p.lsrc.numel(), D), dtype=vals.dtype, device=vals.device)
            for p in plans]
    ptrs, offs = _table(rp, [o.data_ptr() for o in outs])
    _build.check(_seg_fn("gather_rows_buckets_fwd", _GATHER_ARGTYPES)(
        rp.rows.data_ptr(), vals.data_ptr(), ptrs, offs, len(plans), D, n,
        torch.cuda.current_stream(vals.device).cuda_stream), "gather_rows_buckets")
    gather_rows_windows.launches += 1
    return outs


def scatter_rows_buckets(plans, gs, n: int):
    """K4 over every bucket: the buckets' [T_b·S_b, D] slot cotangents
    ``gs`` (None for zeros) scattered onto [n, D] source rows, the outlier
    fixup included, in one launch of ``csrc/segment.cu`` on CUDA tensors;
    ``scatter_rows_buckets_ref`` on CPU tensors.  None where every
    cotangent is None."""
    live = [g for g in gs if g is not None]
    if not live:
        return None
    if live[0].device.type == "cpu":
        return scatter_rows_buckets_ref(plans, gs, n)
    D = live[0].shape[1]
    rp = _cuda_row_plan(plans, n, D, live[0].device, "scatter_rows_buckets")
    for p, g in zip(plans, gs):
        if g is not None:
            _check_rows(g, "scatter_rows_buckets")
            if g.device != live[0].device or tuple(g.shape) != (p.lsrc.numel(), D):
                raise ValueError(f"scatter_rows_buckets: g {tuple(g.shape)} on "
                                 f"{g.device} does not fit its plan's "
                                 f"{p.lsrc.numel()} slots of width {D}")
    dv = torch.empty((n, D), dtype=live[0].dtype, device=live[0].device)
    ptrs, offs = _table(rp, [0 if g is None else g.data_ptr() for g in gs])
    _build.check(_seg_fn("scatter_rows_buckets_bwd", _SCATTER_ARGTYPES)(
        rp.row_ptr.data_ptr(), rp.slots.data_ptr(), rp.hubs.data_ptr(), ptrs, offs,
        len(plans), D, n, rp.hubs.numel(), dv.data_ptr(),
        torch.cuda.current_stream(dv.device).cuda_stream), "scatter_rows_buckets")
    scatter_rows_windows.launches += 1
    return dv


def scatter_rows_windows(plan: SrcWindows, g: torch.Tensor, n: int) -> torch.Tensor:
    """K4 on one layout: the windowed scatter-add of [T·S, D] slot
    cotangents ``g`` onto [n, D] source rows (``scatter_rows_buckets`` with
    one bucket)."""
    return scatter_rows_buckets((plan,), (g,), n)


class _GatherRowsBuckets(torch.autograd.Function):
    """K3 forward over every bucket, K4 backward (``_gather_rows_p`` and
    its VJP in JAX, there once per bucket); one output per bucket."""

    @staticmethod
    def forward(ctx, vals, plans):
        ctx.plans, ctx.n = plans, vals.shape[0]
        ctx.set_materialize_grads(False)
        return tuple(_gather_fwd(plans, vals))

    @staticmethod
    def backward(ctx, *gs):
        gs = tuple(None if g is None else g.contiguous() for g in gs)
        return scatter_rows_buckets(ctx.plans, gs, ctx.n), None


def gather_rows_buckets(plans, vals: torch.Tensor) -> tuple:
    """``vals[src_t]`` of every bucket of a layer: one [T_b·S_b, D] slot-row
    tensor per bucket's window plan in ``plans`` (at most 8), each equal to
    ``gather_rows_windows`` of that bucket.  One K3 launch on CUDA tensors,
    and one K4 launch for the gradient in ``vals``; the plain versions on
    CPU tensors."""
    return _GatherRowsBuckets.apply(vals, tuple(plans))


def gather_rows_windows(plan: SrcWindows, tiles: SegTiles, src_t,
                        vals: torch.Tensor) -> torch.Tensor:
    """``vals[src_t]`` as [T·S, D] slot rows through the window plan (same
    signature and result as the JAX function with ``interpret=True``):
    ``gather_rows_buckets`` with one bucket, differentiable in ``vals``.
    ``src_t`` and ``tiles`` are the JAX signature's; the plan carries the
    rows."""
    del tiles, src_t
    return gather_rows_buckets((plan,), vals)[0]


gather_rows_windows.launches = 0
scatter_rows_windows.launches = 0
segment_softmax_tiles_mh.launches = 0
segment_softmax_tiles_bwd.launches = 0
segment_sum_tiles.launches = 0
segment_broadcast_tiles.launches = 0

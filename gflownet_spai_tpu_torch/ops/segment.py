"""Node-tile layouts of the GAT's segment structure and the windowed
source-row gather K3 (counterpart of ``gflownet_spai_tpu/ops/segment.py``:
the layout builders :41-186, ``SrcWindows`` :511-609 and
``gather_rows_windows`` :612-655, :734-789).

The layouts are built once on the host (numpy): edges grouped by
destination node into tiles of ``TN`` consecutive nodes × ``S`` slots
(padded), optionally bucketed by slot width.  The fused GAT kernel
(``ops.gat_fused``) consumes them.  The layer-2 source-row gather runs as
the CUDA kernel ``csrc/segment.cu`` on CUDA tensors; on CPU tensors
``gather_rows_windows`` computes its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

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
    ``local_dst``: int32[T, S], destination node within the tile (0..TN−1;
    TN for padding slots).  The slots of each tile are sorted by
    ``local_dst``, padding last."""

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


# ---------------------------------------------------------------------------
# Windowed source-row gather (K3)
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


_GATHER_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _gather_lib():
    lib = _build.load("segment")
    fn = lib.gather_rows_windows_fwd
    fn.argtypes, fn.restype = _GATHER_ARGTYPES, ctypes.c_int
    return fn


def gather_rows_windows(plan: SrcWindows, tiles: SegTiles, src_t,
                        vals: torch.Tensor) -> torch.Tensor:
    """``vals[src_t]`` as [T·S, D] slot rows through the window plan (same
    signature and result as the JAX function with ``interpret=True``).
    CUDA tensors launch K3 (``csrc/segment.cu``); CPU tensors take
    ``gather_rows_windows_ref``.  ``src_t`` is carried for the backward
    pass, which comes with the training slice."""
    if vals.device.type == "cpu":
        return gather_rows_windows_ref(plan, tiles, vals)
    if vals.device.type != "cuda":
        raise ValueError(f"gather_rows_windows: unsupported device {vals.device}")
    if vals.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "gather_rows_windows on CUDA is forward only: its backward (the "
            "windowed scatter K4) lands with the training slice")
    if vals.dtype != torch.float32 or vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("gather_rows_windows: vals must be a contiguous "
                         f"float32 [n, D] tensor, got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    T, S = plan.lsrc.shape
    n, D = vals.shape
    idx = (plan.lsrc, plan.blk, plan.out_slot, plan.out_src)
    for a in idx:
        if a.device != vals.device or a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError("gather_rows_windows: plan arrays must be "
                             "contiguous int32 tensors on the device of vals")
    if plan.blk.shape != (T,) or T * S * D >= 2**31:
        raise ValueError("gather_rows_windows: plan shapes do not fit the kernel")
    out = torch.empty((T * S, D), dtype=vals.dtype, device=vals.device)
    fn = _gather_lib()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    _build.check(fn(*(a.data_ptr() for a in idx), vals.data_ptr(), out.data_ptr(),
                    T, S, D, plan.win, n, plan.out_slot.shape[0], stream),
                 "gather_rows_windows")
    gather_rows_windows.launches += 1
    return out


gather_rows_windows.launches = 0

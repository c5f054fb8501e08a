"""Tile layouts and the CUDA kernels of the sampling path: the fused GATv2
tile forward (K1, ``gat_fused``) and the windowed row gather (K3,
``segment``); plus the band statistics and the suffix log-sum-exp."""

from .gat_fused import gat_tile_fused, gat_tile_fused_ref
from .rcm import bandwidth, n_diagonals
from .scan import suffix_logsumexp
from .segment import (SegBuckets, SegTiles, SrcWindows, build_seg_buckets,
                      build_seg_tiles, build_src_windows, gather_rows_windows,
                      gather_rows_windows_ref, to_tiles)

__all__ = [
    "gat_tile_fused", "gat_tile_fused_ref", "bandwidth", "n_diagonals",
    "suffix_logsumexp", "SegBuckets", "SegTiles", "SrcWindows",
    "build_seg_buckets", "build_seg_tiles", "build_src_windows",
    "gather_rows_windows", "gather_rows_windows_ref", "to_tiles",
]
